"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU.  A
missing card is an error, never a quiet fall back to the CPU: a number taken
on the CPU must not pass for a device number.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device; ``"cpu"`` → the CPU.

    Raises ``RuntimeError`` when a CUDA device is wanted and none is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
