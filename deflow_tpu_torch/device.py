"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU.  A
missing card is an error, never a quiet fall back to the CPU: a number taken
on the CPU must not pass for a device number.  Under a process group each
rank takes its own card, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from deflow_tpu_torch import dist


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device (under a process
    group: ``cuda:LOCAL_RANK``); ``"cpu"`` → the CPU.

    Raises ``RuntimeError`` when a CUDA device is wanted and none is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", dist.local_rank() if dist.is_initialized()
                               else torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
