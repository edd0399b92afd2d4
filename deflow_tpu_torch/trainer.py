"""Eval step of the port (training arrives with a later slice).

Counterpart of ``deflow_tpu/trainer.py`` ``make_eval_step`` and
``device_batch``: the final predicted flow is the rigid ego flow everywhere
plus the network flow at voxel-valid points.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from deflow_tpu_torch.data.host_prep import HOST_PREP_KEYS, host_prep_from_batch
from deflow_tpu_torch.device import resolve_device

# the host-batch keys the model reads
MODEL_KEYS = ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask",
              "ego_motion") + HOST_PREP_KEYS


def device_batch(batch: Dict, device=None) -> Dict[str, torch.Tensor]:
    """Move the model's keys of a host batch onto ``device`` (the card
    unless ``"cpu"``)."""
    dev = resolve_device(device)
    out = {}
    for k in MODEL_KEYS:
        if k in batch:
            v = batch[k]
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = v.to(dev)
    return out


def make_eval_step(model: torch.nn.Module, device=None) -> Callable:
    """``eval_step(host_or_device_batch) -> dict`` on ``device`` (the card
    unless ``"cpu"``).  Outputs stay in the batch's sorted point order."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        b = device_batch(batch, dev)
        out = model(b["pc0"], b["pc1"], b["pose0"], b["pose1"],
                    b["pc0_mask"], b["pc1_mask"],
                    ego_motion=b.get("ego_motion"),
                    host_prep=host_prep_from_batch(b))
        total = out["pose_flow"] + torch.where(
            out["pc0_valid"][..., None], out["flow"], 0.0)
        return {"pred_flow": total, "net_flow": out["flow"],
                "pose_flow": out["pose_flow"], "pc0_valid": out["pc0_valid"]}

    return eval_step
