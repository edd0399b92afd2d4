"""Supervised scene-flow losses: deflowLoss / ff3dLoss / zeroflowLoss.

Counterpart of ``deflow_tpu/losses.py`` (the supervised part).  All losses
take the NETWORK flow: the target is the total ground-truth flow minus the
rigid ego ``pose_flow``.

Inputs (all [B, N, ...]):
    pred:    [B, N, 3] network flow
    gt:      [B, N, 3] target (total gt flow − pose_flow)
    mask:    [B, N] bool, points that are real, in range and have valid gt
    classes: [B, N] int AV2 category index (0 = background), ff3dLoss only
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

_SWEEP_DT = 0.1  # AV2 lidar sweep interval (s): flow [m] / 0.1 s = speed [m/s]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the mask; an exact 0 when the mask is empty."""
    s = torch.where(mask, x, 0.0).sum()
    n = mask.sum()
    return torch.where(n > 0, s / n.clamp(min=1), 0.0)


def _epe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pred - gt, dim=-1)


def deflow_loss(pred, gt, mask, classes: Optional[torch.Tensor] = None):
    """Sum of the mean L2 error in three speed buckets: < 0.4, [0.4, 1.0]
    and > 1.0 m/s (DeFlow §III-D); an empty bucket adds 0."""
    err = _epe(pred, gt)
    speed = torch.linalg.vector_norm(gt, dim=-1) / _SWEEP_DT
    slow = mask & (speed < 0.4)
    mid = mask & (speed >= 0.4) & (speed <= 1.0)
    fast = mask & (speed > 1.0)
    return (_masked_mean(err, slow) + _masked_mean(err, mid)
            + _masked_mean(err, fast))


def ff3d_loss(pred, gt, mask, classes: Optional[torch.Tensor] = None):
    """Mean L2 error, background points weighted 0.1 (FastFlow3D)."""
    err = _epe(pred, gt)
    if classes is None:
        weight = torch.ones_like(err)
    else:
        weight = 0.1 + 0.9 * (classes > 0).to(err.dtype)
    return _masked_mean(err * weight, mask)


def zeroflow_loss(pred, gt, mask, classes: Optional[torch.Tensor] = None):
    """Mean L2 error scaled by clamp(speed, 0.1, 1.0) (ZeroFlow)."""
    err = _epe(pred, gt)
    speed = torch.linalg.vector_norm(gt, dim=-1) / _SWEEP_DT
    return _masked_mean(err * speed.clamp(0.1, 1.0), mask)


LOSS_REGISTRY: Dict[str, Callable] = {
    "deflowLoss": deflow_loss,
    "ff3dLoss": ff3d_loss,
    "zeroflowLoss": zeroflow_loss,
}


def get_loss(name: str) -> Callable:
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss_fn {name!r}; options: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name]
