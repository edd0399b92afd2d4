"""Scene-flow losses: deflowLoss / ff3dLoss / zeroflowLoss and the SeFlow
self-supervised seflowLoss.

Counterpart of ``deflow_tpu/losses.py``.  The supervised losses take the
NETWORK flow: the target is the total ground-truth flow minus the rigid ego
``pose_flow``.  ``seflow_loss`` takes the model's output dict and the batch
(see its docstring).

Inputs (all [B, N, ...]):
    pred:    [B, N, 3] network flow
    gt:      [B, N, 3] target (total gt flow − pose_flow)
    mask:    [B, N] bool, points that are real, in range and have valid gt
    classes: [B, N] int AV2 category index (0 = background), ff3dLoss only

Under a process group every loss is this rank's SHARE of the global loss:
the means divide by counts summed over ranks (a bucket may be empty on one
rank and not on another), so the shares add up to the loss of the global
batch, and the step sums the gradients over ranks.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional

import torch

from deflow_tpu_torch import dist
from deflow_tpu_torch.ops import chamfer as _chamfer

_SWEEP_DT = 0.1  # AV2 lidar sweep interval (s): flow [m] / 0.1 s = speed [m/s]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of x over the mask of the global batch
    (the local sum over the global count); an exact 0 when the global mask
    is empty."""
    s = torch.where(mask, x, 0.0).sum()
    n = dist.all_reduce_(mask.sum())
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


# ------------------------------------------------------------------ SSL losses
def _rows_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Per-sample masked mean: [B, N] × [B, N] → [B]; 0 for an empty mask."""
    s = torch.where(m, x, 0.0).sum(-1)
    n = m.sum(-1)
    return torch.where(n > 0, s / n.clamp(min=1), 0.0)


def _samples_mean(terms: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over the global batch's samples (every
    rank holds as many samples: the train entry requires it)."""
    return terms.sum() / (terms.numel() * dist.world())


def seflow_loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                truncate: float = 2.0, chamfer_method: str = "auto",
                dyn_cap: Optional[int] = None) -> torch.Tensor:
    """SeFlow self-supervised loss (arXiv:2407.01702 §IV), needing no gt flow:
    the mean over samples of
      1. the truncated chamfer between pc0 warped by the total flow
         (pose_flow + flow) and pc1, both directions;
      2. with DUFO labels, the mean squared net flow of DUFO-static pc0
         points;
      3. with both clouds' DUFO labels, the truncated chamfer within the
         dynamic subsets.
    On the grid branch (``chamfer_method`` "grid", or "auto" with N·M >
    2^28) terms 1 and 3 come from one fused sweep per direction, with pc1's
    cell sort taken from the batch's ``pc1_cell_*`` keys when their geometry
    matches the loss's grid; otherwise the brute search runs twice.

    Under a process group the chamfer stays on each rank's own samples,
    with no collective inside (the JAX package's ``shard_map`` branch), and
    the sum of the sample terms is divided by the global sample count: this
    rank's share of the mean.

    ``dyn_cap`` (the grid branch): the row budget of the dynamic terms'
    backward (``NNSpec.dyn_cap``); None reads ``DEFLOW_SSL_DYNCAP``, where
    0 means no compaction, and without it there is none.  Dynamic points
    past the budget lose their dynamic-chamfer gradient; the loss does not
    change."""
    net = out["flow"]
    total = out["pose_flow"] + net
    pc0, pc1 = batch["pc0"], batch["pc1"]
    m0 = out["pc0_valid"] & batch["pc0_mask"]
    m1 = out["pc1_valid"] & batch["pc1_mask"]
    dufo0, dufo1 = batch.get("dufo_label0"), batch.get("dufo_label1")
    warped = pc0 + total
    t2 = truncate * truncate
    n, m = warped.shape[-2], pc1.shape[-2]
    use_grid = (chamfer_method == "grid"
                or (chamfer_method == "auto" and n * m > _chamfer._AUTO_GRID_PAIRS))
    if dufo0 is not None and dufo1 is not None and use_grid:
        env_cap = os.environ.get("DEFLOW_SSL_DYNCAP")
        if dyn_cap is None and env_cap is not None:
            dyn_cap = int(env_cap) or n
        spec = _chamfer._resolve_spec("grid", n, m, truncate, None)
        if dyn_cap is not None:
            spec = spec._replace(dyn_cap=int(dyn_cap))
        dyn0 = m0 & (dufo0 > 0)
        dyn1 = m1 & (dufo1 > 0)
        host_c1 = None
        if "pc1_cell_lanes" in batch:
            gx, gy = _chamfer._grid_dims(spec)
            if batch["pc1_cell_start"].shape[-1] == (gy + 1) * gx + 1:
                host_c1 = (batch["pc1_cell_lanes"], batch["pc1_cell_sid"],
                           batch["pc1_cell_start"])
            else:
                # Python's default filter shows this once per call site
                warnings.warn(
                    f"seflow_loss: the batch's pc1 cell prep has "
                    f"{batch['pc1_cell_start'].shape[-1] - 1} cells, the loss's "
                    f"grid {(gy + 1) * gx}; sorting pc1 on the device instead",
                    stacklevel=2)
        d0, d1, dd0, dd1 = _chamfer.ssl_chamfer_distances(
            warped, pc1, m0, m1, dyn0, dyn1, truncate=truncate, spec=spec,
            host_c1=host_c1)
        terms = (_rows_mean(d0.clamp(max=t2), m0) + _rows_mean(d1.clamp(max=t2), m1)
                 + _rows_mean(dd0.clamp(max=t2), dyn0)
                 + _rows_mean(dd1.clamp(max=t2), dyn1))
        static = m0 & (dufo0 == 0)
        terms = terms + _rows_mean((net ** 2).sum(-1), static)
        return _samples_mean(terms)

    d0, d1 = _chamfer.chamfer_distance(warped, pc1, m0, m1, method=chamfer_method,
                                       truncate=truncate)
    terms = _rows_mean(d0.clamp(max=t2), m0) + _rows_mean(d1.clamp(max=t2), m1)
    if dufo0 is not None:
        static = m0 & (dufo0 == 0)
        terms = terms + _rows_mean((net ** 2).sum(-1), static)
        if dufo1 is not None:
            dyn0 = m0 & (dufo0 > 0)
            dyn1 = m1 & (dufo1 > 0)
            dd0, dd1 = _chamfer.chamfer_distance(warped, pc1, dyn0, dyn1,
                                                 method=chamfer_method,
                                                 truncate=truncate)
            terms = terms + (_rows_mean(dd0.clamp(max=t2), dyn0)
                             + _rows_mean(dd1.clamp(max=t2), dyn1))
    return _samples_mean(terms)


SSL_LOSS_REGISTRY: Dict[str, Callable] = {
    "seflowLoss": seflow_loss,
}
