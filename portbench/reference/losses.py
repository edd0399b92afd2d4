"""Plain f32 scene-flow losses of the reference: deflowLoss (DeFlow §III-D:
the sum of the mean end-point error in the speed buckets < 0.4, [0.4,
1.0] and > 1.0 m/s, an empty bucket adding 0) and ff3dLoss (FastFlow3D:
the mean end-point error, background points weighted 0.1).  ``pred`` is
the network flow, ``gt`` the target (total flow − ego flow), ``mask`` the
points scored (valid and labelled).  And seflowLoss (SeFlow,
arXiv:2407.01702 §IV), self-supervised on DUFO labels."""

from __future__ import annotations

import torch

from portbench.reference.chamfer import nearest

SWEEP_S = 0.1       # AV2 lidar sweep interval: flow in m per sweep / 0.1 s = m/s


def _mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    n = m.sum()
    return torch.where(m, x, 0.0).sum() / n.clamp(min=1)


def deflow_loss(pred, gt, mask, classes):
    err = torch.linalg.vector_norm(pred - gt, dim=-1)
    speed = torch.linalg.vector_norm(gt, dim=-1) / SWEEP_S
    return (_mean(err, mask & (speed < 0.4))
            + _mean(err, mask & (speed >= 0.4) & (speed <= 1.0))
            + _mean(err, mask & (speed > 1.0)))


def ff3d_loss(pred, gt, mask, classes):
    err = torch.linalg.vector_norm(pred - gt, dim=-1)
    weight = torch.where(classes > 0, 1.0, 0.1)
    return _mean(err * weight, mask)


LOSSES = {"deflowLoss": deflow_loss, "ff3dLoss": ff3d_loss}


def supervised_loss(name: str, out, batch) -> torch.Tensor:
    """The loss of a forward's outputs against the batch's labels."""
    target = batch["flow"].float() - out["pose_flow"]
    mask = out["pc0_valid"] & batch["flow_is_valid"].bool()
    return LOSSES[name](out["flow"], target, mask, batch["flow_category_indices"])


def _rows_mean(x, m):
    return torch.where(m, x, 0.0).sum(-1) / m.sum(-1).clamp(min=1)


def seflow_loss(out, batch, truncate: float = 2.0) -> torch.Tensor:
    """The mean over samples of: the chamfer between pc0 warped by the total
    flow and pc1, both directions, each squared nearest distance truncated
    at ``truncate``²; the mean squared network flow of DUFO-static pc0
    points; the truncated chamfer within the two clouds' DUFO-dynamic
    points.  Each term is a mean over its sample's points (0 if none)."""
    pc0, pc1 = batch["pc0"].float(), batch["pc1"].float()
    warped = pc0 + out["pose_flow"] + out["flow"]
    m0 = out["pc0_valid"] & batch["pc0_mask"].bool()
    m1 = out["pc1_valid"] & batch["pc1_mask"].bool()
    dyn0 = m0 & (batch["dufo_label0"] > 0)
    dyn1 = m1 & (batch["dufo_label1"] > 0)
    static = m0 & (batch["dufo_label0"] == 0)
    t2 = truncate * truncate
    terms = []
    for b in range(pc0.shape[0]):
        d0 = nearest(warped[b], m0[b], pc1[b], m1[b]).clamp(max=t2)
        d1 = nearest(pc1[b], m1[b], warped[b], m0[b]).clamp(max=t2)
        dd0 = nearest(warped[b], dyn0[b], pc1[b], dyn1[b]).clamp(max=t2)
        dd1 = nearest(pc1[b], dyn1[b], warped[b], dyn0[b]).clamp(max=t2)
        terms.append(_rows_mean(d0, m0[b]) + _rows_mean(d1, m1[b])
                     + _rows_mean(dd0, dyn0[b]) + _rows_mean(dd1, dyn1[b])
                     + _rows_mean((out["flow"][b] ** 2).sum(-1), static[b]))
    return torch.stack(terms).mean()


def loss_of(name: str, out, batch) -> torch.Tensor:
    return seflow_loss(out, batch) if name == "seflowLoss" else supervised_loss(name, out, batch)
