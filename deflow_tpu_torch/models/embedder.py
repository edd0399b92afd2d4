"""DynamicEmbedder: points → per-point PFN features → pillar means.

Counterpart of ``deflow_tpu/models/embedder.py``, by two routes.

- The host sorted-record path (``forward``): the host ships the 9-lane PFN
  input ``[xyz | p−centroid | p−center]`` in ascending pillar-id order, a
  bias-free Linear(9→C) + BatchNorm (eps 1e-3) + ReLU makes the per-point
  features, and ONE sorted segment-sum over the C feature lanes plus a
  count lane (C + 1 = 33 lanes) gives the pillar means, ``sum / max(count,
  1)``.
- The device path (``embed_points``), for clouds without a host prep (a
  batch in its own point order, and the history frames): the points are
  binned on the device (``compute_pillar_info``), sorted once
  (``make_batched_scatter_plan``), the centroids come from a 4-lane
  segment-sum in the compute dtype and a gather back to the points, then
  the same feature net and mean scatter, both through the plan.

``scatter_mode="max"`` (the JAX embedder's attribute, which no config
sets) takes each pillar's elementwise max in place of the mean
(``pillar_max_scatter_batched``).  It runs the device path's centroids
and feature net on either route: without the sorted record, over the
host's ids and their presorted plan when the batch is host-sorted.

Empty pillars are exact zeros.  The count lane carries no gradient (the
JAX package's ``stop_gradient``); the feature lanes' gradient flows back
through the scatter's backward (a gather) into ``feature_net``.  In train
mode the BN running statistics move once per call, in the model's call
order (pc0, pc1, then each history frame), as flax's sequential updates do.

The parameter names follow the reference layout
(``feature_net.pfn_layers.0.{0,1}``).
"""

from __future__ import annotations

import torch
from torch import nn

from deflow_tpu_torch import dist
from deflow_tpu_torch.models.running_stats import update_running_
from deflow_tpu_torch.ops.voxel import (
    TRASH_PAD, PillarInfo, ScatterPlan, VoxelConfig, compute_pillar_info,
    make_batched_scatter_plan, make_presorted_scatter_plan, pillar_centroids_batched,
    pillar_info_from_ids, pillar_max_scatter_batched, pillar_mean_scatter_batched,
    segment_sum_batched)


def masked_batch_norm(x: torch.Tensor, mask: torch.Tensor,
                      bn: nn.BatchNorm1d) -> torch.Tensor:
    """``MaskedBatchNorm`` in f32 (``deflow_tpu/models/embedder.py``).

    Eval: the running statistics.  Train: mean and (biased, two-pass)
    variance over the ``mask``-true rows only, as torch BatchNorm1d sees the
    compacted points; the running statistics then move the torch way,
    ``ra = (1 − momentum)·ra + momentum·batch``, with the UNBIASED variance.
    Under a process group the rows are the global batch's: Σx with the
    count, then Σ(x − mean)², are summed over ranks (differentiably)."""
    xf = x.float()
    if bn.training:
        m = mask.float()[..., None]
        dims = tuple(range(x.dim() - 1))
        tot = dist.all_reduce_sum(torch.cat([(xf * m).sum(dims), m.sum().reshape(1)]))
        n = tot[-1].clamp(min=1.0)
        mean = tot[:-1] / n
        diff = (xf - mean) * m
        var = dist.all_reduce_sum((diff * diff).sum(dims)) / n
        with torch.no_grad():
            unbiased = var * n / (n - 1.0).clamp(min=1.0)
        update_running_(bn.running_mean, mean, bn.momentum)
        update_running_(bn.running_var, unbiased, bn.momentum)
    else:
        mean, var = bn.running_mean, bn.running_var
    return (xf - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


class PillarFeatureNet(nn.Module):
    """Linear(9→C, bias-free) + BN(eps 1e-3, momentum 0.01) + ReLU per point;
    invalid points output zeros."""

    def __init__(self, feat_channels: int = 32):
        super().__init__()
        self.pfn_layers = nn.ModuleList([nn.Sequential(
            nn.Linear(9, feat_channels, bias=False),
            nn.BatchNorm1d(feat_channels, eps=1e-3, momentum=0.01),
            nn.ReLU())])

    def forward(self, feats9: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        linear, bn, _ = self.pfn_layers[0]
        x = feats9.to(dtype) @ linear.weight.to(dtype).t()
        x = torch.relu(masked_batch_norm(x, mask, bn).to(dtype))
        return torch.where(mask[..., None], x, 0)


class DynamicEmbedder(nn.Module):
    """Host sorted record [B, N, 9] + sorted ids [B, N] (``forward``), or
    points [B, N, 3] + mask (``embed_points``) → pillar table [B, P, C]
    (id order) in the compute dtype."""

    def __init__(self, voxel_cfg: VoxelConfig, feat_channels: int = 32,
                 scatter_mode: str = "avg"):
        super().__init__()
        if scatter_mode not in ("avg", "max"):
            raise ValueError(f"scatter_mode {scatter_mode!r}: avg or max")
        self.voxel_cfg = voxel_cfg
        self.scatter_mode = scatter_mode
        self.feature_net = PillarFeatureNet(feat_channels)

    def forward(self, sorted_rec: torch.Tensor, sorted_id: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        p = self.voxel_cfg.num_pillars
        valid = sorted_id < p
        feats = self.feature_net(sorted_rec, valid, dtype)
        c = feats.shape[-1]
        data = torch.cat([feats, valid.to(dtype)[..., None]], dim=-1)
        sums = segment_sum_batched(data, sorted_id, p + TRASH_PAD)
        return sums[:, :p, :c] / sums[:, :p, c:].detach().clamp(min=1.0)

    def embed_points(self, points: torch.Tensor, mask: torch.Tensor,
                     dtype: torch.dtype, ids: "torch.Tensor | None" = None):
        """The device path: points [B, N, 3] f32 + mask → (pillar table
        [B, P, C], PillarInfo, ScatterPlan); the plan routes the decoder
        gather's backward too.  Without ``ids`` the points, in any order,
        are binned and sorted on the device; ``ids`` are the host's pillar
        ids of a host-sorted batch (ascending within each sample), whose
        plan needs no sort."""
        cfg = self.voxel_cfg
        if ids is None:
            info: PillarInfo = compute_pillar_info(points, mask, cfg)
            plan: ScatterPlan = make_batched_scatter_plan(
                info.pillar_id, cfg.num_pillars + TRASH_PAD)
        else:
            info = pillar_info_from_ids(points, mask, ids, cfg)
            plan = make_presorted_scatter_plan(ids, cfg.num_pillars + TRASH_PAD)
        cluster = pillar_centroids_batched(info, plan, dtype)
        feats9 = torch.cat([info.points, cluster, info.offsets], dim=-1)
        feats = self.feature_net(feats9, info.valid, dtype)
        scatter = (pillar_max_scatter_batched if self.scatter_mode == "max"
                   else pillar_mean_scatter_batched)
        return scatter(feats, info, cfg, plan), info, plan
