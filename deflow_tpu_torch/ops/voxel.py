"""Dynamic pillar voxelization on static-shaped batches.

Counterpart of ``deflow_tpu/ops/voxel.py``.  Every point keeps its slot in a
fixed ``[B, N]`` buffer with a validity mask; invalid points carry the trash
id ``num_pillars``.  The per-sample pillar tables are ``num_pillars +
TRASH_PAD`` rows long for the scatter (flattened over the batch with a
per-sample offset) and ``num_pillars`` rows long for the gather.

Two routes reach the kernels.  A host-sorted batch (``attach_host_prep``)
arrives in ascending pillar-id order and runs no sort and no permute
(``segment_sum_batched``, ``pseudoimage_gather_batched`` without a plan).
A batch in its own point order is binned on the device
(``compute_pillar_info``) and sorted once (``make_batched_scatter_plan``);
every scatter over it, and the gather's backward, permutes its rows by the
plan's order and runs the same kernels on the ascending ids.

Layout: a pillar table ``[B, P, C]`` is in pillar-id order; on even grids the
ids are s2d-ordered, ``((y>>1)·W/2 + (x>>1))·4 + (y&1)·2 + (x&1)``, so the
table unfolds to the NCHW image through ``[B, H/2, W/2, 2, 2, C]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from deflow_tpu_torch.ops import gather as _gather
from deflow_tpu_torch.ops import scatter as _scatter

# Rows reserved past ``num_pillars`` for the trash segment of each sample
# (kept from the JAX package so the flattened segment count is the same).
TRASH_PAD = 8
# Flat id of a point that must not reach the gather (any id ≥ B·P reads 0).
GATHER_SENTINEL = 2 ** 30


@dataclass(frozen=True)
class VoxelConfig:
    """Static voxel-grid geometry."""

    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 6.0)
    point_cloud_range: Tuple[float, float, float, float, float, float] = (
        -51.2, -51.2, -3.0, 51.2, 51.2, 3.0,
    )

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(W_x, H_y, D_z) derived from range / voxel size."""
        lo = self.point_cloud_range[:3]
        hi = self.point_cloud_range[3:]
        return tuple(
            int(round((h - l) / v)) for l, h, v in zip(lo, hi, self.voxel_size))

    @property
    def num_pillars(self) -> int:
        w, h, _ = self.grid_size
        return w * h

    @property
    def pseudoimage_hw(self) -> Tuple[int, int]:
        w, h, _ = self.grid_size
        return (h, w)

    @property
    def use_s2d(self) -> bool:
        """Space-to-depth pillar-id order (even grids)."""
        w, h, _ = self.grid_size
        return w % 2 == 0 and h % 2 == 0


def encode_pillar_id(cy: torch.Tensor, cx: torch.Tensor, cfg: VoxelConfig):
    """Cell coords → pillar id under the config's id order."""
    w, _, _ = cfg.grid_size
    if cfg.use_s2d:
        cell = (cy // 2) * (w // 2) + cx // 2
        return cell * 4 + (cy % 2) * 2 + (cx % 2)
    return cy * w + cx


def decode_pillar_id(pid: torch.Tensor, cfg: VoxelConfig):
    """Pillar id → (cy, cx) under the config's id order."""
    w, _, _ = cfg.grid_size
    if cfg.use_s2d:
        ph = pid % 4
        cell = pid // 4
        return (cell // (w // 2)) * 2 + ph // 2, (cell % (w // 2)) * 2 + ph % 2
    return pid // w, pid % w


class PillarInfo(NamedTuple):
    """Per-point pillar assignment, arrays [..., N]."""

    pillar_id: torch.Tensor   # int32 in [0, num_pillars]; num_pillars = trash
    valid: torch.Tensor       # bool: in range AND not padding
    coords_yx: torch.Tensor   # [..., N, 2] int32; zeros where invalid
    offsets: torch.Tensor     # [..., N, 3] f32 point − pillar center
    points: torch.Tensor      # [..., N, 3] f32, zeroed where invalid


def _lo_vsz(points: torch.Tensor, cfg: VoxelConfig):
    vsz = torch.tensor(cfg.voxel_size, dtype=points.dtype, device=points.device)
    lo = torch.tensor(cfg.point_cloud_range[:3], dtype=points.dtype,
                      device=points.device)
    return lo, vsz


def _center(cx, cy, cz, lo, vsz):
    return (torch.stack([cx, cy, cz], dim=-1).to(lo.dtype) + 0.5) * vsz + lo


def compute_pillar_info(points: torch.Tensor, mask: torch.Tensor,
                        cfg: VoxelConfig) -> PillarInfo:
    """Bin points ([..., N, 3]) into pillars on the device; ``mask`` marks
    real points.  True f32 division, as the reference voxelizer bins."""
    w, h, d = cfg.grid_size
    lo, vsz = _lo_vsz(points, cfg)
    safe = torch.where(mask[..., None], points, 0.0)
    coords = torch.floor((safe - lo) / vsz).to(torch.int32)
    in_range = (
        mask
        & (coords[..., 0] >= 0) & (coords[..., 0] < w)
        & (coords[..., 1] >= 0) & (coords[..., 1] < h)
        & (coords[..., 2] >= 0) & (coords[..., 2] < d)
        & torch.isfinite(points).all(dim=-1)
    )
    cx = coords[..., 0].clamp(0, w - 1)
    cy = coords[..., 1].clamp(0, h - 1)
    cz = coords[..., 2].clamp(0, d - 1)
    pid = torch.where(in_range, encode_pillar_id(cy, cx, cfg),
                      cfg.num_pillars).to(torch.int32)
    offsets = torch.where(in_range[..., None],
                          safe - _center(cx, cy, cz, lo, vsz), 0.0)
    coords_yx = torch.where(in_range[..., None], torch.stack([cy, cx], -1),
                            0).to(torch.int32)
    clean = torch.where(in_range[..., None], safe, 0.0)
    return PillarInfo(pid, in_range, coords_yx, offsets, clean)


def pillar_info_from_ids(points: torch.Tensor, mask: torch.Tensor,
                         ids: torch.Tensor, cfg: VoxelConfig) -> PillarInfo:
    """PillarInfo from HOST-computed pillar ids (the single source of truth).

    The z bin, which only shapes the continuous center-offset feature, is
    recomputed from z with true f32 division."""
    _, _, d = cfg.grid_size
    lo, vsz = _lo_vsz(points, cfg)
    valid = mask & (ids < cfg.num_pillars)
    safe_ids = torch.where(valid, ids, 0)
    cy, cx = decode_pillar_id(safe_ids, cfg)
    safe = torch.where(valid[..., None], points, 0.0)
    cz = torch.floor((safe[..., 2] - lo[2]) / vsz[2]).to(torch.int32).clamp(0, d - 1)
    offsets = torch.where(valid[..., None],
                          safe - _center(cx, cy, cz, lo, vsz), 0.0)
    coords_yx = torch.where(valid[..., None], torch.stack([cy, cx], -1),
                            0).to(torch.int32)
    pid = torch.where(valid, ids, cfg.num_pillars).to(torch.int32)
    return PillarInfo(pid, valid, coords_yx, offsets, safe)


def make_presorted_plan(sorted_id: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Flat ids [B·N] for the sorted segment-sum over B·num_segments rows.

    Per-sample ids arrive ascending; sample b is offset by b·num_segments.
    Trash points (id ≥ num_segments − TRASH_PAD) go to the beyond-table
    sentinel, so no output row accumulates them."""
    b, _ = sorted_id.shape
    trash = num_segments - TRASH_PAD
    boff = (torch.arange(b, dtype=torch.int32, device=sorted_id.device)
            * num_segments)[:, None]
    sentinel = _scatter.sentinel_for(b * num_segments)
    flat = torch.where(sorted_id < trash, sorted_id.to(torch.int32) + boff,
                       sentinel)
    return flat.reshape(-1).to(torch.int32)


class _SegmentSum(torch.autograd.Function):
    """Sorted segment-sum whose backward is the sorted row gather of the
    cotangent at the same flat ids (``pallas_scatter._planned_bwd``)."""

    @staticmethod
    def forward(ctx, data, flat_ids, num_rows, samples):
        ctx.save_for_backward(flat_ids)
        ctx.num_rows = num_rows
        return _scatter.sorted_segment_sum(data, flat_ids, num_rows, samples)

    @staticmethod
    def backward(ctx, g):
        (flat_ids,) = ctx.saved_tensors
        return (_gather.sorted_rows_gather(g.contiguous(), flat_ids, ctx.num_rows),
                None, None, None)


def segment_sum_batched(data: torch.Tensor, sorted_id: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """[B, N, C] × ascending [B, N] ids → [B, num_segments, C].

    The batch is flattened into ONE sorted segment-sum over B·num_segments
    rows in B parts (one kernel launch); its gradient is one sorted gather."""
    b, n, c = data.shape
    flat = _SegmentSum.apply(data.reshape(b * n, c),
                             make_presorted_plan(sorted_id, num_segments),
                             b * num_segments, b)
    return flat.reshape(b, num_segments, c)


def table_to_image(table: torch.Tensor, cfg: VoxelConfig) -> torch.Tensor:
    """Id-ordered pillar table [B, P, C] → NCHW pseudoimage [B, C, H, W]."""
    b, _, c = table.shape
    h, w = cfg.pseudoimage_hw
    if cfg.use_s2d:
        img = table.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 5, 1, 3, 2, 4)
    else:
        img = table.reshape(b, h, w, c).permute(0, 3, 1, 2)
    return img.reshape(b, c, h, w)


def image_to_table(image: torch.Tensor, cfg: VoxelConfig) -> torch.Tensor:
    """NCHW pseudoimage [B, C, H, W] → id-ordered pillar table [B, P, C]."""
    b, c, h, w = image.shape
    if cfg.use_s2d:
        t = image.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 3, 5, 1)
    else:
        t = image.permute(0, 2, 3, 1)
    return t.reshape(b, h * w, c)


class ScatterPlan(NamedTuple):
    """One stable device sort of a batch's flat pillar ids, shared by every
    scatter over them (``pallas_scatter.ScatterPlan``)."""

    order: torch.Tensor       # [B·N] int64: the points in ascending flat-id order
    sorted_ids: torch.Tensor  # [B·N] int32: the segment-sum's ids in that order
    flat_ids: torch.Tensor    # [B·N] int32: the same ids in the points' own order
    num_rows: int             # B·num_segments
    samples: int              # B


def make_batched_scatter_plan(pillar_id: torch.Tensor,
                              num_segments: int) -> ScatterPlan:
    """The plan of ``pillar_id [B, N]`` (trash id ``num_segments −
    TRASH_PAD``) over B·num_segments rows: ONE stable sort of the
    sample-offset ids (``jnp.argsort`` is stable too), so each pillar still
    sums in point order.  Each sample's points keep their own N positions
    of the sorted stream, its trash points last; there, and in the
    original order, the trash takes the beyond-table sentinel, so no row
    accumulates it and the backward gather reads zeros for it."""
    b, n = pillar_id.shape
    trash = num_segments - TRASH_PAD
    boff = (torch.arange(b, dtype=torch.int32, device=pillar_id.device)
            * num_segments)[:, None]
    key = pillar_id.to(torch.int32) + boff
    sorted_key, order = torch.sort(key.reshape(-1), stable=True)
    sentinel = _scatter.sentinel_for(b * num_segments)
    sorted_ids = torch.where(sorted_key.reshape(b, n) - boff < trash,
                             sorted_key.reshape(b, n), sentinel)
    flat_ids = torch.where(pillar_id < trash, key, sentinel)
    return ScatterPlan(order, sorted_ids.reshape(-1).to(torch.int32),
                       flat_ids.reshape(-1).to(torch.int32), b * num_segments, b)


def make_presorted_scatter_plan(sorted_id: torch.Tensor,
                                num_segments: int) -> ScatterPlan:
    """The plan of ids that already ascend within each sample (a
    host-sorted batch; ``voxel.make_presorted_plan``): no sort, the
    identity order."""
    b, n = sorted_id.shape
    flat = make_presorted_plan(sorted_id, num_segments)
    return ScatterPlan(torch.arange(b * n, device=sorted_id.device), flat, flat,
                       b * num_segments, b)


def _planned_sum(rows: torch.Tensor, order: torch.Tensor, sorted_ids: torch.Tensor,
                 num_rows: int, samples: int) -> torch.Tensor:
    """[B·N, C] rows in the points' own order, permuted into the plan's
    order (a plain ``index_select``, as XLA permutes in the JAX package),
    then summed by the sorted segment-sum on the ascending ids."""
    return _scatter.sorted_segment_sum(rows.index_select(0, order), sorted_ids,
                                       num_rows, samples)


class _PlannedSegmentSum(torch.autograd.Function):
    """Segment-sum through a plan (:func:`_planned_sum`).  The backward
    gathers the cotangent at each point's own flat id, in the points'
    original order (``pallas_scatter._planned_bwd``); trash and invalid
    points read zeros."""

    @staticmethod
    def forward(ctx, data, order, sorted_ids, flat_ids, num_rows, samples):
        ctx.save_for_backward(flat_ids)
        ctx.num_rows = num_rows
        return _planned_sum(data, order, sorted_ids, num_rows, samples)

    @staticmethod
    def backward(ctx, g):
        (flat_ids,) = ctx.saved_tensors
        return (_gather.sorted_rows_gather(g.contiguous(), flat_ids, ctx.num_rows),
                None, None, None, None, None)


def segment_sum_planned(data: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """[B, N, C] in the points' own order → [B, num_segments, C] through
    ``plan`` (one permute, one kernel launch)."""
    b, n, c = data.shape
    flat = _PlannedSegmentSum.apply(data.reshape(b * n, c), plan.order,
                                    plan.sorted_ids, plan.flat_ids,
                                    plan.num_rows, plan.samples)
    return flat.reshape(b, plan.num_rows // b, c)


def pillar_centroids_batched(info: PillarInfo, plan: ScatterPlan,
                             dtype: torch.dtype) -> torch.Tensor:
    """``point − centroid of its pillar`` [B, N, 3] f32, zero where invalid
    (``voxel.pillar_centroids_batched``).

    In pillar-centred coordinates, ``p − centroid = offsets −
    mean(offsets)`` exactly, and the offsets are bounded by half a voxel,
    so the sum runs in the compute dtype: one segment-sum of [offsets |
    1] (4 lanes), then one row gather of [mean offset | count] (f32) back
    to the points at the plan's flat ids."""
    off = info.offsets.to(dtype)
    data = torch.cat([off, info.valid.to(dtype)[..., None]], dim=-1)
    sums = segment_sum_planned(data, plan).float()
    mean = sums[..., :3] / sums[..., 3:].clamp(min=1.0)
    table = torch.cat([mean, sums[..., 3:]], dim=-1).reshape(plan.num_rows, 4)
    b, n = info.valid.shape
    per_point = _gather.sorted_rows_gather(table, plan.flat_ids,
                                           plan.num_rows).reshape(b, n, 4)
    return torch.where(info.valid[..., None],
                       info.offsets.float() - per_point[..., :3], 0.0)


def pillar_mean_scatter_batched(feats: torch.Tensor, info: PillarInfo,
                                cfg: VoxelConfig, plan: ScatterPlan) -> torch.Tensor:
    """Per-point features [B, N, C] → id-ordered pillar table [B, P, C],
    the mean of each pillar's valid points (``DynamicScatter(avg)``);
    empty pillars are exact zeros.  The count lane carries no gradient."""
    p, c = cfg.num_pillars, feats.shape[-1]
    feats = torch.where(info.valid[..., None], feats, 0)
    data = torch.cat([feats, info.valid.to(feats.dtype)[..., None]], dim=-1)
    sums = segment_sum_planned(data, plan)
    return sums[:, :p, :c] / sums[:, :p, c:].detach().clamp(min=1.0)


def pillar_max_scatter_batched(feats: torch.Tensor, info: PillarInfo,
                               cfg: VoxelConfig, plan: ScatterPlan) -> torch.Tensor:
    """Per-point features [B, N, C] → id-ordered pillar table [B, P, C],
    the elementwise max over each pillar's valid points
    (``DynamicScatter(max)``, ``voxel.pillar_max_scatter``).  Empty
    pillars are exact zeros: invalid points enter at −3e38 (finite in
    bf16 too) and the pillar counts, a segment-sum through ``plan``, mask
    the pillars without a point.  The max is ``scatter_reduce("amax")``
    (the JAX package's is XLA's ``segment_max``, no Pallas kernel); its
    gradient goes to the point at the maximum and, on ties, in equal
    shares to every tied point, as ``segment_max``'s does."""
    b, n, c = feats.shape
    p = cfg.num_pillars
    neg = torch.full((), -3.0e38, dtype=feats.dtype, device=feats.device)
    masked = torch.where(info.valid[..., None], feats, neg).reshape(b * n, c)
    seg = p + TRASH_PAD
    rows = (info.pillar_id.long()
            + (torch.arange(b, device=feats.device) * seg)[:, None]).reshape(-1)
    # the base is −inf (segment_max's identity): the backward of amax
    # counts a base element equal to the result as a tie, even with
    # include_self=False, and no finite feature equals −inf
    maxed = masked.new_full((b * seg, c), float("-inf")).scatter_reduce(
        0, rows[:, None].expand(-1, c), masked, "amax", include_self=False)
    counts = segment_sum_planned(info.valid.to(feats.dtype)[..., None], plan)
    maxed = maxed.reshape(b, seg, c)[:, :p]
    return torch.where(counts[:, :p] > 0, maxed, 0)


class _Gather(torch.autograd.Function):
    """Unpillar gather whose backward is a sorted segment-sum of the
    per-point cotangent over the scatter's B·(P + TRASH_PAD) rows, invalid
    slots routed to the trash row (``voxel._gather_planned_bwd``)."""

    @staticmethod
    def forward(ctx, table, flat_ids, pillar_id, valid):
        b, p, c = table.shape
        ctx.save_for_backward(pillar_id, valid)
        ctx.p = p
        n = pillar_id.shape[1]
        return _gather.sorted_rows_gather(table.reshape(b * p, c), flat_ids,
                                          b * p).reshape(b, n, c)

    @staticmethod
    def backward(ctx, g):
        pillar_id, valid = ctx.saved_tensors
        p = ctx.p
        g = torch.where(valid[..., None], g, 0).contiguous()
        pid = torch.where(valid, pillar_id, p)
        d = segment_sum_batched(g, pid, p + TRASH_PAD)[:, :p]
        return d, None, None, None


class _PlannedGather(torch.autograd.Function):
    """Unpillar gather of points in their own order (the ids do not
    ascend); its backward is the planned segment-sum of the per-point
    cotangent, invalid slots adding nothing (``voxel._gather_planned_bwd``
    with a plan that permutes)."""

    @staticmethod
    def forward(ctx, table, flat_ids, valid, order, sorted_ids, num_rows, samples):
        b, p, c = table.shape
        ctx.save_for_backward(valid, order, sorted_ids)
        ctx.p, ctx.num_rows, ctx.samples = p, num_rows, samples
        n = valid.shape[1]
        return _gather.sorted_rows_gather(table.reshape(b * p, c), flat_ids,
                                          b * p).reshape(b, n, c)

    @staticmethod
    def backward(ctx, g):
        valid, order, sorted_ids = ctx.saved_tensors
        b, n = valid.shape
        g = torch.where(valid[..., None], g, 0).reshape(b * n, -1)
        d = _planned_sum(g, order, sorted_ids, ctx.num_rows, ctx.samples)
        return (d.reshape(b, ctx.num_rows // b, -1)[:, :ctx.p],
                None, None, None, None, None, None)


def pseudoimage_gather_batched(table: torch.Tensor, info: PillarInfo,
                               plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """Unpillar gather from flat pillar tables [B, P, C] → [B, N, C].

    Flat ids use the B·P stride (no TRASH_PAD rows); invalid slots take the
    sentinel and read exact zeros.  Without ``plan`` the points must be
    host-sorted (the backward sums by their ascending ids); with the
    embedder's plan they may come in any order."""
    b, p, _ = table.shape
    boff = (torch.arange(b, dtype=torch.int32, device=table.device) * p)[:, None]
    flat_ids = torch.where(info.valid & (info.pillar_id < p),
                           info.pillar_id + boff, GATHER_SENTINEL)
    flat_ids = flat_ids.reshape(-1).to(torch.int32)
    if plan is None:
        return _Gather.apply(table.contiguous(), flat_ids, info.pillar_id, info.valid)
    return _PlannedGather.apply(table.contiguous(), flat_ids, info.valid, plan.order,
                                plan.sorted_ids, plan.num_rows, plan.samples)
