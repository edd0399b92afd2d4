"""Host-side ragged bookkeeping for the device.

The port's own copy of ``deflow_tpu/data/host_prep.py`` (``prep_sample`` and
``attach_host_prep(sort=True)``).  Per cloud the host does the ego
compensation, pillar binning, the stable sort by pillar id and the sorted
9-lane PFN record, and permutes every per-point array into ascending-id
order, so the device runs no sort and no permute.  The work runs in the C++
host ops (``utils/native.py``, the default: one call a sample that writes
its rows of every output) or in the numpy versions here, the plain
versions the C++ matches bit for bit (``backend="numpy"``).

Pillar ids use the s2d order on even grids,
``((y>>1)·W/2 + (x>>1))·4 + (y&1)·2 + (x&1)``, row-major otherwise; invalid
and padding points carry the trash id ``W·H``.

Adds to a collated batch (all per-point arrays now in sorted order):
    pc0_transformed            [B, N, 3] f32  ego-compensated pc0
    pc{0,1}_ids, pc{0,1}_sorted [B, N] int32  ascending pillar ids
    pc{0,1}_sorted_rec         [B, N, 9] f32  [xyz | p−centroid | p−center]
    pc{0,1}_unsort             [B, N] int32   ``out_orig = out_sorted[unsort]``

and, when the batch carries DUFO labels (SSL), pc1's chamfer cell sort
(``chamfer_cell_prep``) from pc1's final, sorted row order:
    pc1_cell_lanes             [B, 5, N] f32  cell-sorted x, y, z, flag, row
    pc1_cell_sid               [B, N] int32   local cell ids (masked: kgap)
    pc1_cell_start             [B, kgap+1] int32  first row of each cell
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from deflow_tpu_torch.utils import native

HOST_PREP_KEYS = (
    "pc0_transformed",
    "pc0_ids", "pc0_sorted", "pc1_ids", "pc1_sorted",
    "pc0_sorted_rec", "pc1_sorted_rec",
)

# SSL: pc1's chamfer cell sort for the cell sweep (ops/chamfer.py
# ``_sweep_cloud_from_host``); pc1 carries no gradient, so the host owns it
CHAMFER_CELL_KEYS = ("pc1_cell_lanes", "pc1_cell_sid", "pc1_cell_start")

# per-point batch keys that ride pc0's (resp. pc1's) point order, the cloud
# first (the fused C++ call reads pc1's sorted rows from its output)
_PC0_ALIGNED = ("pc0", "pc0_mask", "flow", "flow_is_valid",
                "flow_category_indices", "eval_mask", "dufo_label0")
_PC1_ALIGNED = ("pc1", "pc1_mask", "dufo_label1")


use_s2d = native.use_s2d


def encode_ids(cx, cy, grid):
    if use_s2d(grid):
        cell = (cy >> 1) * (int(grid[0]) // 2) + (cx >> 1)
        return cell * 4 + (cy & 1) * 2 + (cx & 1)
    return cy * int(grid[0]) + cx


def decode_ids(pid, grid):
    """Pillar id → (cx, cy)."""
    if use_s2d(grid):
        ph = pid % 4
        cell = pid // 4
        w2 = int(grid[0]) // 2
        return (cell % w2) * 2 + ph % 2, (cell // w2) * 2 + ph // 2
    return pid % int(grid[0]), pid // int(grid[0])


def se3_transform(pts: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """``p @ R^T + t`` evaluated in f64 and rounded once to f32."""
    p = np.asarray(pts[:, :3], np.float64)
    pose = np.asarray(pose, np.float64)
    out = (p[:, 0:1] * pose[:3, 0] + p[:, 1:2] * pose[:3, 1]
           + p[:, 2:3] * pose[:3, 2] + pose[:3, 3])
    return out.astype(np.float32)


def pillar_prep(pts: np.ndarray, mask: np.ndarray, vmin, vsize, grid):
    """Bin + stable sort of one padded cloud.

    Returns (pillar_id, order, iperm, sorted_id), each [N] int32."""
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    n = len(pts)
    grid = np.asarray(grid, np.int32)
    trash = int(grid[0]) * int(grid[1])
    rel = np.floor((pts - np.asarray(vmin, np.float32))
                   / np.asarray(vsize, np.float32))
    ok = (np.asarray(mask, bool) & np.isfinite(pts).all(1)
          & ((rel >= 0) & (rel < grid)).all(1))
    c = np.where(ok[:, None], rel, 0).astype(np.int64)
    pid = np.where(ok, encode_ids(c[:, 0], c[:, 1], grid), trash).astype(np.int32)
    order = np.argsort(pid, kind="stable").astype(np.int32)
    iperm = np.empty_like(order)
    iperm[order] = np.arange(n, dtype=np.int32)
    return pid, order, iperm, pid[order]


def sorted_record(pts: np.ndarray, order: np.ndarray, sorted_id: np.ndarray,
                  vmin, vsize, grid) -> np.ndarray:
    """Sorted 9-lane record ``[xyz | p−centroid | p−center]`` (invalid rows 0)."""
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    grid = np.asarray(grid, np.int32)
    vmin = np.asarray(vmin, np.float32)
    vsize = np.asarray(vsize, np.float32)
    trash = int(grid[0]) * int(grid[1])
    valid = sorted_id < trash
    pts_s = pts[order]
    safe_id = np.where(valid, sorted_id, 0).astype(np.int64)
    counts = np.bincount(safe_id, weights=valid, minlength=trash)
    cent = np.stack([
        np.bincount(safe_id, weights=np.where(valid, pts_s[:, a], 0.0),
                    minlength=trash) for a in range(3)], axis=-1)
    cent /= np.maximum(counts, 1.0)[:, None]
    cluster = pts_s - cent[safe_id].astype(np.float32)
    gx, gy = decode_ids(safe_id, grid)
    cz = np.clip(np.floor((pts_s[:, 2] - vmin[2]) / vsize[2]), 0, grid[2] - 1)
    center = np.stack([(gx.astype(np.float32) + 0.5) * vsize[0] + vmin[0],
                       (gy.astype(np.float32) + 0.5) * vsize[1] + vmin[1],
                       (cz + 0.5) * vsize[2] + vmin[2]], axis=-1)
    rec = np.concatenate([pts_s, cluster, pts_s - center], axis=-1)
    return np.where(valid[:, None], rec, 0.0).astype(np.float32)


def chamfer_cell_prep(pts: np.ndarray, mask: np.ndarray, flag: np.ndarray,
                      cell: float = 2.0,
                      lo: Sequence[float] = (-51.2, -51.2),
                      hi: Sequence[float] = (51.2, 51.2)) -> Dict[str, np.ndarray]:
    """One cloud's chamfer cell sort: XY binned into ``cell``-metre cells
    (true f32 division, floor, clip), rows stably sorted by local cell id
    ``cy·gx + cx`` (masked rows: the per-sample sentinel ``kgap =
    (gy+1)·gx``).  Returns ``lanes`` [5, N] f32 (sorted x, y, z with masked
    rows zeroed, flag, original row), ``sid`` [N] int32 sorted local ids and
    ``start`` [kgap+1] int32, the first sorted row with id >= c.  The
    geometry must match the loss's ``NNSpec`` (cell = max(truncate, 0.5),
    ring 1, ±51.2 m)."""
    gx = int(np.ceil((hi[0] - lo[0]) / cell - 1e-6))
    gy = int(np.ceil((hi[1] - lo[1]) / cell - 1e-6))
    kgap = (gy + 1) * gx
    rel = (pts[:, :2].astype(np.float32) - np.asarray(lo, np.float32)) / np.float32(cell)
    cc = np.floor(rel).astype(np.int32)
    cx = np.clip(cc[:, 0], 0, gx - 1)
    cy = np.clip(cc[:, 1], 0, gy - 1)
    sid_local = np.where(mask, cy * gx + cx, kgap).astype(np.int32)
    order = np.argsort(sid_local, kind="stable")
    sid_sorted = sid_local[order]
    p = np.where(mask[order][:, None], pts[order], 0.0).astype(np.float32)
    lanes = np.stack([p[:, 0], p[:, 1], p[:, 2],
                      flag[order].astype(np.float32), order.astype(np.float32)])
    start = np.searchsorted(sid_sorted,
                            np.arange(kgap + 1, dtype=np.int32)).astype(np.int32)
    return {"lanes": lanes, "sid": sid_sorted, "start": start}


def permute_rows(a: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``a[order]`` along the point axis."""
    return np.ascontiguousarray(a)[order]


def _grid_of(voxel_size, point_cloud_range):
    lo = np.asarray(point_cloud_range[:3], np.float32)
    hi = np.asarray(point_cloud_range[3:], np.float32)
    vs = np.asarray(voxel_size, np.float32)
    return lo, vs, np.round((hi - lo) / vs).astype(np.int32)


def _ego_motion(batch, i) -> np.ndarray:
    if "ego_motion" in batch:
        return np.asarray(batch["ego_motion"][i], np.float64)
    return np.linalg.inv(np.asarray(batch["pose1"][i], np.float64)) @ np.asarray(
        batch["pose0"][i], np.float64)


def prep_sample(
    pc0: np.ndarray, pc1: np.ndarray,
    pc0_mask: np.ndarray, pc1_mask: np.ndarray,
    ego_motion: np.ndarray,
    voxel_size: Sequence[float], point_cloud_range: Sequence[float],
) -> Dict[str, np.ndarray]:
    """Per-sample host prep in the clouds' original point order (numpy)."""
    lo, vs, grid = _grid_of(voxel_size, point_cloud_range)
    tpc0 = se3_transform(pc0, ego_motion)
    out = {"pc0_transformed": tpc0}
    for tag, pts, mask in (("pc0", tpc0, pc0_mask), ("pc1", pc1, pc1_mask)):
        pid, order, iperm, sid = pillar_prep(pts, mask, lo, vs, grid)
        out[f"{tag}_ids"] = pid
        out[f"{tag}_order"] = order
        out[f"{tag}_iperm"] = iperm
        out[f"{tag}_sorted"] = sid
        out[f"{tag}_sorted_rec"] = sorted_record(pts, order, sid, lo, vs, grid)
    return out


_OUT_KEYS = HOST_PREP_KEYS + ("pc0_unsort", "pc1_unsort") + CHAMFER_CELL_KEYS


def attach_host_prep(
    batch: Dict[str, np.ndarray],
    voxel_size: Sequence[float],
    point_cloud_range: Sequence[float],
    num_workers: int = 0,
    backend: str = "native",
) -> Dict[str, np.ndarray]:
    """Augment a collated batch in place with the fully sorted host prep.

    Every per-point array is permuted into ascending-pillar-id order, so the
    model runs no permute; ``pc{0,1}_unsort`` restores the original order
    on the host (``out_orig = out_sorted[unsort]``).  ``backend`` is
    ``"native"`` (the C++ host ops; raises if they cannot be built) or
    ``"numpy"``.  ``num_workers > 1`` preps the samples in parallel on
    ``utils.native.shared_pool``.

    The native backend allocates each output once for the batch and preps
    each sample in one GIL-free call (``native.host_prep``) that writes the
    sample's rows of every output; the permuted per-point arrays replace
    the batch's.  ``attach_host_prep.fused_samples`` counts those calls."""
    if backend == "native":
        return _attach_native(batch, voxel_size, point_cloud_range, num_workers)
    if backend != "numpy":
        raise ValueError(f"unknown host-prep backend {backend!r} (native | numpy)")

    def one(i):
        p = prep_sample(batch["pc0"][i], batch["pc1"][i],
                        batch["pc0_mask"][i], batch["pc1_mask"][i],
                        _ego_motion(batch, i), voxel_size, point_cloud_range)
        for keys, o in ((_PC0_ALIGNED, p["pc0_order"]),
                        (_PC1_ALIGNED, p["pc1_order"])):
            for k in keys:
                if k in batch:
                    batch[k][i] = permute_rows(batch[k][i], o)
        p["pc0_transformed"] = permute_rows(p["pc0_transformed"], p["pc0_order"])
        for tag in ("pc0", "pc1"):
            p[f"{tag}_ids"] = p[f"{tag}_sorted"]
            p[f"{tag}_unsort"] = p.pop(f"{tag}_iperm")
            del p[f"{tag}_order"]
        if "dufo_label1" in batch:
            cp = chamfer_cell_prep(
                batch["pc1"][i], batch["pc1_mask"][i],
                batch["pc1_mask"][i] & (batch["dufo_label1"][i] > 0))
            for k in CHAMFER_CELL_KEYS:
                p[k] = cp[k[len("pc1_cell_"):]]
        return p

    b = batch["pc0"].shape[0]
    if num_workers > 1 and b > 1:
        per = list(native.shared_pool(num_workers).map(one, range(b)))
    else:
        per = [one(i) for i in range(b)]

    for k in _OUT_KEYS:
        if k in per[0]:
            batch[k] = np.stack([p[k] for p in per])
    return batch


def _attach_native(batch, voxel_size, point_cloud_range, num_workers):
    lo, vs, grid = _grid_of(voxel_size, point_cloud_range)
    b = len(batch["pc0"])
    keys = [{k: batch[k] for k in aligned if k in batch}
            for aligned in (_PC0_ALIGNED, _PC1_ALIGNED)]
    flag = (batch["pc1_mask"] & (batch["dufo_label1"] > 0)
            if "dufo_label1" in batch else None)
    out, run = native.host_prep(keys, (batch["pc0_mask"], batch["pc1_mask"]),
                                np.stack([_ego_motion(batch, i) for i in range(b)]),
                                lo, vs, grid, cell_flag=flag)
    if num_workers > 1 and b > 1:
        list(native.shared_pool(num_workers).map(run, range(b)))
    else:
        for i in range(b):
            run(i)
    attach_host_prep.fused_samples += b
    batch.update((k, out[k]) for k in (*keys[0], *keys[1], *_OUT_KEYS) if k in out)
    return batch


attach_host_prep.fused_samples = 0


def host_prep_from_batch(batch) -> "dict | None":
    """The model's ``host_prep`` argument from a (device) batch dict."""
    if "pc0_ids" not in batch:
        return None
    return {k: batch[k] for k in HOST_PREP_KEYS if k in batch}
