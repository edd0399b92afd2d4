"""Seeded synthetic AV2-shaped frame pairs: the benchmark's traffic.

A frozen copy of the repository's synthetic batch arithmetic
(``chip_smoke.make_batch``, ``skewed_cloud`` and ``entry_dataset``), kept
here so that the yardstick does not move with the program.  Two changes:
the valid point count varies from sample to sample, and the clouds are
near-field heavy (a gamma-distributed radius and two dense clusters), as
AV2's are.

Every seed draws the same set of per-sample sizes (valid counts, mover
speeds, ego steps, DUFO shares), spread evenly over the ranges the traffic
file gives, only in another order; the points themselves are random.  So
the work of a pool does not depend on the seed.

A sample has the keys of ``HDF5Dataset.__getitem__``: ``pc0``, ``pc1``
[N, 3] f32, ``pose0``, ``pose1``, ``ego_motion`` [4, 4] f32, ``pc0_mask``,
``pc1_mask``, ``flow_is_valid``, ``eval_mask`` [N] bool, ``flow`` [N, 3]
f32 (total flow, ego motion included), ``flow_category_indices`` [N]
int32, ``scene_id``, ``timestamp``, ``num_points0``; with a DUFO share also
``dufo_label0``, ``dufo_label1`` [N] int32.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# the keys of a traffic file, with their defaults
DEFAULTS = {
    "samples": 64,              # frame pairs in the pool
    "slots": 98304,             # max_points: padded slots a cloud
    "valid": [50000, 90000],    # valid points a cloud, spread over the pool
    "foreground_share": 0.4,    # points of a labelled class
    "moving_share": 0.5,        # foreground points that move
    "mover_sigma_m": [0.2, 2.0],  # std of a mover's flow per sweep, spread
    "ego_step_m": [0.5, 1.5],   # ego translation per sweep, spread
    "ego_yaw_rad": 0.02,        # ego yaw per sweep, up to
    "dufo_share": 0.0,          # DUFO-dynamic points a cloud (0: no labels)
    "eval_box_m": 35.0,         # the eval mask: |x|, |y| below
    "cluster_share": 0.0625,    # points in each of two dense clusters
}


def params(traffic: Dict) -> Dict:
    """The traffic file's parameters over the defaults; unknown keys raise."""
    unknown = set(traffic) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    return {**DEFAULTS, **traffic}


def _spread(rng, lo_hi, n: int) -> np.ndarray:
    """``n`` values evenly over ``[lo, hi]``, in an order drawn by ``rng``."""
    lo, hi = lo_hi
    return rng.permutation(np.linspace(lo, hi, n))


def skewed_cloud(rng, n: int, valid: int, cluster_share: float) -> np.ndarray:
    """Near-field-heavy radial density and two dense clusters; rows past
    ``valid`` are zero padding."""
    r = np.clip(rng.gamma(2.0, 8.0, valid), 1.5, 51.0)
    th = rng.uniform(0, 2 * np.pi, valid)
    pts = np.zeros((n, 3), np.float32)
    pts[:valid] = np.stack([r * np.cos(th), r * np.sin(th),
                            rng.uniform(-2.8, 2.8, valid)], -1)
    k = int(valid * cluster_share)
    for c in ((8.0, 3.0), (-5.0, -12.0)):
        sel = rng.integers(0, valid, k)
        pts[sel, :2] = np.asarray(c) + rng.normal(0, 0.6, (k, 2))
    return pts


def _pose(x: float, yaw: float) -> np.ndarray:
    p = np.eye(4, dtype=np.float64)
    p[0, 0] = p[1, 1] = np.cos(yaw)
    p[0, 1], p[1, 0] = -np.sin(yaw), np.sin(yaw)
    p[0, 3] = x
    return p


def make_pool(traffic: Dict, seed: int) -> List[Dict]:
    """The pool of ``samples`` frame pairs of ``seed``."""
    p = params(traffic)
    rng = np.random.default_rng(int(seed))
    n, count = int(p["slots"]), int(p["samples"])
    valids = np.round(_spread(rng, p["valid"], count)).astype(np.int64)
    sigmas = _spread(rng, p["mover_sigma_m"], count)
    steps = _spread(rng, p["ego_step_m"], count)
    yaws = _spread(rng, [-p["ego_yaw_rad"], p["ego_yaw_rad"]], count)
    pool = []
    for i in range(count):
        valid = int(valids[i])
        mask = np.arange(n) < valid
        pc0 = skewed_cloud(rng, n, valid, p["cluster_share"])
        pose0 = _pose(0.0, 0.0)
        pose1 = _pose(float(steps[i]), float(yaws[i]))
        ego = np.linalg.inv(pose1) @ pose0
        cls = np.where(rng.random(n) < p["foreground_share"],
                       rng.integers(1, 30, n), 0).astype(np.int32)
        moving = (cls > 0) & (rng.random(n) < p["moving_share"])
        rigid = pc0.astype(np.float64) @ ego[:3, :3].T + ego[:3, 3] - pc0
        flow = rigid + moving[:, None] * rng.normal(0, sigmas[i], (n, 3))
        flow = np.where(mask[:, None], flow, 0.0).astype(np.float32)
        cls = np.where(mask, cls, 0).astype(np.int32)
        pc1 = (pc0 + flow + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
        pc1 = pc1[np.concatenate([rng.permutation(valid), np.arange(valid, n)])]
        pc1[~mask] = 0.0
        s = {"pc0": pc0, "pc1": pc1,
             "pose0": pose0.astype(np.float32), "pose1": pose1.astype(np.float32),
             "ego_motion": ego.astype(np.float32),
             "pc0_mask": mask, "pc1_mask": mask.copy(), "flow": flow,
             "flow_is_valid": mask.copy(), "flow_category_indices": cls,
             "eval_mask": mask & (np.abs(pc0[:, :2]) < p["eval_box_m"]).all(1),
             "scene_id": f"scene_{i:04d}", "timestamp": str(1_000_000_000 + i),
             "num_points0": np.int32(valid)}
        if p["dufo_share"] > 0:
            for side in ("0", "1"):
                lab = (rng.random(n) < p["dufo_share"]) & mask
                s[f"dufo_label{side}"] = lab.astype(np.int32)
        pool.append(s)
    return pool


def sample_index(scene_id: str) -> int:
    """The pool index of a sample from its ``scene_id``."""
    return int(scene_id.rsplit("_", 1)[1])
