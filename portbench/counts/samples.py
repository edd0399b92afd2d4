"""Per-sample counts that the FLOP and byte counts read: the valid (real,
finite, in range) points of each cloud and the distinct pillars they
occupy, binned as the configuration bins them (pc0 after the ego
motion, evaluated in f64 and rounded to f32)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _binned(pts: np.ndarray, mask: np.ndarray, cfg: Dict):
    lo = np.asarray(cfg["point_cloud_range"][:3], np.float32)
    hi = np.asarray(cfg["point_cloud_range"][3:], np.float32)
    vs = np.asarray(cfg["voxel_size"], np.float32)
    grid = np.round((hi - lo) / vs).astype(np.int64)
    rel = np.floor((pts.astype(np.float32) - lo) / vs)
    ok = mask & np.isfinite(pts).all(1) & ((rel >= 0) & (rel < grid)).all(1)
    cell = rel[ok].astype(np.int64)
    return int(ok.sum()), int(np.unique(cell[:, 1] * grid[0] + cell[:, 0]).size)


def sample_stats(sample: Dict, cfg: Dict) -> Dict[str, int]:
    ego = sample["ego_motion"].astype(np.float64)
    tpc0 = (sample["pc0"].astype(np.float64) @ ego[:3, :3].T + ego[:3, 3]).astype(np.float32)
    v0, o0 = _binned(tpc0, sample["pc0_mask"], cfg)
    v1, o1 = _binned(sample["pc1"], sample["pc1_mask"], cfg)
    return {"valid0": v0, "valid1": v1, "occupied0": o0, "occupied1": o1}
