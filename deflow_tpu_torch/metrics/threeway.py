"""Official AV2 scene-flow 3-way metrics (leaderboard v1).

The reference's ``eval.py av2_mode=val`` "directly prints all metric"
(reference README.md:88-94); the metric bodies live in the av2 api / absent
submodule [T3 — SURVEY.md §2.2].  Implemented from the official AV2 scene-flow
evaluation definition:

- points are split into three buckets by (class, motion):
    FD  foreground & dynamic      FS  foreground & static
    BS  background & static       (background-dynamic is EXCLUDED from the
                                   headline table, matching the official
                                   metric; only its point count is reported)
  foreground = AV2 category != NONE(0); dynamic = ||gt_flow − ego_flow|| >
  0.05 m over the 0.1 s sweep (≥ 0.5 m/s).
- per frame and bucket: EPE (mean L2), AccS (EPE<0.05 m or relative<5%),
  AccR (EPE<0.1 m or relative<10%), angle error (arccos of unit-vector dot).
- the published table is the unweighted mean over frames (frames with an
  empty bucket are skipped for that bucket), matching the leaderboard.

Host-side numpy: metric aggregation is not a device-hot path.  The port's own
copy of ``deflow_tpu/metrics/threeway.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

_EPS = 1e-10
DYNAMIC_THRESHOLD_M = 0.05  # displacement over one 0.1 s sweep


def _accuracy(epe: np.ndarray, gt_norm: np.ndarray, thresh: float) -> np.ndarray:
    rel = epe / (gt_norm + _EPS)
    return ((epe < thresh) | (rel < thresh)).astype(np.float64)


def _angle_error(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    unit_gt = gt / (np.linalg.norm(gt, axis=-1, keepdims=True) + _EPS)
    unit_pred = pred / (np.linalg.norm(pred, axis=-1, keepdims=True) + _EPS)
    eps = float(np.finfo(np.float32).eps)
    dot = np.clip(np.sum(unit_gt * unit_pred, axis=-1), -1.0 + eps, 1.0 - eps)
    return np.arccos(dot)


BUCKETS = ("FD", "FS", "BS")
_STATS = ("EPE", "AccS", "AccR", "Angle")


@dataclass
class ThreewayEPE:
    """Streaming per-frame accumulator for the 3-way table."""

    sums: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: {b: {s: 0.0 for s in _STATS} for b in BUCKETS}
    )
    frames: Dict[str, int] = field(default_factory=lambda: {b: 0 for b in BUCKETS})
    point_counts: Dict[str, int] = field(
        default_factory=lambda: {b: 0 for b in BUCKETS + ("BD",)})

    def update(
        self,
        pred_flow: np.ndarray,       # [N, 3] total predicted flow
        gt_flow: np.ndarray,         # [N, 3] total ground-truth flow
        classes: np.ndarray,         # [N] AV2 category index, 0 = background
        pose_flow: np.ndarray,       # [N, 3] rigid ego flow
        mask: Optional[np.ndarray] = None,  # [N] evaluation mask
    ) -> None:
        self.add(self.frame_stats(pred_flow, gt_flow, classes, pose_flow, mask))

    @staticmethod
    def frame_stats(pred_flow, gt_flow, classes, pose_flow,
                    mask: Optional[np.ndarray] = None) -> Dict[str, tuple]:
        """One frame's contribution, as ``add`` takes it: the BD count and,
        per scored bucket with points, (points, mean EPE, AccS, AccR,
        angle).  A pure function: frames may be computed apart (in worker
        processes) and added in order."""
        if mask is None:
            mask = np.ones(len(pred_flow), bool)
        mask = mask.astype(bool)
        pred, gt = pred_flow[mask], gt_flow[mask]
        cls, ego = classes[mask], pose_flow[mask]

        dynamic = np.linalg.norm(gt - ego, axis=-1) > DYNAMIC_THRESHOLD_M
        foreground = cls > 0
        buckets = {
            "FD": foreground & dynamic,
            "FS": foreground & ~dynamic,
            "BS": ~foreground & ~dynamic,
        }
        # background-dynamic: excluded from the scored buckets; counted so
        # the exclusion is visible in the table
        out = {"BD": int((~foreground & dynamic).sum())}
        epe = np.linalg.norm(pred - gt, axis=-1)
        gt_norm = np.linalg.norm(gt, axis=-1)
        acc_s = _accuracy(epe, gt_norm, 0.05)
        acc_r = _accuracy(epe, gt_norm, 0.10)
        angle = _angle_error(pred, gt)

        for name, sel in buckets.items():
            n = int(sel.sum())
            if n:
                out[name] = (n, float(epe[sel].mean()), float(acc_s[sel].mean()),
                             float(acc_r[sel].mean()), float(angle[sel].mean()))
        return out

    def add(self, stats: Dict[str, tuple]) -> None:
        """Accumulate one frame's ``frame_stats``."""
        self.point_counts["BD"] += stats["BD"]
        for name in BUCKETS:
            if name in stats:
                n, *means = stats[name]
                self.frames[name] += 1
                self.point_counts[name] += n
                for stat, v in zip(_STATS, means):
                    self.sums[name][stat] += v

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for b in BUCKETS:
            n = max(self.frames[b], 1)
            for s in _STATS:
                out[f"{s}_{b}"] = self.sums[b][s] / n if self.frames[b] else float("nan")
        out["EPE_3way_mean"] = float(
            np.nanmean([out["EPE_FD"], out["EPE_FS"], out["EPE_BS"]])
        )
        return out

    def table(self) -> str:
        m = self.compute()
        lines = [
            f"{'bucket':>8} {'EPE':>8} {'AccS':>8} {'AccR':>8} {'Angle':>8} {'points':>10}",
        ]
        for b in BUCKETS:
            lines.append(
                f"{b:>8} {m[f'EPE_{b}']:>8.4f} {m[f'AccS_{b}']:>8.4f} "
                f"{m[f'AccR_{b}']:>8.4f} {m[f'Angle_{b}']:>8.4f} {self.point_counts[b]:>10d}"
            )
        lines.append(f"{'BD':>8} {'—':>8} {'—':>8} {'—':>8} {'—':>8} "
                     f"{self.point_counts['BD']:>10d}  (excluded)")
        lines.append(f"Three-way EPE mean: {m['EPE_3way_mean']:.4f}")
        return "\n".join(lines)
