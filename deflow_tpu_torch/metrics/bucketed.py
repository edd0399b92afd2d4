"""Bucketed-by-class-and-speed normalized EPE (AV2 leaderboard v2).

The port's own copy of ``deflow_tpu/metrics/bucketed.py``: the 2024 AV2
scene-flow leaderboard metric ("Bucket Normalized EPE", Khatri et al.,
arXiv:2403.07432).  A frame's sums are ``np.bincount``s, added to the
running sums per frame (the JAX package adds point by point with
``np.add.at``: the same sums up to rounding, several times faster).

Definition implemented:
- AV2 categories collapse into five metaclasses (BACKGROUND, CAR,
  OTHER_VEHICLES, PEDESTRIAN, WHEELED_VRU); remaining static-world categories
  (signs, cones, animals) are excluded.
- per metaclass, points are histogrammed into speed buckets of 0.4 m/s width
  from 0 to 20 m/s (speed = ||gt_flow − ego_flow|| / 0.1 s); bucket 0
  (< 0.4 m/s) is the *static* bucket.
- Static EPE  = plain mean EPE of the static bucket.
- Dynamic Normalized EPE = mean over non-empty dynamic buckets of
  (bucket mean EPE) / (bucket mean speed · 0.1 s) — error as a fraction of
  how far the points actually moved.
- headline numbers: mean Static EPE and mean Dynamic Normalized EPE over
  metaclasses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# AV2 scene-flow category vocabulary (index order of `flow_category_indices`
# in the .h5 schema; 0 = NONE/background).
AV2_CATEGORIES = (
    "NONE", "ANIMAL", "ARTICULATED_BUS", "BICYCLE", "BICYCLIST", "BOLLARD",
    "BOX_TRUCK", "BUS", "CONSTRUCTION_BARREL", "CONSTRUCTION_CONE", "DOG",
    "LARGE_VEHICLE", "MESSAGE_BOARD_TRAILER", "MOBILE_PEDESTRIAN_CROSSING_SIGN",
    "MOTORCYCLE", "MOTORCYCLIST", "OFFICIAL_SIGNALER", "PEDESTRIAN",
    "RAILED_VEHICLE", "REGULAR_VEHICLE", "SCHOOL_BUS", "SIGN", "STOP_SIGN",
    "STROLLER", "TRUCK", "TRUCK_CAB", "VEHICULAR_TRAILER", "WHEELCHAIR",
    "WHEELED_DEVICE", "WHEELED_RIDER",
)

METACLASSES: Dict[str, tuple] = {
    "BACKGROUND": ("NONE",),
    "CAR": ("REGULAR_VEHICLE",),
    "OTHER_VEHICLES": (
        "ARTICULATED_BUS", "BOX_TRUCK", "BUS", "LARGE_VEHICLE",
        "MESSAGE_BOARD_TRAILER", "RAILED_VEHICLE", "SCHOOL_BUS", "TRUCK",
        "TRUCK_CAB", "VEHICULAR_TRAILER",
    ),
    "PEDESTRIAN": ("OFFICIAL_SIGNALER", "PEDESTRIAN", "STROLLER", "WHEELCHAIR"),
    "WHEELED_VRU": (
        "BICYCLE", "BICYCLIST", "MOTORCYCLE", "MOTORCYCLIST",
        "WHEELED_DEVICE", "WHEELED_RIDER",
    ),
}

_SWEEP_DT = 0.1
SPEED_BUCKET_EDGES = np.arange(0.0, 20.0 + 0.4, 0.4)  # 50 buckets of 0.4 m/s
_NUM_BUCKETS = len(SPEED_BUCKET_EDGES) - 1


def _category_to_meta_lut() -> np.ndarray:
    """category index → metaclass id (-1 = excluded)."""
    lut = np.full(len(AV2_CATEGORIES), -1, np.int32)
    for mi, (_, cats) in enumerate(METACLASSES.items()):
        for c in cats:
            lut[AV2_CATEGORIES.index(c)] = mi
    return lut


_SHAPE = (len(METACLASSES), _NUM_BUCKETS)
_LUT = _category_to_meta_lut()


@dataclass
class BucketedEPE:
    """Streaming accumulator: per (metaclass, speed-bucket) EPE/speed sums."""

    epe_sum: np.ndarray = field(default_factory=lambda: np.zeros(_SHAPE))
    speed_sum: np.ndarray = field(default_factory=lambda: np.zeros(_SHAPE))
    count: np.ndarray = field(default_factory=lambda: np.zeros(_SHAPE, np.int64))

    def update(
        self,
        pred_flow: np.ndarray,
        gt_flow: np.ndarray,
        classes: np.ndarray,
        pose_flow: np.ndarray,
        mask: Optional[np.ndarray] = None,
    ) -> None:
        self.add(self.frame_stats(pred_flow, gt_flow, classes, pose_flow, mask))

    @staticmethod
    def frame_stats(pred_flow, gt_flow, classes, pose_flow,
                    mask: Optional[np.ndarray] = None):
        """One frame's (EPE sums, speed sums, counts) per (metaclass, speed
        bucket) cell, each sum over the frame's points in order, as ``add``
        takes them.  A pure function: frames may be computed apart (in
        worker processes) and added in order."""
        if mask is None:
            mask = np.ones(len(pred_flow), bool)
        mask = mask.astype(bool)
        pred, gt = pred_flow[mask], gt_flow[mask]
        cls, ego = classes[mask], pose_flow[mask]

        meta = _LUT[np.clip(cls, 0, len(AV2_CATEGORIES) - 1)]
        keep = meta >= 0
        pred, gt, ego, meta = pred[keep], gt[keep], ego[keep], meta[keep]

        epe = np.linalg.norm(pred - gt, axis=-1)
        speed = np.linalg.norm(gt - ego, axis=-1) / _SWEEP_DT
        bucket = np.clip(
            np.digitize(speed, SPEED_BUCKET_EDGES) - 1, 0, _NUM_BUCKETS - 1
        )
        cell = meta * _NUM_BUCKETS + bucket
        size = _SHAPE[0] * _SHAPE[1]
        return (np.bincount(cell, epe, size).reshape(_SHAPE),
                np.bincount(cell, speed, size).reshape(_SHAPE),
                np.bincount(cell, minlength=size).reshape(_SHAPE))

    def add(self, stats) -> None:
        """Accumulate one frame's ``frame_stats``."""
        epe_sum, speed_sum, count = stats
        self.epe_sum += epe_sum
        self.speed_sum += speed_sum
        self.count += count

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        static_epes, dyn_norm_epes = [], []
        for mi, name in enumerate(METACLASSES):
            cnt = self.count[mi]
            if cnt[0] > 0:
                s_epe = self.epe_sum[mi, 0] / cnt[0]
                out[f"Static_EPE/{name}"] = s_epe
                static_epes.append(s_epe)
            dyn = cnt[1:] > 0
            if dyn.any():
                bucket_epe = self.epe_sum[mi, 1:][dyn] / cnt[1:][dyn]
                bucket_speed = self.speed_sum[mi, 1:][dyn] / cnt[1:][dyn]
                norm_epe = bucket_epe / (bucket_speed * _SWEEP_DT)
                d = float(np.mean(norm_epe))
                out[f"Dynamic_NormEPE/{name}"] = d
                if name != "BACKGROUND":
                    dyn_norm_epes.append(d)
        out["Static_EPE_mean"] = float(np.mean(static_epes)) if static_epes else float("nan")
        out["Dynamic_NormEPE_mean"] = (
            float(np.mean(dyn_norm_epes)) if dyn_norm_epes else float("nan")
        )
        return out

    def table(self) -> str:
        m = self.compute()
        lines = [f"{'metaclass':>16} {'StaticEPE':>10} {'DynNormEPE':>11} {'points':>11}"]
        for mi, name in enumerate(METACLASSES):
            se = m.get(f"Static_EPE/{name}", float("nan"))
            de = m.get(f"Dynamic_NormEPE/{name}", float("nan"))
            lines.append(f"{name:>16} {se:>10.4f} {de:>11.4f} {int(self.count[mi].sum()):>11d}")
        lines.append(
            f"mean Static EPE: {m['Static_EPE_mean']:.4f}   "
            f"mean Dynamic Normalized EPE: {m['Dynamic_NormEPE_mean']:.4f}"
        )
        return "\n".join(lines)
