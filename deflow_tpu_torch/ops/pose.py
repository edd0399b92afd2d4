"""SE(3) pose utilities for ego-motion compensation (f32).

Counterpart of ``deflow_tpu/ops/pose.py``: ``pose_0to1 = inv(pose1) @ pose0``
with the inverse formed analytically from the rotation transpose, and points
moved as ``p @ R^T + t``.  Poses carry ~1e3-scale translations, so callers
keep this math in f32 whatever the model's compute dtype.
"""

from __future__ import annotations

import torch


def _se3_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a 4x4 SE(3) matrix (..., 4, 4)."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    inv_trans = -torch.einsum("...ij,...j->...i", rot_t, pose[..., :3, 3])
    out = torch.zeros_like(pose)
    out[..., :3, :3] = rot_t
    out[..., :3, 3] = inv_trans
    out[..., 3, 3] = 1.0
    return out


def cal_pose0to1(pose0: torch.Tensor, pose1: torch.Tensor) -> torch.Tensor:
    """Relative pose mapping frame-0 ego coordinates into frame 1."""
    return _se3_inverse(pose1) @ pose0


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to (..., N, 3) points: ``p @ R^T + t``."""
    rot = pose[..., :3, :3]
    trans = pose[..., :3, 3]
    return torch.einsum("...nj,...ij->...ni", points, rot) + trans[..., None, :]
