"""Brute nearest neighbour: the exact masked chamfer search.

``chamfer_min`` launches ``csrc/chamfer_brute.cu`` on CUDA tensors and takes
the plain PyTorch version, ``chamfer_min_plain``, only for CPU tensors.
Counterpart of ``deflow_tpu/ops/pallas_chamfer.py`` (``chamfer_min_pallas``
and its kernel ``_chamfer_min_single``), with its contract:

- masked q rows are folded to the far sentinel (1e6, 1e6, 1e6);
- d = (|p|² + |q|²) − 2·((px·qx + py·qy) + pz·qz), |v|² = (x² + y²) + z²,
  one rounding per operation, clamped with max(d, 0);
- ties go to the lower q index; with no q row at all: (3e38, 0).

Shapes: p [B, N, 3] or [N, 3], q [B, M, 3] or [M, 3], q_mask [B, M] or [M]
bool → (dist [B, N] f32, idx [B, N] int32), without the B for 2-D inputs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deflow_tpu_torch.ops import _build

_FAR = 1.0e6
_BIG = 3.0e38
PLAIN_TILE = 4096   # q rows per step of the plain version


def _sq3(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def chamfer_min_unclamped(p: torch.Tensor, q: torch.Tensor,
                          q_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The strict < scan of ``chamfer_min_plain`` before its clamp, batched
    only: (d [B, N] f32, which may be negative, idx [B, N] int64); tiled
    over q so that a full-width call holds one [B, N, PLAIN_TILE] block at
    a time."""
    p, q = p.float(), q.float()
    b, n, _ = p.shape
    q = torch.where(q_mask[..., None], q, _FAR)
    p2, q2 = _sq3(p), _sq3(q)
    best = torch.full((b, n), _BIG, dtype=torch.float32, device=p.device)
    best_i = torch.zeros((b, n), dtype=torch.int64, device=p.device)
    for t0 in range(0, q.shape[1], PLAIN_TILE):
        qt = q[:, t0:t0 + PLAIN_TILE]
        dot = (p[:, :, None, 0] * qt[:, None, :, 0] + p[:, :, None, 1] * qt[:, None, :, 1]
               + p[:, :, None, 2] * qt[:, None, :, 2])
        d = (p2[:, :, None] + q2[:, None, t0:t0 + PLAIN_TILE]) - 2.0 * dot
        m = d.amin(-1)
        cols = torch.arange(t0, t0 + qt.shape[1], device=p.device)
        first = torch.where(d <= m[..., None], cols, q.shape[1]).amin(-1)
        take = m < best
        best = torch.where(take, m, best)
        best_i = torch.where(take, first, best_i)
    return best, best_i


def chamfer_min_plain(p: torch.Tensor, q: torch.Tensor,
                      q_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same expanded formula in PyTorch: the unclamped scan, then
    max(d, 0)."""
    batched = p.dim() == 3
    if not batched:
        p, q, q_mask = p[None], q[None], q_mask[None]
    best, best_i = chamfer_min_unclamped(p, q, q_mask)
    dist, idx = best.clamp(min=0.0), best_i.to(torch.int32)
    return (dist, idx) if batched else (dist[0], idx[0])


def _setup(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.chamfer_brute.restype = i32
    lib.chamfer_brute.argtypes = [vp, vp, vp, i32, i32, i32, vp, vp, vp, vp, vp]
    lib.chamfer_brute_pieces.restype = i32
    lib.chamfer_brute_pieces.argtypes = [i32]


def chamfer_min(p: torch.Tensor, q: torch.Tensor,
                q_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked nearest neighbour of each p row among the q rows of its
    sample: (dist, idx); see the module docstring."""
    batched = p.dim() == 3
    if (p.dim() not in (2, 3) or q.dim() != p.dim() or q_mask.dim() != p.dim() - 1
            or p.shape[-1] != 3 or q.shape[-1] != 3 or q_mask.shape != q.shape[:-1]
            or (batched and q.shape[0] != p.shape[0])):
        raise ValueError(f"p {tuple(p.shape)} / q {tuple(q.shape)} / "
                         f"q_mask {tuple(q_mask.shape)}")
    if p.dtype != torch.float32 or q.dtype != torch.float32 or q_mask.dtype != torch.bool:
        raise ValueError("p and q must be f32 and q_mask bool")
    if q.device != p.device or q_mask.device != p.device:
        raise ValueError("p, q and q_mask must be on one device")
    if p.device.type == "cpu":
        return chamfer_min_plain(p, q, q_mask)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    if not batched:
        p, q, q_mask = p[None], q[None], q_mask[None]
    p, q, q_mask = p.contiguous(), q.contiguous(), q_mask.contiguous()
    b, n, _ = p.shape
    m = q.shape[1]
    if max(b * n, b * m) * 3 >= 2 ** 31 or b >= 2 ** 16:
        raise ValueError("sizes beyond the kernel's indexing")
    lib = _build.load("chamfer_brute", _setup)
    pieces = lib.chamfer_brute_pieces(m)
    if pieces >= 2 ** 16:
        raise ValueError("sizes beyond the kernel's indexing")
    dist = torch.empty(b, n, dtype=torch.float32, device=p.device)
    idx = torch.empty(b, n, dtype=torch.int32, device=p.device)
    # each q piece's unclamped (d, index) per p row, merged in q order
    part_d = torch.empty(pieces, b, n, dtype=torch.float32, device=p.device)
    part_i = torch.empty(pieces, b, n, dtype=torch.int32, device=p.device)
    rc = lib.chamfer_brute(p.data_ptr(), q.data_ptr(), q_mask.data_ptr(), b, n,
                           m, part_d.data_ptr(), part_i.data_ptr(),
                           dist.data_ptr(), idx.data_ptr(), _build.stream_ptr(p))
    _build.check(lib, rc, "chamfer_brute")
    chamfer_min.launches += 1
    return (dist, idx) if batched else (dist[0], idx[0])


chamfer_min.launches = 0
