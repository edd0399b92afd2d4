"""Sorted segment-sums: the embedder's pillar scatter and the chamfer
VJP's lane scatter.

``sorted_segment_sum`` launches ``csrc/segment_sum.cu`` on CUDA tensors and
takes the plain PyTorch version, ``segment_sum_plain``, only for CPU
tensors.  Counterpart of ``deflow_tpu/ops/pallas_scatter.py``
(``pillar_sum_scatter_pallas`` with a presorted plan).

Contract: ``feats [N, C]`` (f32 or bf16), ``ids [N]`` int32, cut into
``samples`` equal parts: part b holds positions ``[b·N/samples,
(b+1)·N/samples)`` and owns rows ``[b·S/samples, (b+1)·S/samples)`` of the
``S = num_segments`` rows.  Within each part the ids ascend, every id below
S lies in the part's own rows, and the ids ≥ S (the sentinel) come last, a
tail; ids outside ``[0, S)`` add nothing.  ``make_presorted_plan`` gives this
with one part per sample; a stream with one part is ascending ids and a
sentinel tail (``plan_is_sorted`` checks a plan).  Empty rows are exact
zeros; f32 accumulation in point order, output in the input dtype.

``segment_sum_lanes`` (``csrc/segment_sum_lanes.cu``, plain version
``segment_sum_lanes_plain``) is the narrow-row counterpart of
``segment_sum_lanes_pallas``: ``rows [N, L ≤ 7]`` f32 by ascending ids into
``[num_segments, L]`` f32, ids outside ``[0, num_segments)`` adding nothing.
"""

from __future__ import annotations

import ctypes

import torch

from deflow_tpu_torch.ops import _build

# the JAX package's sentinel rule (its scatter tile, TILE_P = 1024)
_SENTINEL_ROUND = 1024


def sentinel_for(num_segments: int) -> int:
    """The beyond-table id of a point that must add nothing."""
    return -(-num_segments // _SENTINEL_ROUND) * _SENTINEL_ROUND + 1


def segment_sum_plain(feats: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """index_add_ into an f32 table with one extra row that takes the
    sentinels; rounded once to the input dtype."""
    s = num_segments
    idx = torch.where((ids >= 0) & (ids < s), ids, s).long()
    out = torch.zeros(s + 1, feats.shape[1], dtype=torch.float32,
                      device=feats.device)
    out.index_add_(0, idx, feats.float())
    return out[:s].to(feats.dtype)


def plan_is_sorted(ids: torch.Tensor, num_segments: int, samples: int = 1) -> bool:
    """Whether ``ids`` meets ``sorted_segment_sum``'s contract for
    ``samples`` parts: in each part ascending, the ids ≥ ``num_segments``
    last, every id in ``[0, num_segments)`` in the part's own rows (plain
    torch, on the ids' device)."""
    s_per = num_segments // samples
    part = ids.reshape(samples, -1).long()
    own = torch.arange(samples, device=ids.device)[:, None] * s_per
    real = (part >= 0) & (part < num_segments)
    in_own = ~real | ((part >= own) & (part < own + s_per))
    key = part.clamp(max=num_segments)          # the sentinels tie, last
    return bool(in_own.all() and (key[:, 1:] >= key[:, :-1]).all())


def _setup(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum.restype = i32
    lib.segment_sum.argtypes = [vp, vp, i32, i32, i32, i32, vp, i32, vp]
    lib.segment_sum_max_cols.restype = i32
    lib.segment_sum_max_cols.argtypes = []


def segment_sum_max_rows() -> int:
    """The most rows (points or segments) ``sorted_segment_sum`` takes: the
    kernel counts them in int32."""
    return 2 ** 31 - 1


def sorted_segment_sum(feats: torch.Tensor, ids: torch.Tensor,
                       num_segments: int, samples: int = 1) -> torch.Tensor:
    """Segment-sum of ``feats [N, C]`` by ``ids [N]``, ascending within
    each of ``samples`` parts, into ``[num_segments, C]``."""
    if feats.dim() != 2 or ids.dim() != 1 or ids.shape[0] != feats.shape[0]:
        raise ValueError(f"feats {tuple(feats.shape)} / ids {tuple(ids.shape)}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats dtype {feats.dtype}: f32 or bf16 only")
    if ids.dtype != torch.int32 or ids.device != feats.device:
        raise ValueError("ids must be int32 on the features' device")
    n, c = feats.shape
    if samples < 1 or n % samples or num_segments % samples:
        raise ValueError(f"samples {samples} must divide the {n} points and "
                         f"the {num_segments} rows")
    if feats.device.type == "cpu":
        return segment_sum_plain(feats, ids, num_segments)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if not (feats.is_contiguous() and ids.is_contiguous()):
        raise ValueError("feats and ids must be contiguous")
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned")
    if max(n, num_segments) > segment_sum_max_rows():
        raise ValueError(f"{max(n, num_segments)} rows: beyond the kernel's int32 row count")
    lib = _build.load("segment_sum", _setup)
    if c > lib.segment_sum_max_cols():
        raise ValueError(f"rows of {c} lanes beyond the kernel's "
                         f"{lib.segment_sum_max_cols()}")
    out = torch.empty(num_segments, c, dtype=feats.dtype, device=feats.device)
    rc = lib.segment_sum(feats.data_ptr(), ids.data_ptr(), n, c, num_segments,
                         samples, out.data_ptr(), int(feats.dtype == torch.bfloat16),
                         _build.stream_ptr(feats))
    _build.check(lib, rc, "segment_sum")
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0

MAX_LANES = 7


def segment_sum_lanes_plain(rows: torch.Tensor, ids: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """index_add_ into an f32 table with one extra row that takes the
    out-of-range ids."""
    s = num_segments
    idx = torch.where((ids >= 0) & (ids < s), ids, s).long()
    out = torch.zeros(s + 1, rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, idx, rows.float())
    return out[:s]


def _setup_lanes(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum_lanes.restype = i32
    lib.segment_sum_lanes.argtypes = [vp, vp, i32, i32, i32, vp, vp]


def segment_sum_lanes(rows: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Segment-sum of ``rows [N, L]`` f32 (1 ≤ L ≤ 7) by ascending
    ``ids [N]`` int32 into ``[num_segments, L]`` f32."""
    if rows.dim() != 2 or ids.dim() != 1 or ids.shape[0] != rows.shape[0]:
        raise ValueError(f"rows {tuple(rows.shape)} / ids {tuple(ids.shape)}")
    if rows.dtype != torch.float32 or not 1 <= rows.shape[1] <= MAX_LANES:
        raise ValueError(f"rows {rows.dtype} x {rows.shape[1]} lanes: "
                         f"f32 with 1..{MAX_LANES} lanes only")
    if ids.dtype != torch.int32 or ids.device != rows.device:
        raise ValueError("ids must be int32 on the rows' device")
    if rows.device.type == "cpu":
        return segment_sum_lanes_plain(rows, ids, num_segments)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if not (rows.is_contiguous() and ids.is_contiguous()):
        raise ValueError("rows and ids must be contiguous")
    if max(rows.numel(), num_segments * rows.shape[1]) >= 2 ** 31:
        raise ValueError("sizes beyond int32 indexing")
    lib = _build.load("segment_sum_lanes", _setup_lanes)
    out = torch.empty(num_segments, rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    rc = lib.segment_sum_lanes(rows.data_ptr(), ids.data_ptr(), rows.shape[0],
                               rows.shape[1], num_segments, out.data_ptr(),
                               _build.stream_ptr(rows))
    _build.check(lib, rc, "segment_sum_lanes")
    segment_sum_lanes.launches += 1
    return out


segment_sum_lanes.launches = 0
