"""Chamfer / nearest-neighbour distances between point sets, with gradients.

Counterpart of ``deflow_tpu/ops/chamfer.py`` on its kernel paths:

- **brute** (``_ChamferNN``): exact O(N·M) search, ``ops/nn.py``
  ``chamfer_min`` (``csrc/chamfer_brute.cu``), all samples in one launch;
- **grid** (``_ChamferNNGrid``, ``_SSLNN``): both clouds are sorted by a
  flat cell id with one empty gap row per sample, so that the 3×3 ring of a
  chunk of sorted queries is three contiguous candidate spans; the cell
  sweep (``ops/sweep.py``, ``csrc/cell_sweep.cu``) scans them.  Exact for
  every true NN distance below ``ring·cell``; farther ones come back as
  lower bounds ≥ ``ring·cell`` or 3e38, which the truncated losses clip.

Gradients are the matched-pair subgradients of the reference chamfer
extension's autograd: ``2g(p − q*)`` on each query's own row, and the
mirror term scattered into the matched rows of the other cloud.  On the grid
paths the mirror term rides the gather-free 4-lane payload
``(−2g·q, 2g)`` through the lane segment-sum (``ops/scatter.py``
``segment_sum_lanes``, ``csrc/segment_sum_lanes.cu``), and ``p ·`` the
summed g-lane is added afterwards.  Each cloud's gradient is computed only
when autograd asks for it: in SeFlow only the warped pc0 carries one.

``NNSpec.dyn_cap`` compacts the dynamic (flag-only) terms' VJP to that many
rows a sample (the flagged rows first, in their original order): the
own-row f-term then rides the lane segment-sum as a third segment beside
the two mirror segments.  Past the cap, the flagged rows beyond the first
``dyn_cap`` lose their f-term gradient; the forward never changes.
:func:`dyn_cap_overflow_stats` and :func:`grid_overflow_stats` are the
JAX package's telemetry for sizing it and for the XLA grid's capacity.

Not carried over: the XLA grid backend (``_grid_search``, with its per-cell
capacity) and the XLA brute scan.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deflow_tpu_torch.ops import nn as _nn
from deflow_tpu_torch.ops import scatter as _scatter
from deflow_tpu_torch.ops import sweep as _sweep
from deflow_tpu_torch.ops.sweep import CHUNK_C, CHUNK_Q

_BIG = 3.0e38   # no-candidate distance
_SENT = 2.0e19  # coordinate of masked and padding rows (d overflows to inf)

# the pair count above which "auto" takes the grid (16384²)
_AUTO_GRID_PAIRS = 1 << 28


class NNSpec(NamedTuple):
    """Nearest-neighbour search configuration.

    ``method``: ``"brute"`` (exact) or ``"grid"`` (cell sweep over
    ``cell``-metre XY cells within ``lo``..``hi``, each query searching the
    ``(2·ring+1)²`` cells around its own; exact below ``ring·cell``).
    ``dyn_cap``: the row budget of the SeFlow VJP's dynamic terms (None: no
    compaction, the default; flagged rows past it lose their f-term
    gradient)."""

    method: str = "brute"
    cell: float = 2.0
    ring: int = 1
    lo: Tuple[float, float] = (-51.2, -51.2)
    hi: Tuple[float, float] = (51.2, 51.2)
    dyn_cap: Optional[int] = None


def _grid_dims(spec: NNSpec) -> Tuple[int, int]:
    gx = int(math.ceil((spec.hi[0] - spec.lo[0]) / spec.cell - 1e-6))
    gy = int(math.ceil((spec.hi[1] - spec.lo[1]) / spec.cell - 1e-6))
    return max(gx, 1), max(gy, 1)


def _bin2d(pts: torch.Tensor, spec: NNSpec, gx: int, gy: int):
    """Clipped (cx, cy) cell coordinates of ``pts [K, ≥2]``.  True f32
    division: the divisor is a tensor filled on the points' device, since
    CUDA turns a division by a host scalar into a multiplication by its
    reciprocal, which moves ``floor`` at cell boundaries (and a tensor
    copied from the host would synchronise the stream)."""
    cell = torch.full((), spec.cell, dtype=torch.float32, device=pts.device)
    p = pts[:, :2].float()
    cx = torch.floor((p[:, 0] - spec.lo[0]) / cell).to(torch.int64)
    cy = torch.floor((p[:, 1] - spec.lo[1]) / cell).to(torch.int64)
    return cx.clamp(0, gx - 1), cy.clamp(0, gy - 1)


def _resolve_spec(method: str, n: int, m: int, truncate: Optional[float],
                  spec: Optional[NNSpec]) -> NNSpec:
    if spec is not None:
        return spec
    if method == "auto":
        method = ("grid" if truncate is not None and n * m > _AUTO_GRID_PAIRS
                  else "brute")
    if method == "grid":
        # ring·cell >= truncate keeps the truncated loss exact
        return NNSpec(method="grid", cell=max(float(truncate or 2.0), 0.5), ring=1)
    if method != "brute":
        raise ValueError(f"unknown chamfer method {method!r}")
    return NNSpec(method="brute")


# ------------------------------------------------------------ the cell sweep
class SweepCloud(NamedTuple):
    """One cloud sorted by gap-row flat cell id (``(b·(gy+1) + cy)·gx + cx``;
    masked rows take the sentinel ``c_total``)."""

    sid: torch.Tensor       # [B·N] int64 flat cell ids
    sx: torch.Tensor        # [B·N] f32 sorted coordinates (masked: 2e19)
    sy: torch.Tensor
    sz: torch.Tensor
    sflag: torch.Tensor     # [B·N] f32 sorted flags
    sglobal: torch.Tensor   # [B·N] int64 original global rows (b·N + i)
    start: torch.Tensor     # [c_total + 1] int64 first row of each cell
    n: int                  # points per sample
    c_total: int            # B·(gy+1)·gx


def _sweep_sort(pts: torch.Tensor, mask: torch.Tensor,
                flag: Optional[torch.Tensor], spec: NNSpec) -> SweepCloud:
    """Bin and stably sort one batched cloud ``[B, N, 3]`` into the sweep's
    gap-row cell order; masked rows go to the global tail with 2e19
    coordinates."""
    b, n, _ = pts.shape
    gx, gy = _grid_dims(spec)
    c_total = b * (gy + 1) * gx
    dev = pts.device
    pf = pts.reshape(b * n, 3).float()
    cx, cy = _bin2d(pf, spec, gx, gy)
    sidx = torch.arange(b * n, device=dev) // n
    mflat = mask.reshape(-1)
    ids = torch.where(mflat, (sidx * (gy + 1) + cy) * gx + cx, c_total)
    pf = torch.where(mflat[:, None], pf, _SENT)
    flagf = (flag.reshape(-1).float() if flag is not None
             else torch.zeros(b * n, device=dev))
    sid, order = torch.sort(ids, stable=True)
    sp = pf[order]
    start = torch.searchsorted(sid, torch.arange(c_total + 1, device=dev))
    return SweepCloud(sid, sp[:, 0], sp[:, 1], sp[:, 2], flagf[order], order,
                      start, n, c_total)


def _sweep_cloud_from_host(lanes: torch.Tensor, sid_local: torch.Tensor,
                           start: torch.Tensor, spec: NNSpec) -> SweepCloud:
    """A :class:`SweepCloud` from the host's chamfer cell prep (lanes
    [B, 5, N], local sids [B, N], per-sample starts [B, kgap+1]): no device
    sort.  Masked rows sit at each sample's tail with the global sentinel
    id; the w lane makes them lose wherever a window reaches them."""
    b, _, n = lanes.shape
    gx, gy = _grid_dims(spec)
    kgap = (gy + 1) * gx
    c_total = b * kgap
    if start.shape[-1] != kgap + 1:
        raise ValueError(f"host chamfer prep start table has {start.shape[-1] - 1} "
                         f"cells, the spec's grid {kgap}")
    dev = lanes.device
    flat = lambda k: lanes[:, k, :].reshape(b * n).float()
    s_of_row = torch.arange(b * n, device=dev) // n
    loc = sid_local.reshape(b * n).long()
    mrow = loc < kgap
    sid = torch.where(mrow, loc + s_of_row * kgap, c_total)
    sent = lambda v: torch.where(mrow, v, _SENT)
    sglobal = flat(4).long() + s_of_row * n
    start_g = (start[:, :kgap].long()
               + (torch.arange(b, device=dev) * n)[:, None]).reshape(-1)
    start_g = torch.cat([start_g, start_g.new_full((1,), b * n)])
    return SweepCloud(sid, sent(flat(0)), sent(flat(1)), sent(flat(2)),
                      flat(3), sglobal, start_g, n, c_total)


def _pad(v: torch.Tensor, to: int, value: float) -> torch.Tensor:
    return F.pad(v, (0, to - v.shape[0]), value=value)


def sweep_inputs(qc: SweepCloud, cc: SweepCloud, spec: NNSpec):
    """The cell sweep's inputs for queries ``qc`` against candidates ``cc``
    (ops/sweep.py contract): (q_slab, c_slab, cs, cn, dirty)."""
    gx = _grid_dims(spec)[0]
    bn = qc.sid.shape[0]
    b = bn // qc.n
    dev = qc.sid.device
    nq_pad = -(-bn // CHUNK_Q) * CHUNK_Q
    # w = sample·wstep: 0 within a sample, ≥ 2·ring·cell across samples
    kgap = qc.c_total // b
    wstep = float(max(1000.0, math.ceil(spec.ring * spec.cell * 2.0)))

    sid_pad = _pad(qc.sid, nq_pad, qc.c_total)
    qw = torch.where(sid_pad >= qc.c_total, _SENT,
                     (sid_pad // kgap).float() * wstep)
    zero_q = torch.zeros(nq_pad, device=dev)
    q_slab = torch.stack([_pad(qc.sx, nq_pad, 0.0), _pad(qc.sy, nq_pad, 0.0),
                          _pad(qc.sz, nq_pad, 0.0), qw,
                          zero_q, zero_q, zero_q, zero_q], 1)

    nc = cc.sid.shape[0]
    nc_pad = -(-nc // CHUNK_C) * CHUNK_C
    ckgap = cc.c_total // b
    cw = torch.where(cc.sid >= cc.c_total, -_SENT, (cc.sid // ckgap).float() * wstep)
    fpen = torch.where(cc.sflag > 0.5, 0.0, _BIG)
    corig = (cc.sglobal % cc.n).float()
    zero_c = torch.zeros(nc_pad, device=dev)
    c_slab = torch.stack([
        _pad(cc.sx, nc_pad, _SENT), _pad(cc.sy, nc_pad, _SENT),
        _pad(cc.sz, nc_pad, _SENT), _pad(cw, nc_pad, -_SENT),
        _pad(fpen, nc_pad, _BIG), _pad(corig, nc_pad, -1.0), zero_c, zero_c,
    ]).reshape(8, nc_pad // CHUNK_C, CHUNK_C).transpose(0, 1).contiguous()

    # ring-row windows per query chunk; min/max skip the sentinel ids, since
    # the host layout puts each sample's masked tail before the next sample
    sid_chunks = sid_pad.reshape(-1, CHUNK_Q)
    qmin = sid_chunks.amin(1)
    qmax = torch.where(sid_chunks >= qc.c_total, -1, sid_chunks).amax(1)
    # windows can overlap at block granularity: each starts after the last
    # block of the one before it, so no block is visited twice
    cs_cols, cn_cols = [], []
    end = torch.zeros_like(qmin)
    blk_lo = torch.full_like(qmin, 2 ** 30)
    blk_hi = torch.zeros_like(qmin)
    for j in (-1, 0, 1):
        wlo = (qmin + j * gx - 1).clamp(0, cc.c_total - 1)
        whi = (qmax + j * gx + 1).clamp(0, cc.c_total - 1)
        rlo, rhi = cc.start[wlo], cc.start[whi + 1]
        clo = torch.maximum(rlo // CHUNK_C, end)
        chi = -(-rhi // CHUNK_C)
        n_j = torch.where(rhi > rlo, (chi - clo).clamp(min=0), 0)
        end = torch.where(n_j > 0, chi, end)
        blk_lo = torch.where(n_j > 0, torch.minimum(blk_lo, clo), blk_lo)
        blk_hi = torch.where(n_j > 0, torch.maximum(blk_hi, chi), blk_hi)
        cs_cols.append(clo)
        cn_cols.append(n_j)
    cs = torch.stack(cs_cols, 1).to(torch.int32)
    cn = torch.stack(cn_cols, 1).to(torch.int32)

    # a chunk is CLEAN (no w term) when it has a window, all its queries
    # share one sample, and every fetched block row lies inside that
    # sample's own candidate rows.  int64 throughout: blk_lo starts at 2^30,
    # and blk_lo·CHUNK_C wraps in int32.
    sq, sqx = qmin // kgap, qmax // kgap
    row_lo = cc.start[(sq * kgap).clamp(max=cc.c_total)]
    row_hi = cc.start[((sq + 1) * kgap).clamp(max=cc.c_total)]
    clean = ((cn.sum(1) > 0) & (sq == sqx)
             & (blk_lo * CHUNK_C >= row_lo) & (blk_hi * CHUNK_C <= row_hi))
    dirty = (~clean).to(torch.int32)
    return q_slab.contiguous(), c_slab, cs, cn, dirty


def _sweep_dir(qc: SweepCloud, cc: SweepCloud, spec: NNSpec, dual: bool):
    """One sweep direction in ORIGINAL query rows: (d_all, i_all, d_flag,
    i_flag), each [B, N]; i = sample-local candidate rows (int64, −1 where
    no candidate)."""
    out = _sweep.cell_sweep(*sweep_inputs(qc, cc, spec), dual=dual)
    bn = qc.sid.shape[0]
    b = bn // qc.n
    res = torch.empty(bn, 4, dtype=torch.float32, device=out.device)
    res[qc.sglobal] = out[:bn, :4]
    cut = lambda x: x.reshape(b, qc.n)
    return (cut(res[:, 0]), cut(res[:, 1]).long(), cut(res[:, 2]),
            cut(res[:, 3]).long())


# ---------------------------------------------------------- VJP building blocks
def _take_rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """[B, M, 3] at per-sample rows [B, N] (clipped) → [B, N, 3]."""
    idx = i.long().clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _scatter_lanes_flat(flat_i: torch.Tensor, w: torch.Tensor,
                        segs: int) -> torch.Tensor:
    """``out[flat_i[k], l] += w[k, l]`` into [segs, L] zeros; rows with
    flat_i outside [0, segs) are dropped.  One stable sort by id, then the
    lane segment-sum."""
    flat_i = torch.where((flat_i >= 0) & (flat_i < segs), flat_i, segs)
    sid, order = torch.sort(flat_i, stable=True)
    return _scatter.segment_sum_lanes(w.float()[order].contiguous(),
                                      sid.to(torch.int32), segs)


def _scatter_lanes(i: torch.Tensor, w: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``out[b, i[b, k], :] += w[b, k, :]`` into [B, n_rows, L] zeros,
    out-of-range indices dropped: the whole batch in one lane segment-sum."""
    b, m, lanes = w.shape
    off = (torch.arange(b, device=w.device) * n_rows)[:, None]
    flat_i = torch.where((i >= 0) & (i < n_rows), i.long() + off, -1)
    return _scatter_lanes_flat(flat_i.reshape(b * m), w.reshape(b * m, lanes),
                               b * n_rows).reshape(b, n_rows, lanes)


def _mirror_payload(g: torch.Tensor, rows: torch.Tensor,
                    pts: torch.Tensor) -> torch.Tensor:
    """(−2g·q, 2g) on ``rows``, 0 elsewhere: scattered at the matched rows
    i, its first three lanes plus ``p[i] ·`` the fourth give −2g(q − p[i])
    without gathering p."""
    gm = torch.where(rows, 2.0 * g, 0.0)
    return torch.cat([-gm[..., None] * pts, gm[..., None]], dim=-1)


def _w_term(g, pq, qp, idx, row_ok):
    """The own-row term 2g(p − q[i]) on ``row_ok`` rows."""
    diff = torch.where(row_ok[..., None], pq - _take_rows(qp, idx), 0.0)
    return (2.0 * g)[..., None] * diff


def _any(m: torch.Tensor) -> torch.Tensor:
    return m.any(dim=-1, keepdim=True)


def _dyn_cap_for(spec: NNSpec, n: int) -> int:
    """The compacted f-term budget of ``n`` rows: ``spec.dyn_cap`` (at most
    ``n``), or ``n`` (no compaction) when it is None."""
    return n if spec.dyn_cap is None else min(spec.dyn_cap, n)


def _compact_idx(flag: torch.Tensor, cap: int) -> torch.Tensor:
    """[B, N] bool → [B, cap] int64 rows: the flagged rows first, in their
    original order, then unflagged ones (whose f-term is zero).  One sort of
    unique keys a sample (the JAX package's ``lax.sort``)."""
    n = flag.shape[1]
    iota = torch.arange(n, device=flag.device).expand_as(flag)
    keys = torch.where(flag, iota, iota + n)
    return torch.sort(keys, dim=-1).values[:, :cap] % n


def _rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x [B, N]`` at per-sample rows ``i [B, K]``."""
    return torch.gather(x, 1, i)


# ----------------------------------------------------------- autograd functions
class _SSLNN(torch.autograd.Function):
    """The fused SeFlow NN set (batched): per direction ONE sweep gives the
    all-candidates and the flag-only nearest neighbours.  ``host_c1`` (lanes,
    sid, start) replaces pc1's device sort by the host's cell prep.
    Returns (d0a, d1a, d0f, d1f, i0a, i1a, i0f, i1f).  The backward
    compacts the flag-only terms to ``spec.dyn_cap`` rows when that is
    below N (``chamfer._ssl_nn_bwd``)."""

    @staticmethod
    def forward(ctx, pc0, pc1, mask0, mask1, flag0, flag1, spec, host_c1):
        c0 = _sweep_sort(pc0, mask0, flag0, spec)
        c1 = (_sweep_cloud_from_host(*host_c1, spec) if host_c1 is not None
              else _sweep_sort(pc1, mask1, flag1, spec))
        d0a, i0a, d0f, i0f = _sweep_dir(c0, c1, spec, dual=True)
        d1a, i1a, d1f, i1f = _sweep_dir(c1, c0, spec, dual=True)
        d0a = torch.where(mask0, d0a, 0.0)
        d1a = torch.where(mask1, d1a, 0.0)
        d0f = torch.where(mask0 & flag0, d0f, 0.0)
        d1f = torch.where(mask1 & flag1, d1f, 0.0)
        ctx.save_for_backward(pc0, pc1, mask0, mask1, flag0, flag1,
                              i0a, i1a, i0f, i1f)
        ctx.mark_non_differentiable(i0a, i1a, i0f, i1f)
        ctx.spec = spec
        return d0a, d1a, d0f, d1f, i0a, i1a, i0f, i1f

    @staticmethod
    def backward(ctx, g0a, g1a, g0f, g1f, *_):
        pc0, pc1, m0, m1, f0, f1, i0a, i1a, i0f, i1f = ctx.saved_tensors
        ok0a, ok1a = m0 & _any(m1), m1 & _any(m0)
        ok0f, ok1f = (m0 & f0) & _any(m1 & f1), (m1 & f1) & _any(m0 & f0)
        cap0 = _dyn_cap_for(ctx.spec, pc0.shape[1])
        cap1 = _dyn_cap_for(ctx.spec, pc1.shape[1])
        s0 = s1 = None
        if cap0 < pc0.shape[1] or cap1 < pc1.shape[1]:
            s0, s1 = _compact_idx(m0 & f0, cap0), _compact_idx(m1 & f1, cap1)

        def grad(pq, qp, ga, gf, ia, if_, oka, okf, gb_a, gb_f, jb_a, jb_f,
                 okb_a, okb_f, sq, sb):
            # own-row terms of this cloud + mirror terms of the other's
            # matches; compacted, the own-row f-term rides the lane sum as a
            # third segment (its fourth lane 0) at the rows sq
            w = _w_term(ga, pq, qp, ia, oka)
            mirror_a = _mirror_payload(gb_a, okb_a, qp)
            if sq is None:
                w = w + _w_term(gf, pq, qp, if_, okf)
                ids = torch.cat([jb_a, jb_f], 1)
                pay = torch.cat([mirror_a, _mirror_payload(gb_f, okb_f, qp)], 1)
            else:
                wf = _w_term(_rows(gf, sq), _take_rows(pq, sq), qp, _rows(if_, sq),
                             _rows(okf, sq))
                ids = torch.cat([jb_a, sq, _rows(jb_f, sb)], 1)
                pay = torch.cat([mirror_a, F.pad(wf, (0, 1)),
                                 _mirror_payload(_rows(gb_f, sb), _rows(okb_f, sb),
                                                 _take_rows(qp, sb))], 1)
            su = _scatter_lanes(ids, pay, pq.shape[1])
            return w + su[..., :3] + pq * su[..., 3:]

        d_pc0 = d_pc1 = None
        if ctx.needs_input_grad[0]:
            d_pc0 = grad(pc0, pc1, g0a, g0f, i0a, i0f, ok0a, ok0f,
                         g1a, g1f, i1a, i1f, ok1a, ok1f, s0, s1)
        if ctx.needs_input_grad[1]:
            d_pc1 = grad(pc1, pc0, g1a, g1f, i1a, i1f, ok1a, ok1f,
                         g0a, g0f, i0a, i0f, ok0a, ok0f, s1, s0)
        return d_pc0, d_pc1, None, None, None, None, None, None


class _ChamferNNGrid(torch.autograd.Function):
    """Batched bidirectional grid NN (one sweep per direction, no flags):
    (d0, d1, i0, i1)."""

    @staticmethod
    def forward(ctx, pc0, pc1, mask0, mask1, spec):
        c0 = _sweep_sort(pc0, mask0, None, spec)
        c1 = _sweep_sort(pc1, mask1, None, spec)
        d0, i0, _, _ = _sweep_dir(c0, c1, spec, dual=False)
        d1, i1, _, _ = _sweep_dir(c1, c0, spec, dual=False)
        d0 = torch.where(mask0, d0, 0.0)
        d1 = torch.where(mask1, d1, 0.0)
        ctx.save_for_backward(pc0, pc1, mask0, mask1, i0, i1)
        ctx.mark_non_differentiable(i0, i1)
        return d0, d1, i0, i1

    @staticmethod
    def backward(ctx, g0, g1, *_):
        pc0, pc1, m0, m1, i0, i1 = ctx.saved_tensors
        ok0, ok1 = m0 & _any(m1), m1 & _any(m0)

        def grad(pq, qp, g, i, ok, gb, jb, okb):
            s = _scatter_lanes(jb, _mirror_payload(gb, okb, qp), pq.shape[1])
            return _w_term(g, pq, qp, i, ok) + s[..., :3] + pq * s[..., 3:]

        d_pc0 = d_pc1 = None
        if ctx.needs_input_grad[0]:
            d_pc0 = grad(pc0, pc1, g0, i0, ok0, g1, i1, ok1)
        if ctx.needs_input_grad[1]:
            d_pc1 = grad(pc1, pc0, g1, i1, ok1, g0, i0, ok0)
        return d_pc0, d_pc1, None, None, None


class _ChamferNN(torch.autograd.Function):
    """Batched bidirectional brute NN: (d0, d1, i0, i1).  The mirror term is
    an ``index_add_`` (the JAX package's ``.at[].add``, an XLA scatter)."""

    @staticmethod
    def forward(ctx, pc0, pc1, mask0, mask1):
        d0, i0 = _nn.chamfer_min(pc0, pc1, mask1)
        d1, i1 = _nn.chamfer_min(pc1, pc0, mask0)
        d0 = torch.where(mask0, d0, 0.0)
        d1 = torch.where(mask1, d1, 0.0)
        i0, i1 = i0.long(), i1.long()
        ctx.save_for_backward(pc0, pc1, mask0, mask1, i0, i1)
        ctx.mark_non_differentiable(i0, i1)
        return d0, d1, i0, i1

    @staticmethod
    def backward(ctx, g0, g1, *_):
        pc0, pc1, m0, m1, i0, i1 = ctx.saved_tensors
        w0 = _w_term(g0, pc0, pc1, i0, m0 & _any(m1))
        w1 = _w_term(g1, pc1, pc0, i1, m1 & _any(m0))

        def add_at(base, i, w):
            b, n, _ = base.shape
            flat = (i + (torch.arange(b, device=i.device) * n)[:, None]).reshape(-1)
            return base.reshape(b * n, 3).index_add(
                0, flat, -w.reshape(-1, 3)).reshape(b, n, 3)

        d_pc0 = add_at(w0, i1, w1) if ctx.needs_input_grad[0] else None
        d_pc1 = add_at(w1, i0, w0) if ctx.needs_input_grad[1] else None
        return d_pc0, d_pc1, None, None


# ------------------------------------------------------------------ public API
def ssl_chamfer_distances(pc0, pc1, mask0, mask1, dyn0, dyn1,
                          truncate: float = 2.0, spec: Optional[NNSpec] = None,
                          host_c1=None):
    """Fused SeFlow chamfer: (d0_all, d1_all, d0_dyn, d1_dyn) squared NN
    distances; the *_dyn pair restricts both queries and candidates to the
    dynamic subsets.  Grid search (one sweep per direction), exact below
    ``ring·cell >= truncate``.  ``host_c1``: optional (lanes [B,5,N], sid
    [B,N], start [B,K+1]) from the host's ``chamfer_cell_prep`` of pc1.
    ``spec.dyn_cap`` compacts the dynamic terms' backward (see
    :class:`NNSpec`)."""
    if spec is None:
        spec = _resolve_spec("grid", pc0.shape[-2], pc1.shape[-2], truncate, None)
    batched = pc0.dim() == 3
    up = (lambda x: x) if batched else (lambda x: x[None])
    m0, m1 = up(mask0), up(mask1)
    args = [torch.where(m0[..., None], up(pc0), 0.0).float(),
            torch.where(m1[..., None], up(pc1), 0.0).float(),
            m0, m1, up(dyn0), up(dyn1)]
    out = _SSLNN.apply(*args, spec, host_c1)[:4]
    return tuple(x if batched else x[0] for x in out)


def chamfer_distance(pc0, pc1, mask0=None, mask1=None, return_idx: bool = False,
                     method: str = "brute", truncate: Optional[float] = None,
                     spec: Optional[NNSpec] = None):
    """Bidirectional squared nearest-neighbour distances (0 where masked
    out) of pc0 [N, 3] or [B, N, 3] and pc1 [M, 3] or [B, M, 3], and with
    ``return_idx`` the matched rows: the reference chamfer extension's
    (dist1, dist2, idx1, idx2).  ``method``: ``"brute"``, ``"grid"`` or
    ``"auto"`` (grid when ``truncate`` is given and N·M > 2^28); ``spec``
    overrides both.  Differentiable through the matched-pair subgradient."""
    batched = pc0.dim() == 3
    if mask0 is None:
        mask0 = torch.ones(pc0.shape[:-1], dtype=torch.bool, device=pc0.device)
    if mask1 is None:
        mask1 = torch.ones(pc1.shape[:-1], dtype=torch.bool, device=pc1.device)
    pc0 = torch.where(mask0[..., None], pc0, 0.0).float()
    pc1 = torch.where(mask1[..., None], pc1, 0.0).float()
    rspec = _resolve_spec(method, pc0.shape[-2], pc1.shape[-2], truncate, spec)
    up = (lambda x: x) if batched else (lambda x: x[None])
    if rspec.method == "grid":
        out = _ChamferNNGrid.apply(up(pc0), up(pc1), up(mask0), up(mask1), rspec)
    else:
        out = _ChamferNN.apply(up(pc0), up(pc1), up(mask0), up(mask1))
    d0, d1, i0, i1 = (x if batched else x[0] for x in out)
    return (d0, d1, i0, i1) if return_idx else (d0, d1)


def truncated_chamfer_loss(pc0, pc1, mask0, mask1, truncate: float = 2.0,
                           method: str = "auto") -> torch.Tensor:
    """Mean truncated chamfer: distances clipped at ``truncate``² (squared
    metres), each direction averaged over its valid points."""
    d0, d1 = chamfer_distance(pc0, pc1, mask0, mask1, method=method,
                              truncate=truncate)
    t2 = truncate * truncate
    n0 = mask0.sum().clamp(min=1)
    n1 = mask1.sum().clamp(min=1)
    return d0.clamp(max=t2).sum() / n0 + d1.clamp(max=t2).sum() / n1


def dyn_cap_overflow_stats(flags: torch.Tensor, n: Optional[int] = None,
                           spec: Optional[NNSpec] = None):
    """Telemetry for ``NNSpec.dyn_cap`` (``chamfer.dyn_cap_overflow_stats``):
    ``flags [B, N]`` bool dynamic masks (``mask & (dufo > 0)``) → (the
    largest count a sample, the cap, the share of samples above it).  A
    sample above the cap loses the f-term gradient of its extra dynamic
    points; the loss itself does not change."""
    if spec is None:
        spec = NNSpec(method="grid")
    cap = _dyn_cap_for(spec, n or flags.shape[-1])
    counts = flags.sum(-1)
    return counts.max(), cap, (counts > cap).float().mean()


def grid_overflow_stats(pts: torch.Tensor, mask: torch.Tensor,
                        spec: Optional[NNSpec] = None, capacity: int = 128):
    """How much a capacity-limited grid (the JAX package's XLA fallback,
    ``capacity`` candidates a cell, its ``NNSpec.capacity`` default 128)
    would drop on this cloud (``chamfer.grid_overflow_stats``): (dropped
    share of the valid points, share of cells over capacity among all
    cells, the largest cell count).  The port's cell sweep has no
    capacity; this measures the cloud, not a search."""
    if spec is None:
        spec = NNSpec(method="grid")
    if pts.dim() == 2:
        pts, mask = pts[None], mask[None]
    b, n, _ = pts.shape
    gx, gy = _grid_dims(spec)
    cells = gx * gy
    cx, cy = _bin2d(pts.reshape(b * n, 3), spec, gx, gy)
    sample = torch.arange(b * n, device=pts.device) // n
    ids = torch.where(mask.reshape(-1), sample * cells + cy * gx + cx, b * cells)
    counts = torch.bincount(ids, minlength=b * cells + 1)[:-1]
    over = (counts - capacity).clamp(min=0)
    total = mask.sum().clamp(min=1)
    return (over.sum() / total, ((counts > capacity) & (counts > 0)).float().mean(),
            counts.max())
