"""Cell sweep: the grid nearest-neighbour search over cell-sorted clouds.

``cell_sweep`` launches ``csrc/cell_sweep.cu`` on CUDA tensors and takes the
plain PyTorch version, ``cell_sweep_plain``, only for CPU tensors.
Counterpart of ``deflow_tpu/ops/pallas_sweep.py`` (``cell_sweep_pallas``),
with its contract; ``ops/chamfer.py`` ``_sweep_call`` builds the inputs.

Contract:
    q_slab [NQ_pad, 8] f32, NQ_pad a multiple of CHUNK_Q: sorted queries,
        lanes (x, y, z, w, ...); w = sample·wstep, +2e19 for masked and
        padding rows.
    c_slab [NCC, 8, CHUNK_C] f32: sorted candidates as coordinate-major
        planes (x, y, z, w, fpen, orig_row, 0, 0); padding rows carry +2e19
        coordinates, w = −2e19 and orig_row = −1; fpen = 0 on flagged rows,
        else 3e38.
    cs, cn [NQ_pad/CHUNK_Q, 3] int32: per query chunk, the first candidate
        block and the block count of each of its three ring-row windows.
    dirty [NQ_pad/CHUNK_Q] int32: 1 where the windows may hold another
        sample's rows (only there is the w term added); None = all dirty.
Returns [NQ_pad, 8] f32 lanes (d_all, i_all, d_flag, i_flag, 0, 0, 0, 0):
the squared distance to the nearest candidate (3e38 when none) and its
orig_row (−1 when none), over all candidates and, with ``dual``, over the
flagged ones (else 3e38, −1).  Blocks are scanned window by window in
ascending order; within a block the largest orig_row among the rows at the
block minimum wins, and a later block wins only when strictly smaller.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deflow_tpu_torch.ops import _build

CHUNK_Q = 256   # queries per chunk
CHUNK_C = 512   # candidate rows per block
PIECE_BLOCKS = 2   # the kernel's cut: candidate blocks per piece of a chunk
_BIG = 3.0e38
_CX, _CY, _CZ, _CW, _CFPEN, _CORIG = range(6)


def _block_best(d: torch.Tensor, crow: torch.Tensor):
    """Per query and block: the minimum of ``d [Q, nb, C]`` and the largest
    ``crow [nb, C]`` among the rows that reach it."""
    m = d.amin(-1)
    i = torch.where(d <= m[..., None], crow, -1.0).amax(-1)
    return m, i


def cell_sweep_plain(q_slab: torch.Tensor, c_slab: torch.Tensor,
                     cs: torch.Tensor, cn: torch.Tensor,
                     dirty: Optional[torch.Tensor] = None,
                     dual: bool = True) -> torch.Tensor:
    """The same reduction in PyTorch: chunk by chunk, vectorised over the
    chunk's queries and blocks; one rounding per operation, as the kernel."""
    nq = q_slab.shape[0]
    nchunks, ncc = nq // CHUNK_Q, c_slab.shape[0]
    out = torch.zeros(nq, 8, dtype=torch.float32, device=q_slab.device)
    out[:, 0] = out[:, 2] = _BIG
    out[:, 1] = out[:, 3] = -1.0
    starts, counts = cs.tolist(), cn.tolist()
    dirt = [1] * nchunks if dirty is None else dirty.tolist()
    for k in range(nchunks):
        blocks = [b for j in range(3)
                  for b in range(starts[k][j], starts[k][j] + counts[k][j])
                  if 0 <= b < ncc]
        if not blocks:
            continue
        cb = c_slab[torch.tensor(blocks, device=c_slab.device)]   # [nb, 8, C]
        q = q_slab[k * CHUNK_Q:(k + 1) * CHUNK_Q]
        dx = q[:, _CX, None, None] - cb[None, :, _CX]
        dy = q[:, _CY, None, None] - cb[None, :, _CY]
        dz = q[:, _CZ, None, None] - cb[None, :, _CZ]
        d = dx * dx + dy * dy + dz * dz
        if dirt[k] > 0:
            dw = q[:, _CW, None, None] - cb[None, :, _CW]
            d = d + dw * dw
        lanes = [_block_best(d, cb[:, _CORIG])]
        if dual:
            lanes.append(_block_best(d + cb[None, :, _CFPEN], cb[:, _CORIG]))
        rows = out[k * CHUNK_Q:(k + 1) * CHUNK_Q]
        for lane, (m, i) in enumerate(lanes):
            best, bi = rows[:, 2 * lane].clone(), rows[:, 2 * lane + 1].clone()
            for b in range(len(blocks)):
                take = m[:, b] < best
                best = torch.where(take, m[:, b], best)
                bi = torch.where(take, i[:, b], bi)
            rows[:, 2 * lane], rows[:, 2 * lane + 1] = best, bi
    return out


def _setup(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cell_sweep.restype = i32
    lib.cell_sweep.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, vp, vp, vp]
    lib.cell_sweep_workspace.restype = i32
    lib.cell_sweep_workspace.argtypes = [i32]


def cell_sweep(q_slab: torch.Tensor, c_slab: torch.Tensor, cs: torch.Tensor,
               cn: torch.Tensor, dirty: Optional[torch.Tensor] = None,
               dual: bool = True) -> torch.Tensor:
    """The sweep over the module's contract; [NQ_pad, 8] f32."""
    nq = q_slab.shape[0]
    nchunks = nq // CHUNK_Q
    if (q_slab.dim() != 2 or q_slab.shape[1] != 8 or nq % CHUNK_Q
            or c_slab.dim() != 3 or tuple(c_slab.shape[1:]) != (8, CHUNK_C)):
        raise ValueError(f"q_slab {tuple(q_slab.shape)} / c_slab "
                         f"{tuple(c_slab.shape)}")
    if q_slab.dtype != torch.float32 or c_slab.dtype != torch.float32:
        raise ValueError("q_slab and c_slab must be f32")
    if dirty is None:
        dirty = torch.ones(nchunks, dtype=torch.int32, device=q_slab.device)
    for name, t, shape in (("cs", cs, (nchunks, 3)), ("cn", cn, (nchunks, 3)),
                           ("dirty", dirty, (nchunks,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if any(t.device != q_slab.device for t in (c_slab, cs, cn, dirty)):
        raise ValueError("all inputs must be on one device")
    if q_slab.device.type == "cpu":
        return cell_sweep_plain(q_slab, c_slab, cs, cn, dirty, dual)
    if q_slab.device.type != "cuda":
        raise ValueError(f"unsupported device {q_slab.device}")
    if not all(t.is_contiguous() for t in (q_slab, c_slab, cs, cn, dirty)):
        raise ValueError("inputs must be contiguous")
    if q_slab.data_ptr() % 16:
        raise ValueError("q_slab must be 16-byte aligned")
    lib = _build.load("cell_sweep", _setup)
    out = torch.empty(nq, 8, dtype=torch.float32, device=q_slab.device)
    # the piece table, work counter and per-chunk merge counters and locks:
    # the kernel's first launch fills them, so any contents will do
    ws = torch.empty(lib.cell_sweep_workspace(nchunks), dtype=torch.int32,
                     device=q_slab.device)
    rc = lib.cell_sweep(q_slab.data_ptr(), c_slab.data_ptr(), cs.data_ptr(),
                        cn.data_ptr(), dirty.data_ptr(), nchunks,
                        c_slab.shape[0], int(bool(dual)), PIECE_BLOCKS,
                        ws.data_ptr(), out.data_ptr(), _build.stream_ptr(q_slab))
    _build.check(lib, rc, "cell_sweep")
    cell_sweep.launches += 1
    return out


cell_sweep.launches = 0
