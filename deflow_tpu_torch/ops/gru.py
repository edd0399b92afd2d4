"""Fused iterative ConvGRU: the DeFlow decoder's hot loop, forward and backward.

``fused_gru`` launches ``csrc/fused_gru.cu`` and ``fused_gru_bwd`` launches
``csrc/fused_gru_bwd.cu`` on CUDA tensors; each takes its plain PyTorch
version (``fused_gru_plain``, ``fused_gru_bwd_plain``) only for CPU tensors.
``FusedGRU`` ties them into autograd.  Counterpart of
``deflow_tpu/ops/pallas_gru.py`` (``fused_gru`` with its custom VJP).

Numerics (as the Pallas kernels): matmul operands in the input dtype (bf16 or
f32) with f32 accumulation; biases, gates and the state h in f32 across all
iterations; one rounding to the input dtype at the end.  The backward
recomputes the forward from the saved inputs and returns every gradient in
its operand's dtype (a bf16 dW is rounded once, after the f32 sum).
"""

from __future__ import annotations

import ctypes

import torch

from deflow_tpu_torch.ops import _build

H = 128   # hidden width the kernel is specialised to (2 x 64 DeFlow channels)


def fused_gru_plain(h0, x, w_zr, b_zr, w_q, b_q, num_iters: int) -> torch.Tensor:
    """The unrolled loop.  bf16 operands are rounded, then multiplied in f32:
    products of bf16 values are exact in f32, so this is f32 accumulation."""
    mm = h0.dtype
    op = lambda t: t.to(mm).float()
    h = h0.float()
    xm = op(x)
    wzr, wq = op(w_zr), op(w_q)
    bzr, bq = b_zr.float(), b_q.float()
    for _ in range(num_iters):
        zr = torch.sigmoid(torch.cat([op(h), xm], -1) @ wzr + bzr)
        z, r = zr[:, :H], zr[:, H:]
        q = torch.tanh(torch.cat([op(r * h), xm], -1) @ wq + bq)
        h = (1.0 - z) * h + z * q
    return h.to(mm)


def _setup(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_gru.restype = i32
    lib.fused_gru.argtypes = [vp] * 6 + [i32, i32, i32, vp, i32, i32, vp]


def _check(h0, x, w_zr, b_zr, w_q, b_q):
    m, xdim = h0.shape[0], x.shape[-1]
    shapes = {"h0": (h0, (m, H)), "x": (x, (m, xdim)),
              "w_zr": (w_zr, (H + xdim, 2 * H)), "b_zr": (b_zr, (2 * H,)),
              "w_q": (w_q, (H + xdim, H)), "b_q": (b_q, (H,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected {want}")
        if t.dtype != h0.dtype or t.device != h0.device:
            raise ValueError(f"{name}: all operands share h0's dtype/device")
    if h0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {h0.dtype}: f32 or bf16 only")


def fused_gru(h0, x, w_zr, b_zr, w_q, b_q, num_iters: int) -> torch.Tensor:
    """h0 [M, 128], x [M, Xdim]; w_zr [128+Xdim, 256], b_zr [256],
    w_q [128+Xdim, 128], b_q [128], all of h0's dtype and device.  Returns h
    after ``num_iters`` GRU steps, in h0's dtype."""
    _check(h0, x, w_zr, b_zr, w_q, b_q)
    if h0.device.type == "cpu":
        return fused_gru_plain(h0, x, w_zr, b_zr, w_q, b_q, num_iters)
    if h0.device.type != "cuda":
        raise ValueError(f"unsupported device {h0.device}")
    m, xdim = h0.shape[0], x.shape[-1]
    bf16 = h0.dtype == torch.bfloat16
    # both kernels move h0, x, the weights and the output 16 bytes at a
    # time; the biases are read an element at a time
    aligned = ("h0", "x", "w_zr", "w_q")
    for name, t in (("h0", h0), ("x", x), ("w_zr", w_zr), ("b_zr", b_zr),
                    ("w_q", w_q), ("b_q", b_q)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if bf16 and (xdim % 16 or xdim > 64):
        raise ValueError("bf16 kernel: xdim % 16 == 0, xdim <= 64")
    if not bf16 and xdim > 128:
        raise ValueError("f32 kernel: xdim <= 128")
    lib = _build.load("fused_gru", _setup)
    out = torch.empty_like(h0)
    if out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(h0.device).multi_processor_count
    rc = lib.fused_gru(h0.data_ptr(), x.data_ptr(), w_zr.data_ptr(),
                       b_zr.data_ptr(), w_q.data_ptr(), b_q.data_ptr(),
                       m, xdim, num_iters, out.data_ptr(), int(bf16), sms,
                       _build.stream_ptr(h0))
    _build.check(lib, rc, "fused_gru")
    fused_gru.launches += 1
    return out


fused_gru.launches = 0


def fused_gru_bwd_plain(h0, x, w_zr, b_zr, w_q, b_q, g, num_iters: int):
    """The VJP of ``fused_gru_plain`` at ``g``, as the Pallas backward kernel
    computes it: the forward is recomputed with its per-iteration (h, z, r,
    q) kept, then walked in reverse.  Returns (dh0, dx, dw_zr, db_zr, dw_q,
    db_q), each in its operand's dtype."""
    mm = h0.dtype
    op = lambda t: t.to(mm).float()
    h = h0.float()
    xm = op(x)
    wzr, wq = op(w_zr), op(w_q)
    bzr, bq = b_zr.float(), b_q.float()
    saved = []
    for _ in range(num_iters):
        zr = torch.sigmoid(torch.cat([op(h), xm], -1) @ wzr + bzr)
        z, r = zr[:, :H], zr[:, H:]
        q = torch.tanh(torch.cat([op(r * h), xm], -1) @ wq + bq)
        saved.append((h, z, r, q))
        h = (1.0 - z) * h + z * q
    dh = g.float()
    dx = torch.zeros_like(xm)
    dwzr, dwq = torch.zeros_like(wzr), torch.zeros_like(wq)
    dbzr, dbq = torch.zeros_like(bzr), torch.zeros_like(bq)
    for h_in, z, r, q in reversed(saved):
        dz = dh * (q - h_in)
        dh_in = dh * (1.0 - z)
        ds_q = dh * z * (1.0 - q * q)
        u = torch.cat([op(r * h_in), xm], -1)
        dwq += u.t() @ op(ds_q)
        dbq += ds_q.sum(0)
        du = op(ds_q) @ wq.t()
        drh = du[:, :H]
        dx += du[:, H:]
        dh_in += drh * r
        ds_zr = torch.cat([dz * z * (1.0 - z), drh * h_in * r * (1.0 - r)], -1)
        hx = torch.cat([op(h_in), xm], -1)
        dwzr += hx.t() @ op(ds_zr)
        dbzr += ds_zr.sum(0)
        dhx = op(ds_zr) @ wzr.t()
        dh_in += dhx[:, :H]
        dx += dhx[:, H:]
        dh = dh_in
    return (dh.to(h0.dtype), dx.to(x.dtype), dwzr.to(w_zr.dtype),
            dbzr.to(b_zr.dtype), dwq.to(w_q.dtype), dbq.to(b_q.dtype))


def _setup_bwd(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_gru_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.fused_gru_bwd_scratch_bytes.argtypes = [i32, i32, i32, i32]
    lib.fused_gru_bwd.restype = i32
    lib.fused_gru_bwd.argtypes = [vp] * 7 + [i32, i32, i32] + [vp] * 7 + [i32, vp]


def fused_gru_bwd(h0, x, w_zr, b_zr, w_q, b_q, g, num_iters: int):
    """Gradients of ``fused_gru`` at the output cotangent ``g [M, 128]``:
    (dh0, dx, dw_zr, db_zr, dw_q, db_q) in the operands' dtypes."""
    if tuple(g.shape) != tuple(h0.shape) or g.dtype != h0.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype}: h0's shape and dtype")
    _check(h0, x, w_zr, b_zr, w_q, b_q)
    if h0.device.type == "cpu":
        return fused_gru_bwd_plain(h0, x, w_zr, b_zr, w_q, b_q, g, num_iters)
    if h0.device.type != "cuda":
        raise ValueError(f"unsupported device {h0.device}")
    m, xdim = h0.shape[0], x.shape[-1]
    bf16 = h0.dtype == torch.bfloat16
    for name, t in (("h0", h0), ("x", x), ("w_zr", w_zr), ("b_zr", b_zr),
                    ("w_q", w_q), ("b_q", b_q), ("g", g)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if xdim % 16 or xdim > 64:
        raise ValueError("GRU backward kernel: xdim % 16 == 0, xdim <= 64")
    if num_iters < 0 or num_iters * m >= 2 ** 31:
        raise ValueError(f"num_iters {num_iters} x M {m}: 0 <= product < 2^31")
    lib = _build.load("fused_gru_bwd", _setup_bwd)
    nbytes = lib.fused_gru_bwd_scratch_bytes(m, xdim, num_iters, int(bf16))
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=h0.device)
    dh0, dx = torch.empty_like(h0), torch.empty_like(x)
    dwzr, dbzr = torch.empty_like(w_zr), torch.empty_like(b_zr)
    dwq, dbq = torch.empty_like(w_q), torch.empty_like(b_q)
    rc = lib.fused_gru_bwd(
        h0.data_ptr(), x.data_ptr(), w_zr.data_ptr(), b_zr.data_ptr(),
        w_q.data_ptr(), b_q.data_ptr(), g.data_ptr(), m, xdim, num_iters,
        dh0.data_ptr(), dx.data_ptr(), dwzr.data_ptr(), dbzr.data_ptr(),
        dwq.data_ptr(), dbq.data_ptr(), scratch.data_ptr(), int(bf16),
        _build.stream_ptr(h0))
    _build.check(lib, rc, "fused_gru_bwd")
    fused_gru_bwd.launches += 1
    return dh0, dx, dwzr, dbzr, dwq, dbq


fused_gru_bwd.launches = 0


class FusedGRU(torch.autograd.Function):
    """``fused_gru`` with its backward kernel.  Saves only the inputs: the
    backward recomputes the forward, as the Pallas VJP does."""

    @staticmethod
    def forward(ctx, h0, x, w_zr, b_zr, w_q, b_q, num_iters: int):
        ctx.num_iters = num_iters
        ctx.save_for_backward(h0, x, w_zr, b_zr, w_q, b_q)
        return fused_gru(h0, x, w_zr, b_zr, w_q, b_q, num_iters)

    @staticmethod
    def backward(ctx, g):
        return (*fused_gru_bwd(*ctx.saved_tensors, g.contiguous(),
                               ctx.num_iters), None)
