"""Fused iterative ConvGRU forward: the DeFlow decoder's hot loop.

``fused_gru`` launches ``csrc/fused_gru.cu`` on CUDA tensors and takes the
plain PyTorch version, ``fused_gru_plain``, only for CPU tensors.
Counterpart of ``deflow_tpu/ops/pallas_gru.py`` (``fused_gru``, forward).

Numerics (as the Pallas kernel): matmul operands in the input dtype (bf16 or
f32) with f32 accumulation; biases, gates and the state h in f32 across all
iterations; one rounding to the input dtype at the end.
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


def fused_gru(h0, x, w_zr, b_zr, w_q, b_q, num_iters: int) -> torch.Tensor:
    """h0 [M, 128], x [M, Xdim]; w_zr [128+Xdim, 256], b_zr [256],
    w_q [128+Xdim, 128], b_q [128], all of h0's dtype and device.  Returns h
    after ``num_iters`` GRU steps, in h0's dtype."""
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
    if h0.device.type == "cpu":
        return fused_gru_plain(h0, x, w_zr, b_zr, w_q, b_q, num_iters)
    if h0.device.type != "cuda":
        raise ValueError(f"unsupported device {h0.device}")
    bf16 = h0.dtype == torch.bfloat16
    for name, (t, _) in shapes.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bf16 and (xdim % 16 or xdim > 64
                 or w_zr.data_ptr() % 16 or w_q.data_ptr() % 16):
        raise ValueError("bf16 kernel: xdim % 16 == 0, xdim <= 64, "
                         "16-byte aligned weights")
    if not bf16 and xdim > 128:
        raise ValueError("f32 kernel: xdim <= 128")
    lib = _build.load("fused_gru", _setup)
    out = torch.empty_like(h0)
    sms = torch.cuda.get_device_properties(h0.device).multi_processor_count
    rc = lib.fused_gru(h0.data_ptr(), x.data_ptr(), w_zr.data_ptr(),
                       b_zr.data_ptr(), w_q.data_ptr(), b_q.data_ptr(),
                       m, xdim, num_iters, out.data_ptr(), int(bf16), sms,
                       _build.stream_ptr(h0))
    _build.check(lib, rc, "fused_gru")
    fused_gru.launches += 1
    return out


fused_gru.launches = 0
