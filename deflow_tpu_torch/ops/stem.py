"""The U-Net encoder's k8/s2/p3 stem convolutions over the space-to-depth view.

``stem_conv`` is the stem under autograd: ``x [N, H, W, C]`` channels-last
(contiguous), the conv's f32 ``weight [O, C, 8, 8]`` and ``bias [O]``; it
returns ``y [N, H/2, W/2, O]`` in x's dtype, and in the backward dx in x's
dtype and the weight and bias gradients in f32.  ``stem_fwd``,
``stem_dgrad`` and ``stem_wgrad`` launch ``csrc/stem.cu`` on CUDA tensors
(bf16 only) and take their plain PyTorch versions (``*_plain``) only for
CPU tensors.  The JAX package leaves these convolutions to XLA: no Pallas
kernel is replaced.

The algebra (the plain versions compute it as written): with X padded by 3
and the taps written u = 2a + p, v = 2b + q, the stem is a valid 4x4
stride-1 convolution of S = s2d(Xp) ``[N, 4C, (H+6)/2, (W+6)/2]``, channel
e = (p, q, c), by W'[o, e, a, b] = W[o, c, 2a+p, 2b+q].  Its input
gradient is a full 4x4 correlation of dY with W' flipped and transposed,
taken back through d2s with the padding cropped; its weight gradient is
the correlation of S with dY, taken back to [O, C, 8, 8].

Numerics: operands are rounded to x's dtype (the weight too), products
and sums are f32, y and dx are rounded once to x's dtype, the bias is added
in f32 before that rounding.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deflow_tpu_torch.ops import _build


def s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """W [O, C, 8, 8] → W' [O, 4C, 4, 4], e = (p, q, c)."""
    o, c = w.shape[:2]
    return w.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)


def d2s_weight(wp: torch.Tensor) -> torch.Tensor:
    """W' [O, 4C, 4, 4] → W [O, C, 8, 8] (the inverse of :func:`s2d_weight`)."""
    o, c = wp.shape[0], wp.shape[1] // 4
    return wp.reshape(o, 2, 2, c, 4, 4).permute(0, 3, 4, 1, 5, 2).reshape(o, c, 8, 8)


def _s2d(x: torch.Tensor) -> torch.Tensor:
    """NHWC x → S = s2d(pad(x, 3)) in NCHW, [N, 4C, (H+6)/2, (W+6)/2]."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 3, 3, 3, 3))
    s = xp.reshape(n, (h + 6) // 2, 2, (w + 6) // 2, 2, c).permute(0, 2, 4, 5, 1, 3)
    return s.reshape(n, 4 * c, (h + 6) // 2, (w + 6) // 2)


def stem_fwd_plain(x, weight, bias):
    """y [N, H/2, W/2, O] = conv4x4(S, W') + bias."""
    wp = s2d_weight(weight.to(x.dtype).float())
    y = F.conv2d(_s2d(x.float()), wp, bias.float())
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def stem_dgrad_plain(dy, weight, h: int, w: int):
    """dx [N, H, W, C]: dS = conv4x4(pad(dY, 3), W' flipped, transposed), then
    d2s with the padding cropped."""
    wp = s2d_weight(weight.to(dy.dtype).float())
    ds = F.conv2d(F.pad(dy.float().permute(0, 3, 1, 2), (3, 3, 3, 3)),
                  wp.flip(2, 3).transpose(0, 1))
    n, c4, hs, ws = ds.shape
    dxp = ds.reshape(n, 2, 2, c4 // 4, hs, ws).permute(0, 4, 1, 5, 2, 3)
    dxp = dxp.reshape(n, 2 * hs, 2 * ws, c4 // 4)
    return dxp[:, 3:3 + h, 3:3 + w].to(dy.dtype).contiguous()


def stem_wgrad_plain(x, dy):
    """(dw [O, C, 8, 8], db [O]) in f32: dW' = corr(S, dY), back to [O, C, 8, 8]."""
    o, c = dy.shape[-1], x.shape[-1]
    d = dy.float().permute(0, 3, 1, 2)
    dwp = torch.nn.grad.conv2d_weight(_s2d(x.float()), (o, 4 * c, 4, 4), d)
    return d2s_weight(dwp).contiguous(), d.sum((0, 2, 3))


def _setup(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stem_fwd.restype = i32
    lib.stem_fwd.argtypes = [vp] * 3 + [i32] * 5 + [vp, vp]
    lib.stem_dgrad.restype = i32
    lib.stem_dgrad.argtypes = [vp] * 2 + [i32] * 5 + [vp, vp]
    lib.stem_wgrad_scratch_bytes.restype = ctypes.c_longlong
    lib.stem_wgrad_scratch_bytes.argtypes = [i32] * 5
    lib.stem_wgrad.restype = i32
    lib.stem_wgrad.argtypes = [vp] * 2 + [i32] * 5 + [vp] * 3


def _check_act(name, t, dims=None):
    if t.dim() != 4 or (dims is not None and tuple(t.shape) != dims):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {dims or 'NHWC'}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC")


def _check_even(h, w):
    if h % 2 or w % 2:
        raise ValueError(f"the stem takes even maps, got {h}x{w}")


def _check_weight(weight, c, dev):
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (c, 8, 8):
        raise ValueError(f"weight {tuple(weight.shape)}, expected [O, {c}, 8, 8]")
    if weight.device != dev:
        raise ValueError("weight: the device of x")


def _kernel_inputs(t, c, o):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"stem kernels: bf16 only, got {t.dtype}")
    if c % 16 or o % 64:
        raise ValueError(f"stem kernels: C % 16 and O % 64, got C {c}, O {o}")


def _fwd_taps(weight):
    """[16 (a, b)][O][4C] bf16 for the forward kernel."""
    o, c = weight.shape[:2]
    wp = s2d_weight(weight.to(torch.bfloat16))
    return wp.permute(2, 3, 0, 1).reshape(16, o, 4 * c).contiguous()


def _dgrad_taps(weight):
    """[16 (3 - a, 3 - b)][4C][O] bf16 for the dgrad kernel."""
    o, c = weight.shape[:2]
    wp = s2d_weight(weight.to(torch.bfloat16)).flip(2, 3)
    return wp.permute(2, 3, 1, 0).reshape(16, 4 * c, o).contiguous()


def stem_fwd(x, weight, bias):
    """y [N, H/2, W/2, O] in x's dtype from ``x [N, H, W, C]``, ``weight [O,
    C, 8, 8]`` and ``bias [O]``."""
    _check_act("x", x)
    n, h, w, c = x.shape
    _check_even(h, w)
    _check_weight(weight, c, x.device)
    o = weight.shape[0]
    if tuple(bias.shape) != (o,) or bias.device != x.device:
        raise ValueError(f"bias {tuple(bias.shape)}, expected [{o}] on x's device")
    if x.device.type == "cpu":
        return stem_fwd_plain(x, weight, bias)
    _kernel_inputs(x, c, o)
    lib = _build.load("stem", _setup)
    wt, b32 = _fwd_taps(weight), bias.float().contiguous()
    y = torch.empty(n, h // 2, w // 2, o, dtype=x.dtype, device=x.device)
    rc = lib.stem_fwd(x.data_ptr(), wt.data_ptr(), b32.data_ptr(), n, h, w, c, o,
                      y.data_ptr(), _build.stream_ptr(x))
    _build.check(lib, rc, "stem_fwd")
    stem_fwd.launches += 1
    return y


stem_fwd.launches = 0


def stem_dgrad(dy, weight, h: int, w: int):
    """dx [N, H, W, C] in dy's dtype from ``dy [N, H/2, W/2, O]``."""
    _check_act("dy", dy)
    _check_even(h, w)
    n, o = dy.shape[0], dy.shape[-1]
    c = weight.shape[1] if weight.dim() == 4 else -1
    _check_weight(weight, c, dy.device)
    if weight.shape[0] != o or (h, w) != (2 * dy.shape[1], 2 * dy.shape[2]):
        raise ValueError(f"dy {tuple(dy.shape)} does not fit weight "
                         f"{tuple(weight.shape)} at {h}x{w}")
    if dy.device.type == "cpu":
        return stem_dgrad_plain(dy, weight, h, w)
    _kernel_inputs(dy, c, o)
    lib = _build.load("stem", _setup)
    wt = _dgrad_taps(weight)
    dx = torch.empty(n, h, w, c, dtype=dy.dtype, device=dy.device)
    rc = lib.stem_dgrad(dy.data_ptr(), wt.data_ptr(), n, h, w, c, o, dx.data_ptr(),
                        _build.stream_ptr(dy))
    _build.check(lib, rc, "stem_dgrad")
    stem_dgrad.launches += 1
    return dx


stem_dgrad.launches = 0


def stem_wgrad(x, dy):
    """(dw [O, C, 8, 8], db [O]) in f32 from ``x [N, H, W, C]`` and ``dy [N,
    H/2, W/2, O]``."""
    _check_act("x", x)
    n, h, w, c = x.shape
    _check_even(h, w)
    o = dy.shape[-1]
    _check_act("dy", dy, (n, h // 2, w // 2, o))
    if dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("dy: the dtype and device of x")
    if x.device.type == "cpu":
        return stem_wgrad_plain(x, dy)
    _kernel_inputs(x, c, o)
    lib = _build.load("stem", _setup)
    scratch = torch.empty(lib.stem_wgrad_scratch_bytes(n, h, w, c, o), dtype=torch.uint8,
                          device=x.device)
    out = torch.empty(16 * 4 * c * o + o, device=x.device)
    rc = lib.stem_wgrad(x.data_ptr(), dy.data_ptr(), n, h, w, c, o, scratch.data_ptr(),
                        out.data_ptr(), _build.stream_ptr(x))
    _build.check(lib, rc, "stem_wgrad")
    stem_wgrad.launches += 1
    dwp = out[:-o].view(4, 4, 4 * c, o).permute(3, 2, 0, 1)
    return d2s_weight(dwp).contiguous(), out[-o:].clone()


stem_wgrad.launches = 0


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return stem_fwd(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = stem_dgrad(dy, weight, x.shape[1], x.shape[2])
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = stem_wgrad(x, dy)
        return dx, dw, db


def stem_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The k8/s2/p3 convolution of ``x [N, H, W, C]`` (channels-last,
    contiguous, H and W even) by ``weight [O, C, 8, 8]`` and ``bias [O]``
    under autograd: y [N, H/2, W/2, O] in x's dtype."""
    return _StemConv.apply(x, weight, bias)
