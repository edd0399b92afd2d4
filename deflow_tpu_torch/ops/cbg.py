"""Fused conv3x3 + BatchNorm(train) + GELU chains of the U-Net encoder.

``cbg_block_fwd`` and ``cbg_block_bwd`` launch ``csrc/cbg.cu`` on CUDA
tensors and take their plain PyTorch versions (``*_plain``) only for CPU
tensors.  ``cbg_chain`` strings blocks together under autograd: the chain
passes only the pre-BN conv outputs ``s_i`` between blocks, and each block
applies the previous block's BN + GELU on load.  Counterpart of
``deflow_tpu/ops/pallas_cbg.py`` (``cbg_block_fwd``, ``cbg_block_bwd``,
``cbg_chain``).

Layout: channels-last ``[B, H, W, C]`` in the compute dtype (bf16 or f32),
contiguous, without the Pallas guard rows or lane padding.  Weights
``[3, 3, C, O]`` (HWIO) and bias ``[O]`` in the compute dtype; BN scale and
shift in f32.

Numerics (as the Pallas chain): BN batch statistics come from per-block
partial Σ and Σ² of the conv output ROUNDED to the compute dtype, reduced in
f32, with the fast variance E[x²] − E[x]²; the matmul operands (the BN+GELU
activation, ds) are rounded to the compute dtype; BN and GELU run in f32 with
the exact (erf) GELU.  Finalising mean, var, istd and the backward's A/B
vectors is [C]-sized work in plain torch, as the JAX chain leaves it to XLA.

Under a process group the BN statistics are the global batch's: the head's
[Σx, Σx²] and each block's partial sums are summed over ranks in the
forward, the top block's [Σdz, Σdz·ẑ] and each block's partial
[Σdz_prev, Σdz_prev·ẑ_prev] in the backward (for the BN backward; the BN
parameters' gradients take this rank's own sums, which the step then sums
over ranks), and n is W·B·H·W (every rank runs the same per-card shape).
The kernels do not change.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deflow_tpu_torch import dist
from deflow_tpu_torch.ops import _build

S_MEAN, S_ISTD, S_GAMMA, S_BETA, S_A, S_B = range(6)
N_SCAL = 6
MAX_CHANNELS = 256          # the kernels stream channels past 128 in chunks of 128
_SQRT1_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx gelu(x) = Φ(x) + x·φ(x)."""
    return (0.5 * (1.0 + torch.erf(x * math.sqrt(0.5)))
            + x * torch.exp(-0.5 * x * x) * _SQRT1_2PI)


def bn_apply(x: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    return (x - scal[S_MEAN]) * scal[S_ISTD] * scal[S_GAMMA] + scal[S_BETA]


def scal_slab(mean, istd, gamma, beta, a=None, b=None) -> torch.Tensor:
    """[N_SCAL, C] f32 BN-scalar slab (mean, istd, gamma, beta, A, B)."""
    z = torch.zeros_like(mean)
    return torch.stack([mean, istd, gamma.float(), beta.float(),
                        z if a is None else a, z if b is None else b]).contiguous()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def cbg_block_fwd_plain(x, wmat, bias, scal=None):
    """(s [B, H, W, O], partial sums [1, 2, O] f32)."""
    dt = x.dtype
    u = x.float()
    if scal is not None:
        u = F.gelu(bn_apply(u, scal))
    u = u.to(dt).float()
    s = F.conv2d(_nchw(u), wmat.float().permute(3, 2, 0, 1), padding=1)
    s = (s + bias.float()[None, :, None, None]).permute(0, 2, 3, 1).to(dt)
    sf = s.float()
    ps = torch.stack([sf.sum((0, 1, 2)), (sf * sf).sum((0, 1, 2))])[None]
    return s.contiguous(), ps


def cbg_block_bwd_plain(dz, si, sp, wmat, scal_in, scal_out=None):
    """(dz_prev [B, H, W, C], dW [3, 3, C, O] f32, db partials [1, O] f32,
    partial Σdz_prev / Σdz_prev·ẑ_prev [1, 2, C] f32)."""
    dt = dz.dtype
    zh = (si.float() - scal_in[S_MEAN]) * scal_in[S_ISTD]
    ds = (scal_in[S_GAMMA] * scal_in[S_ISTD]
          * (dz.float() - scal_in[S_A] - zh * scal_in[S_B]))
    ds = ds.to(dt).float()
    if scal_out is not None:
        zp = bn_apply(sp.float(), scal_out)
        xa = F.gelu(zp)
    else:
        xa = sp.float()
    xa = xa.to(dt).float()
    w = wmat.float().permute(3, 2, 0, 1)
    dx = torch.nn.grad.conv2d_input(_nchw(xa).shape, w, _nchw(ds),
                                    padding=1).permute(0, 2, 3, 1)
    dw = torch.nn.grad.conv2d_weight(_nchw(xa), w.shape, _nchw(ds),
                                     padding=1).permute(2, 3, 1, 0)
    db = ds.sum((0, 1, 2))[None]
    if scal_out is not None:
        dzp = dx * gelu_grad(zp)
        zph = (sp.float() - scal_out[S_MEAN]) * scal_out[S_ISTD]
        psp = torch.stack([dzp.sum((0, 1, 2)), (dzp * zph).sum((0, 1, 2))])[None]
    else:
        dzp = dx
        psp = torch.zeros(1, 2, sp.shape[-1], device=sp.device)
    return dzp.to(dt).contiguous(), dw.contiguous(), db, psp


def _setup(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cbg_fwd_blocks.restype = i32
    lib.cbg_fwd_blocks.argtypes = [i32] * 5
    lib.cbg_bwd_blocks.restype = i32
    lib.cbg_bwd_blocks.argtypes = [i32] * 5
    lib.cbg_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.cbg_bwd_scratch_bytes.argtypes = [i32] * 6
    lib.cbg_fwd.restype = i32
    lib.cbg_fwd.argtypes = [vp] * 4 + [i32] * 5 + [vp, vp, i32, vp]
    lib.cbg_bwd.restype = i32
    lib.cbg_bwd.argtypes = [vp] * 6 + [i32] * 5 + [vp] * 5 + [i32, vp]


def _check_act(name, t, dtype, device, shape=None):
    if t.dim() != 4 or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape or 'NHWC'}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: the compute dtype and device of the block")


def _check_scal(name, scal, c, device):
    if scal is None:
        return
    if tuple(scal.shape) != (N_SCAL, c) or scal.dtype != torch.float32:
        raise ValueError(f"{name} must be [{N_SCAL}, {c}] f32")
    if scal.device != device:
        raise ValueError(f"{name}: the device of the block")


def _kernel_inputs(dev, tensors):
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def cbg_block_fwd(x, wmat, bias, scal: Optional[torch.Tensor] = None):
    """One block forward: ``x [B, H, W, C]`` (the previous block's pre-BN
    output, or the chain input), ``wmat [3, 3, C, O]``, ``bias [O]``, ``scal``
    the input-side BN slab ``[6, C]`` f32 or None.  Returns (s [B, H, W, O]
    in x's dtype, partial [Σs, Σs²] sums [blocks, 2, O] f32)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {x.dtype}: f32 or bf16 only")
    _check_act("x", x, x.dtype, x.device)
    b, h, w, c = x.shape
    o = wmat.shape[-1]
    if tuple(wmat.shape) != (3, 3, c, o) or tuple(bias.shape) != (o,):
        raise ValueError(f"wmat {tuple(wmat.shape)} / bias {tuple(bias.shape)}")
    for t in (wmat, bias):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("wmat and bias: the dtype and device of x")
    _check_scal("scal", scal, c, x.device)
    if x.device.type == "cpu":
        return cbg_block_fwd_plain(x, wmat, bias, scal)
    _kernel_inputs(x.device, {"x": x, "wmat": wmat, "bias": bias, "scal": scal})
    if max(c, o) > MAX_CHANNELS:
        raise ValueError(f"CBG kernel: at most {MAX_CHANNELS} channels")
    lib = _build.load("cbg", _setup)
    bf16 = int(x.dtype == torch.bfloat16)
    s = torch.empty(b, h, w, o, dtype=x.dtype, device=x.device)
    ps = torch.empty(lib.cbg_fwd_blocks(b, h, w, c, bf16), 2, o, device=x.device)
    rc = lib.cbg_fwd(x.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
                     None if scal is None else scal.data_ptr(), b, h, w, c, o,
                     s.data_ptr(), ps.data_ptr(), bf16, _build.stream_ptr(x))
    _build.check(lib, rc, "cbg_fwd")
    cbg_block_fwd.launches += 1
    return s, ps


cbg_block_fwd.launches = 0


def cbg_block_bwd(dz, si, sp, wmat, scal_in, scal_out: Optional[torch.Tensor] = None):
    """One block backward.  ``dz [B, H, W, O]``: dL/dz_i before the BN
    correction; ``si``: this block's pre-BN output; ``sp [B, H, W, C]``: the
    previous block's pre-BN output (or the chain input); ``scal_in [6, O]``
    this block's BN slab with A = Σdz/n, B = Σdz·ẑ/n; ``scal_out [6, C]`` the
    previous block's slab, or None at a chain head without input BN.
    Returns (dz_prev [B, H, W, C] in dz's dtype, dW [3, 3, C, O] f32,
    db partials [blocks, O] f32, partial [Σdz_prev, Σdz_prev·ẑ_prev]
    [blocks, 2, C] f32)."""
    if dz.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {dz.dtype}: f32 or bf16 only")
    _check_act("dz", dz, dz.dtype, dz.device)
    b, h, w, o = dz.shape
    c = sp.shape[-1]
    _check_act("si", si, dz.dtype, dz.device, (b, h, w, o))
    _check_act("sp", sp, dz.dtype, dz.device, (b, h, w, c))
    if tuple(wmat.shape) != (3, 3, c, o) or wmat.dtype != dz.dtype:
        raise ValueError(f"wmat {tuple(wmat.shape)} {wmat.dtype}")
    _check_scal("scal_in", scal_in, o, dz.device)
    _check_scal("scal_out", scal_out, c, dz.device)
    if dz.device.type == "cpu":
        return cbg_block_bwd_plain(dz, si, sp, wmat, scal_in, scal_out)
    _kernel_inputs(dz.device, {"dz": dz, "si": si, "sp": sp, "wmat": wmat,
                               "scal_in": scal_in, "scal_out": scal_out})
    if max(c, o) > MAX_CHANNELS:
        raise ValueError(f"CBG kernel: at most {MAX_CHANNELS} channels")
    lib = _build.load("cbg", _setup)
    bf16 = int(dz.dtype == torch.bfloat16)
    nblk = lib.cbg_bwd_blocks(b, h, w, c, bf16)
    dzp = torch.empty(b, h, w, c, dtype=dz.dtype, device=dz.device)
    dw = torch.empty(3, 3, c, o, device=dz.device)
    db = torch.empty(nblk, o, device=dz.device)
    psp = torch.empty(nblk, 2, c, device=dz.device)
    scratch = torch.empty(lib.cbg_bwd_scratch_bytes(b, h, w, c, o, bf16),
                          dtype=torch.uint8, device=dz.device)
    rc = lib.cbg_bwd(dz.data_ptr(), si.data_ptr(), sp.data_ptr(), wmat.data_ptr(),
                     scal_in.data_ptr(),
                     None if scal_out is None else scal_out.data_ptr(),
                     b, h, w, c, o, dzp.data_ptr(), dw.data_ptr(), db.data_ptr(),
                     psp.data_ptr(), scratch.data_ptr(), bf16, _build.stream_ptr(dz))
    _build.check(lib, rc, "cbg_bwd")
    cbg_block_bwd.launches += 1
    return dzp, dw, db, psp


cbg_block_bwd.launches = 0


def _stats(tot: torch.Tensor, n: int, eps: float):
    mean = tot[0] / n
    var = tot[1] / n - mean * mean
    return mean, var, torch.rsqrt(var + eps)


class _Chain(torch.autograd.Function):
    """The chain with its hand-written VJP (``pallas_cbg._chain_fwd`` /
    ``_chain_bwd``).  Outputs: y, then the batch means and variances (head
    first), which carry no gradient."""

    @staticmethod
    def forward(ctx, eps, nb, has_head, x, *flat):
        params = [flat[4 * i:4 * i + 4] for i in range(nb)]
        b, h, w, _ = x.shape
        n = b * h * w * dist.world()
        means, variances, istds, s_list = [], [], [], []
        if has_head:
            g0, b0 = flat[4 * nb:4 * nb + 2]
            xf = x.float()
            mean0, var0, istd0 = _stats(dist.all_reduce_(
                torch.stack([xf.sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))])), n, eps)
            scal = scal_slab(mean0, istd0, g0, b0)
            head_stats = [mean0, istd0]
            means.append(mean0)
            variances.append(var0)
        else:
            scal, head_stats = None, []
        s_prev = x
        for wm, bi, ga, be in params:
            s, ps = cbg_block_fwd(s_prev, wm, bi, scal)
            mean, var, istd = _stats(dist.all_reduce_(ps.sum(0)), n, eps)
            scal = scal_slab(mean, istd, ga, be)
            s_list.append(s)
            means.append(mean)
            variances.append(var)
            istds.append(istd)
            s_prev = s
        y = F.gelu(bn_apply(s_prev.float(), scal)).to(x.dtype)
        ctx.eps, ctx.nb, ctx.has_head = eps, nb, has_head
        ctx.save_for_backward(x, *s_list, *istds, *means[int(has_head):],
                              *head_stats, *flat)
        ctx.mark_non_differentiable(*means, *variances)
        return (y, *means, *variances)

    @staticmethod
    def backward(ctx, dy, *_):
        nb, has_head = ctx.nb, ctx.has_head
        saved = list(ctx.saved_tensors)
        x = saved[0]
        s_list = saved[1:1 + nb]
        istds = saved[1 + nb:1 + 2 * nb]
        means = saved[1 + 2 * nb:1 + 3 * nb]
        rest = saved[1 + 3 * nb:]
        head_stats, flat = (rest[:2], rest[2:]) if has_head else ([], rest)
        params = [flat[4 * i:4 * i + 4] for i in range(nb)]
        b, h, w, _ = x.shape
        n = b * h * w * dist.world()

        ga, be = params[-1][2], params[-1][3]
        s_top = s_list[-1].float()
        z_top = bn_apply(s_top, scal_slab(means[-1], istds[-1], ga, be))
        dzf = dy.float() * gelu_grad(z_top)
        z_hat = (s_top - means[-1]) * istds[-1]
        # this rank's [Σdz, Σdz·ẑ] (its share of the BN parameters'
        # gradients) and the global ones (the BN backward's A and B)
        local = torch.stack([dzf.sum((0, 1, 2)), (dzf * z_hat).sum((0, 1, 2))])
        sum_dz, sum_dzz = dist.all_reduce_(local.clone())
        dz = dzf.to(dy.dtype).contiguous()

        grads = [None] * nb
        for i in range(nb - 1, -1, -1):
            wm, bi, ga, be = params[i]
            scal_in = scal_slab(means[i], istds[i], ga, be, sum_dz / n, sum_dzz / n)
            if i > 0:
                gp, bp = params[i - 1][2], params[i - 1][3]
                scal_out = scal_slab(means[i - 1], istds[i - 1], gp, bp)
                sp = s_list[i - 1]
            elif has_head:
                scal_out = scal_slab(head_stats[0], head_stats[1], *flat[4 * nb:])
                sp = x
            else:
                scal_out, sp = None, x
            dzp, dw, db_ps, psp = cbg_block_bwd(dz, s_list[i], sp, wm, scal_in,
                                                scal_out)
            grads[i] = (dw.to(wm.dtype), db_ps.sum(0).to(bi.dtype),
                        local[1].to(ga.dtype), local[0].to(be.dtype))
            if i > 0 or has_head:
                local = psp.sum(0)
                sum_dz, sum_dzz = dist.all_reduce_(local.clone())
            dz = dzp
        head_grads = []
        if has_head:
            g0, b0 = flat[4 * nb:]
            head_grads = [local[1].to(g0.dtype), local[0].to(b0.dtype)]
            slab = scal_slab(head_stats[0], head_stats[1], g0, b0,
                             sum_dz / n, sum_dzz / n)
            z0_hat = (x.float() - slab[S_MEAN]) * slab[S_ISTD]
            dz = (slab[S_GAMMA] * slab[S_ISTD]
                  * (dz.float() - slab[S_A] - z0_hat * slab[S_B])).to(dz.dtype)
        return (None, None, None, dz, *[t for g in grads for t in g], *head_grads)


def cbg_chain(x: torch.Tensor, params: Sequence[Tuple[torch.Tensor, ...]],
              head_gb: Sequence[torch.Tensor] = (), eps: float = 1e-5):
    """Chain of conv3x3 + BN(train) + GELU blocks on ``x [B, H, W, C0]``.

    ``params``: per block (wmat [3, 3, C, O] and bias [O] in x's dtype,
    gamma [O] and beta [O] f32).  ``head_gb``: () when x is a feature map,
    or (gamma0, beta0) when x is the previous (non-3x3) conv's PRE-BN output,
    whose BN + GELU then runs inside the first block's load.  Returns
    (y [B, H, W, O_last] in x's dtype, means, variances), the batch
    statistics head first, for the running-stat updates."""
    flat = [t for p in params for t in p] + list(head_gb)
    out = _Chain.apply(eps, len(params), bool(head_gb), x.contiguous(), *flat)
    k = len(params) + int(bool(head_gb))
    return out[0], out[1:1 + k], out[1 + k:]

