"""Plain f32 PyTorch reference of DeFlow and FastFlow3D in training mode.

Written from the published description (DeFlow, arXiv:2401.16122; the
FastFlow3D U-Net and heads of the reference code, whose parameter names
it keeps), independently of the measured program: no kernel, no host
prep, no sorted layouts.  Functions of a weight dict ``W`` (name →
tensor, the names of the reference's ``state_dict``) and a raw batch.

The forward of a frame pair:
1. ego compensation: pc0 moved by ``ego_motion`` (evaluated in f64 and
   rounded once to f32), ``pose_flow`` = moved − pc0 at real points;
2. for each cloud, pillars of ``voxel_size`` over ``point_cloud_range``
   (true f32 division, floor); a point is valid when real, finite and in
   range; the 9-lane PFN input ``[xyz | p − pillar centroid | p − pillar
   centre]``, Linear(9→32, no bias), BatchNorm (eps 1e-3) over the valid
   points of the whole batch, ReLU, and each pillar's mean → [B, 32, H, W];
3. the siamese U-Net over the 2B images (BatchNorm eps 1e-5 over the 2B
   batch, exact-erf GELU), the skips pairing each image's two halves;
4. the head (``reference/heads/<decoder_option>.py``, found by the
   configuration's ``decoder_option``) at each pc0 point, given the
   [pc0 | pc1 | U-Net] pillar features (128) gathered there, zero at
   invalid points.

BatchNorm uses the batch statistics (two-pass, biased variance); running
statistics are not tracked.  ``quant`` (the control's lower precision)
rounds the operands of every convolution and matrix product and the
gradient arriving at its output; None, the reference itself, rounds
nothing.  The large per-point and U-Net stages
run under ``torch.utils.checkpoint`` in blocks, which changes the memory
and not the arithmetic, so the whole batch fits one card.  The product
helpers (``operand``, ``output``, ``mm``, ``linear``, ``ckpt``) are the
heads' too.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import heads
from portbench.reference.weights import Leaf, bn, dense

# a lower precision: ``operand`` rounds a product's operand, ``output`` marks
# a product's output (for the gradient arriving there); None is f32
Quant = Optional[type]

_ENCODER = ((64, 8, 2, 3), (64, 3, 1, 1), (64, 3, 1, 1), (64, 3, 1, 1),
            (128, 8, 2, 3), (128, 3, 1, 1), (128, 3, 1, 1), (128, 3, 1, 1),
            (256, 8, 2, 3), (256, 3, 1, 1))
# UpsampleSkip(skip, latent, out) of decoder steps 1-3 (the third's latent
# is the two input images, 2 x feat_channels)
_DECODER = ((512, 256, 256), (256, 128, 128), (128, None, 64))


def grid_size(cfg: Dict):
    lo, hi = cfg["point_cloud_range"][:3], cfg["point_cloud_range"][3:]
    return tuple(int(round((h - l) / v)) for l, h, v in zip(lo, hi, cfg["voxel_size"]))


def param_spec(cfg: Dict) -> Dict[str, Leaf]:
    """name → ``weights.Leaf`` of every weight and BatchNorm buffer, in the
    order they are drawn: the embedder's, the U-Net's, then the head's."""
    c = int(cfg["feat_channels"])
    spec: Dict[str, Leaf] = {}
    dense(spec, "embedder.feature_net.pfn_layers.0.0", (c, 9), bias=False)
    bn(spec, "embedder.feature_net.pfn_layers.0.1", c)
    cin = c
    for i, (cout, k, _, _) in enumerate(_ENCODER, start=1):
        dense(spec, f"backbone.encoder_step_{i}.conv", (cout, cin, k, k))
        bn(spec, f"backbone.encoder_step_{i}.batchnorm", cout)
        cin = cout
    for j, (skip, latent, out) in enumerate(_DECODER, start=1):
        latent = 2 * c if latent is None else latent
        name = f"backbone.decoder_step{j}"
        dense(spec, f"{name}.u1_u2.0", (skip // 4, skip, 1, 1))
        dense(spec, f"{name}.u1_u2.2", (skip // 8, skip // 4, 1, 1))
        dense(spec, f"{name}.u3", (skip // 8, latent, 1, 1))
        dense(spec, f"{name}.u4_u5.0", (skip // 8, skip // 4, 1, 1))
        dense(spec, f"{name}.u4_u5.1", (out, skip // 8, 1, 1))
    dense(spec, "backbone.decoder_step4", (64, 64, 3, 3))
    spec.update(heads.of(cfg).param_spec(cfg))
    return spec


def operand(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a product's operand in ``quant``'s precision."""
    return t if quant is None else quant.operand(t)


def output(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a product's output: the gradient arriving there in ``quant``'s
    precision."""
    return t if quant is None else quant.output(t)


def mm(quant: Quant, x, w):
    """``x @ w.T`` with both operands in ``quant``'s precision."""
    return output(quant, operand(quant, x) @ operand(quant, w).t())


def linear(x, W, name, quant: Quant, bias=True):
    y = mm(quant, x, W[f"{name}.weight"])
    return y + W[f"{name}.bias"] if bias else y


def _conv(x, W, name, quant: Quant, stride=1, padding=0):
    return output(quant, F.conv2d(operand(quant, x), operand(quant, W[f"{name}.weight"]),
                                  W[f"{name}.bias"], stride, padding))


def ego_compensate(pc0: torch.Tensor, ego: torch.Tensor) -> torch.Tensor:
    """``p @ R^T + t`` per sample in f64, rounded once to f32."""
    p, e = pc0.double(), ego.double()
    out = (p[..., 0:1] * e[:, None, :3, 0] + p[..., 1:2] * e[:, None, :3, 1]
           + p[..., 2:3] * e[:, None, :3, 2] + e[:, None, :3, 3])
    return out.float()


def pillars(pts: torch.Tensor, mask: torch.Tensor, cfg: Dict):
    """(valid [B, N], flat pillar index cy·W + cx [B, N] (0 where invalid),
    PFN input [B, N, 9], offsets from the pillar centre [B, N, 3])."""
    gw, gh, gd = grid_size(cfg)
    lo = torch.tensor(cfg["point_cloud_range"][:3], dtype=torch.float32, device=pts.device)
    vs = torch.tensor(cfg["voxel_size"], dtype=torch.float32, device=pts.device)
    grid = torch.tensor([gw, gh, gd], device=pts.device)
    rel = torch.floor((pts - lo) / vs)
    valid = (mask & torch.isfinite(pts).all(-1) & (rel >= 0).all(-1)
             & (rel < grid).all(-1))
    cell = torch.where(valid[..., None], rel, 0.0).long()
    flat = cell[..., 1] * gw + cell[..., 0]
    b, n = mask.shape
    vf = valid.double()
    cnt = torch.zeros(b, gw * gh, dtype=torch.float64, device=pts.device)
    cnt.scatter_add_(1, flat, vf)
    tot = torch.zeros(b, gw * gh, 3, dtype=torch.float64, device=pts.device)
    tot.scatter_add_(1, flat[..., None].expand(b, n, 3), pts.double() * vf[..., None])
    cent = (tot / cnt.clamp(min=1.0)[..., None]).float()
    centroid = torch.gather(cent, 1, flat[..., None].expand(b, n, 3))
    centre = (cell.float() + 0.5) * vs + lo
    offsets = torch.where(valid[..., None], pts - centre, 0.0)
    rec = torch.cat([pts, pts - centroid, pts - centre], -1)
    return valid, flat, torch.where(valid[..., None], rec, 0.0), offsets


def _masked_bn(x, valid, W, name, eps):
    m = valid.float()[..., None]
    n = m.sum().clamp(min=1.0)
    mean = (x * m).sum((0, 1)) / n
    var = (((x - mean) * m) ** 2).sum((0, 1)) / n
    return (x - mean) * torch.rsqrt(var + eps) * W[f"{name}.weight"] + W[f"{name}.bias"]


def embed(pts, mask, W, cfg, quant: Quant = None):
    """Pillar image [B, C, H, W] and (valid, flat, offsets) of one cloud."""
    valid, flat, rec, offsets = pillars(pts, mask, cfg)
    pfn = "embedder.feature_net.pfn_layers.0"
    x = linear(rec, W, f"{pfn}.0", quant, bias=False)
    x = torch.relu(_masked_bn(x, valid, W, f"{pfn}.1", 1e-3))
    x = torch.where(valid[..., None], x, 0.0)
    gw, gh, _ = grid_size(cfg)
    b, n, c = x.shape
    idx = flat[..., None].expand(b, n, c)
    sums = torch.zeros(b, gw * gh, c, device=x.device).scatter_add(1, idx, x)
    cnt = torch.zeros(b, gw * gh, device=x.device).scatter_add(1, flat, valid.float())
    table = sums / cnt.clamp(min=1.0)[..., None]
    img = table.reshape(b, gh, gw, c).permute(0, 3, 1, 2)
    return img, (valid, flat, offsets)


def _bn2d(y, W, name):
    mean = y.mean((0, 2, 3), keepdim=True)
    var = ((y - mean) ** 2).mean((0, 2, 3), keepdim=True)
    g = W[f"{name}.weight"].view(1, -1, 1, 1)
    return (y - mean) * torch.rsqrt(var + 1e-5) * g + W[f"{name}.bias"].view(1, -1, 1, 1)


def _cbg(x, W, i, quant: Quant):
    _, _, s, p = _ENCODER[i - 1]
    y = _conv(x, W, f"backbone.encoder_step_{i}.conv", quant, s, p)
    if y.shape[2] == 1 and y.shape[3] == 1:      # BN is skipped on a 1x1 map
        return F.gelu(y)
    return F.gelu(_bn2d(y, W, f"backbone.encoder_step_{i}.batchnorm"))


def _upsample_skip(a, b, W, j, quant: Quant):
    name = f"backbone.decoder_step{j}"
    u1 = _conv(a, W, f"{name}.u1_u2.0", quant)
    up = F.interpolate(u1, scale_factor=2, mode="bilinear", align_corners=False)
    u2 = _conv(up, W, f"{name}.u1_u2.2", quant)
    u3 = _conv(b, W, f"{name}.u3", quant)
    u4 = _conv(torch.cat([u2, u3], 1), W, f"{name}.u4_u5.0", quant)
    return _conv(u4, W, f"{name}.u4_u5.1", quant)


def ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def unet(img0, img1, W, quant: Quant = None):
    """Two [B, C, H, W] images → the 64-channel flow image."""
    b = img0.shape[0]
    x = torch.cat([img0, img1])
    taps = []
    for i in range(1, len(_ENCODER) + 1):
        x = ckpt(lambda t, i=i: _cbg(t, W, i, quant), x)
        if i in (4, 8, 10):
            taps.append(x)
    n_all, r_all, t_all = taps
    pair = lambda z: torch.cat([z[:b], z[b:]], 1)
    s = ckpt(lambda a, c: _upsample_skip(a, c, W, 1, quant), pair(t_all), pair(r_all))
    l = ckpt(lambda a, c: _upsample_skip(a, c, W, 2, quant), s, pair(n_all))
    u = ckpt(lambda a, c: _upsample_skip(a, c, W, 3, quant), l, torch.cat([img0, img1], 1))
    return ckpt(lambda t: _conv(t, W, "backbone.decoder_step4", quant, 1, 1), u)


def forward(W: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], cfg: Dict,
            quant: Quant = None, block: Optional[int] = None,
            step: int = 0) -> Dict[str, torch.Tensor]:
    """``flow`` (network flow), ``pose_flow``, ``pc0_valid``, ``pc1_valid`` of a raw
    batch (``pc0``, ``pc1``, ``pc0_mask``, ``pc1_mask``, ``ego_motion``) at
    train step ``step``; the head runs ``block`` samples at a time under
    checkpoint (by default its ``BLOCK``; None there: the whole batch)."""
    head = heads.of(cfg)
    pc0, pc1 = batch["pc0"].float(), batch["pc1"].float()
    m0, m1 = batch["pc0_mask"].bool(), batch["pc1_mask"].bool()
    tpc0 = ego_compensate(pc0, batch["ego_motion"])
    pose_flow = torch.where(m0[..., None], tpc0 - pc0, 0.0)
    img0, (valid0, flat0, off0) = embed(tpc0, m0, W, cfg, quant)
    img1, (valid1, _, _) = embed(pc1, m1, W, cfg, quant)
    flow_img = unet(img0, img1, W, quant)
    b = pc0.shape[0]
    tables = torch.cat([img0, img1, flow_img], 1).flatten(2).transpose(1, 2)

    def run(tab, flat, off, valid):
        feats = torch.gather(tab, 1, flat[..., None].expand(*flat.shape, tab.shape[-1]))
        feats = torch.where(valid[..., None], feats, 0.0)
        return head.forward(feats, flat, off, valid, W, cfg, quant, step)

    block = block or head.BLOCK or b
    outs = []
    for s in range(0, b, block):
        sl = slice(s, s + block)
        outs.append(ckpt(run, tables[sl], flat0[sl], off0[sl], valid0[sl]))
    return {"flow": torch.cat(outs), "pose_flow": pose_flow, "pc0_valid": valid0,
            "pc1_valid": valid1}


def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` with a per-tensor scale (its
    largest magnitude → ``top``), back in f32."""
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Fp8:
    """FP8 training's rounding (the e4m3 forward, e5m2 backward recipe):
    the operands of every product rounded to e4m3 (the rounding passes the
    gradient straight through), the gradient arriving at every product's
    output rounded to e5m2, each with a per-tensor scale; accumulation and
    everything else in f32."""

    @staticmethod
    def operand(t: torch.Tensor) -> torch.Tensor:
        return t + (_fp8(t.detach(), torch.float8_e4m3fn, 448.0) - t.detach())

    @staticmethod
    def output(t: torch.Tensor) -> torch.Tensor:
        return _Fp8Grad.apply(t)


QUANTS = {"f32": None, "fp8": Fp8}

