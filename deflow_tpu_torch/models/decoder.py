"""Decoder heads: per-point flow from the pillar tables.

Counterpart of ``deflow_tpu/models/decoder.py``: the unpillar gather of the
[before | flow] tables (64 + 64 = 128 = GRU hidden), the 64-wide offset
embedding (= GRU input), ``num_iters`` ConvGRU steps through the fused
kernels (``FusedGRU``: forward and backward), and the flow MLP 192 → 32 → GELU → 3.  ``LinearDecoder`` is the
FastFlow3D head, ``MMHeadDecoder`` the transformer ablation head.
Parameter names follow the reference layout (GRU gates as Conv1d(k=1),
``decoder.{0,2}``, ``pts_off_transformer.layers.N``).  Every head takes the
embedder's scatter plan for the gather's backward when the points are not
host-sorted, and a dropout generator (only the MMHead draws from it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deflow_tpu_torch import dist
from deflow_tpu_torch.ops.gru import FusedGRU
from deflow_tpu_torch.ops.voxel import PillarInfo, ScatterPlan, pseudoimage_gather_batched


def gather_voxel_features(before_tab: torch.Tensor, after_tab: torch.Tensor,
                          info: PillarInfo,
                          plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """[B, P, C] x 2 tables → per-point [B, N, 2C] (one gather of the
    concatenated table)."""
    return pseudoimage_gather_batched(
        torch.cat([before_tab, after_tab], dim=-1), info, plan)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _flow_mlp(seq: nn.Sequential, x: torch.Tensor, dtype: torch.dtype):
    return _linear(seq[2], F.gelu(_linear(seq[0], x, dtype)), dtype)


class ConvGRU(nn.Module):
    """GRU cell whose gates are per-point 1x1 convs (reference layout)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 64):
        super().__init__()
        in_dim = hidden_dim + input_dim
        self.convz = nn.Conv1d(in_dim, hidden_dim, 1)
        self.convr = nn.Conv1d(in_dim, hidden_dim, 1)
        self.convq = nn.Conv1d(in_dim, hidden_dim, 1)

    def merged_weights(self):
        """(w_zr [in, 2H], b_zr [2H], w_q [in, H], b_q [H]): z and r share
        their input, so their weights run as one matmul."""
        w = lambda conv: conv.weight[:, :, 0].t()
        w_zr = torch.cat([w(self.convz), w(self.convr)], dim=1)
        b_zr = torch.cat([self.convz.bias, self.convr.bias])
        return w_zr, b_zr, w(self.convq), self.convq.bias


class ConvGRUDecoder(nn.Module):
    """DeFlow's iterative GRU refinement head."""

    def __init__(self, pseudoimage_channels: int = 64, num_iters: int = 4):
        super().__init__()
        c = pseudoimage_channels
        self.num_iters = num_iters
        self.offset_encoder = nn.Linear(3, c)
        self.gru = ConvGRU(2 * c, c)
        self.decoder = nn.Sequential(nn.Linear(3 * c, c // 2), nn.GELU(),
                                     nn.Linear(c // 2, 3))

    def forward(self, before_tab, after_tab, info: PillarInfo, dtype: torch.dtype,
                plan: Optional[ScatterPlan] = None, dropout=None) -> torch.Tensor:
        voxel = gather_voxel_features(before_tab, after_tab, info, plan).to(dtype)
        off = _linear(self.offset_encoder, info.offsets, dtype)
        b, n, hd = voxel.shape
        h = FusedGRU.apply(voxel.reshape(b * n, hd).contiguous(),
                           off.reshape(b * n, -1).contiguous(),
                           *(t.to(dtype).contiguous()
                             for t in self.gru.merged_weights()),
                           self.num_iters).reshape(b, n, hd)
        flow = _flow_mlp(self.decoder, torch.cat([h, off], dim=-1), dtype)
        return torch.where(info.valid[..., None], flow, 0)


class LinearDecoder(nn.Module):
    """FastFlow3D head: gathered features + 128-wide offset embedding → MLP."""

    def __init__(self, pseudoimage_channels: int = 64):
        super().__init__()
        self.offset_encoder = nn.Linear(3, 128)
        self.decoder = nn.Sequential(
            nn.Linear(2 * pseudoimage_channels + 128, 32), nn.GELU(),
            nn.Linear(32, 3))

    def forward(self, before_tab, after_tab, info: PillarInfo, dtype: torch.dtype,
                plan: Optional[ScatterPlan] = None, dropout=None) -> torch.Tensor:
        voxel = gather_voxel_features(before_tab, after_tab, info, plan).to(dtype)
        off = _linear(self.offset_encoder, info.offsets, dtype)
        flow = _flow_mlp(self.decoder, torch.cat([voxel, off], dim=-1), dtype)
        return torch.where(info.valid[..., None], flow, 0)


def dropout_generator(step: int, device) -> torch.Generator:
    """The dropout stream of train step ``step`` on ``device``: seeded from
    (42, step), as the JAX package folds ``key(42)`` with the step (its
    bits differ from JAX's)."""
    return torch.Generator(device=device).manual_seed((42 << 32) + int(step))


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
             shape=None) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``gen`` (``F.dropout`` takes
    no generator); ``shape`` broadcasts one mask over the leading axes (the
    attention weights' mask, as flax's ``broadcast_dropout``).  Off without
    a generator or at rate 0.

    Under a process group every rank draws the mask of the global batch's
    chunks (its leading axis W times this rank's) and keeps its own rows,
    so each chunk gets the mask the single-process step gives it."""
    if gen is None or rate == 0.0:
        return x
    if shape is None:
        g, w = x.shape[0], dist.world()
        keep = torch.empty((g * w, *x.shape[1:]), dtype=torch.bool, device=x.device)
        keep = keep.bernoulli_(1.0 - rate, generator=gen)[dist.rank() * g:][:g]
    else:
        keep = torch.empty(shape, dtype=torch.bool,
                           device=x.device).bernoulli_(1.0 - rate, generator=gen)
    return torch.where(keep, x / (1.0 - rate), 0)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: torch.Tensor, rate: float = 0.0,
                     gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Scaled dot-product attention of ``q, k, v [G, H, L, D]`` over the
    keys ``key_mask [G, L]`` marks, in the inputs' dtype
    (``flax.linen.dot_product_attention``): ``q / √D`` first, masked logits
    set to ``finfo(dtype).min`` (not −inf: a chunk whose keys are all masked
    gets a uniform softmax, not NaN, and its backward stays finite), then
    softmax, dropout of the weights (one [L, L] mask for every chunk and
    head) and the product with ``v``."""
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    logits = q @ k.transpose(-1, -2)
    logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(q.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    weights = _dropout(weights, rate, gen, shape=weights.shape[-2:])
    return weights @ v


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj_weight
    [3d, d]``, ``in_proj_bias``, ``out_proj``) computed by
    :func:`masked_attention` (flax ``MultiHeadDotProductAttention``)."""

    def __init__(self, d_model: int = 128, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, key_mask: torch.Tensor,
                dtype: torch.dtype, rate: float = 0.0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        g, l, d = x.shape
        w, b = self.in_proj_weight.to(dtype), self.in_proj_bias.to(dtype)
        heads = lambda t: t.reshape(g, l, self.num_heads, -1).transpose(1, 2)
        q = heads(F.linear(x.to(dtype), w[:d], b[:d]))
        k = heads(F.linear(memory.to(dtype), w[d:2 * d], b[d:2 * d]))
        v = heads(F.linear(memory.to(dtype), w[2 * d:], b[2 * d:]))
        o = masked_attention(q, k, v, key_mask, rate, gen)
        return _linear(self.out_proj, o.transpose(1, 2).reshape(g, l, d), dtype)


class TransformerDecoderLayer(nn.Module):
    """Post-norm ``nn.TransformerDecoderLayer`` (d_model 128, 4 heads, FFN
    2048 with ReLU, dropout 0.1; the reference's constructor defaults),
    its parameter names (``self_attn``, ``multihead_attn``, ``linear1/2``,
    ``norm1..3``).  Dropout at JAX's sites: the attention weights, after
    each attention block, after the FFN activation and after the FFN
    output.  LayerNorm eps 1e-5, the reference's (the JAX package keeps
    flax's 1e-6)."""

    def __init__(self, d_model: int = 128, nhead: int = 4,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, key_mask, dtype: torch.dtype,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout if gen is not None else 0.0
        drop = lambda t: _dropout(t, rate, gen)

        def norm(ln, t):        # statistics in f32 at least, as flax's LayerNorm
            ct = torch.promote_types(t.dtype, torch.float32)
            return F.layer_norm(t.to(ct), ln.normalized_shape, ln.weight.to(ct),
                                ln.bias.to(ct), ln.eps).to(dtype)

        x = norm(self.norm1, tgt + drop(self.self_attn(tgt, tgt, key_mask, dtype,
                                                       rate, gen)))
        x = norm(self.norm2, x + drop(self.multihead_attn(x, memory, key_mask, dtype,
                                                          rate, gen)))
        y = _linear(self.linear2, drop(torch.relu(_linear(self.linear1, x, dtype))),
                    dtype)
        return norm(self.norm3, x + drop(y))


class MMHeadDecoder(nn.Module):
    """Transformer ablation head (``deflow_tpu/models/decoder.py``
    ``MMHeadDecoder``): the gathered 128-wide [before | flow] features are
    the target, the 128-wide offset embedding the memory, of a 4-layer
    decoder over 512-point chunks; then the flow MLP 128 → 32 → GELU → 3.

    Static shapes as in the JAX package: a stable sort moves each sample's
    valid points to the front (in their batch order), the samples are
    padded to whole chunks and cut into 512-row chunks over the flattened
    batch, each chunk masks its padding and invalid rows as attention keys
    (a chunk past the valid count is all masked), and the outputs unsort
    back to the batch order.  Dropout is on in train mode when the caller
    passes a generator (``dropout_generator``); train mode without one
    raises."""

    def __init__(self, pseudoimage_channels: int = 64, chunk: int = 512,
                 num_layers: int = 4, dropout: float = 0.1):
        super().__init__()
        self.chunk = chunk
        self.offset_encoder = nn.Linear(3, 2 * pseudoimage_channels)
        self.pts_off_transformer = nn.Module()
        self.pts_off_transformer.layers = nn.ModuleList(
            TransformerDecoderLayer(2 * pseudoimage_channels, dropout=dropout)
            for _ in range(num_layers))
        self.decoder = nn.Sequential(nn.Linear(2 * pseudoimage_channels, 32),
                                     nn.GELU(), nn.Linear(32, 3))

    @property
    def dropout(self) -> float:
        """The layers' dropout rate (0: the head draws no masks)."""
        return max(layer.dropout for layer in self.pts_off_transformer.layers)

    def forward(self, before_tab, after_tab, info: PillarInfo, dtype: torch.dtype,
                plan: Optional[ScatterPlan] = None,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training and self.dropout > 0 and dropout is None:
            raise ValueError("the MMHead in train mode draws its dropout from a "
                             "generator (models.decoder.dropout_generator)")
        gen = dropout if self.training else None
        voxel = gather_voxel_features(before_tab, after_tab, info, plan).to(dtype)
        off = _linear(self.offset_encoder, info.offsets, dtype)
        b, n, d = voxel.shape
        # the valid rows first, in batch order; ``inv`` restores the order
        perm = torch.sort((~info.valid).to(torch.int8), dim=1, stable=True)[1]
        inv = torch.empty_like(perm).scatter_(
            1, perm, torch.arange(n, device=perm.device).expand(b, n))
        take = lambda t, idx: torch.gather(t, 1, idx[..., None].expand(-1, -1, d))
        pad = (-n) % self.chunk
        chunks = lambda t: F.pad(take(t, perm), (0, 0, 0, pad)).reshape(-1, self.chunk, d)
        active = (torch.arange(n + pad, device=perm.device)[None, :]
                  < info.valid.sum(dim=1, keepdim=True))
        key_mask = active.reshape(-1, self.chunk)
        x, memory = chunks(voxel), chunks(off)
        for layer in self.pts_off_transformer.layers:
            x = layer(x, memory, key_mask, dtype, gen)
        x = take(x.reshape(b, n + pad, d)[:, :n], inv)
        flow = _flow_mlp(self.decoder, x, dtype)
        return torch.where(info.valid[..., None], flow, 0)
