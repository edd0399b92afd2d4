"""Decoder heads: per-point flow from the pillar tables.

Counterpart of ``deflow_tpu/models/decoder.py``: the unpillar gather of the
[before | flow] tables (64 + 64 = 128 = GRU hidden), the 64-wide offset
embedding (= GRU input), ``num_iters`` ConvGRU steps through the fused
kernels (``FusedGRU``: forward and backward), and the flow MLP 192 → 32 → GELU → 3.  ``LinearDecoder`` is the
FastFlow3D head.  Parameter names follow the reference layout (GRU gates as
Conv1d(k=1), ``decoder.{0,2}``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deflow_tpu_torch.ops.gru import FusedGRU
from deflow_tpu_torch.ops.voxel import PillarInfo, pseudoimage_gather_batched


def gather_voxel_features(before_tab: torch.Tensor, after_tab: torch.Tensor,
                          info: PillarInfo) -> torch.Tensor:
    """[B, P, C] x 2 tables → per-point [B, N, 2C] (one gather of the
    concatenated table)."""
    return pseudoimage_gather_batched(
        torch.cat([before_tab, after_tab], dim=-1), info)


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

    def forward(self, before_tab, after_tab, info: PillarInfo,
                dtype: torch.dtype) -> torch.Tensor:
        voxel = gather_voxel_features(before_tab, after_tab, info).to(dtype)
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

    def forward(self, before_tab, after_tab, info: PillarInfo,
                dtype: torch.dtype) -> torch.Tensor:
        voxel = gather_voxel_features(before_tab, after_tab, info).to(dtype)
        off = _linear(self.offset_encoder, info.offsets, dtype)
        flow = _flow_mlp(self.decoder, torch.cat([voxel, off], dim=-1), dtype)
        return torch.where(info.valid[..., None], flow, 0)
