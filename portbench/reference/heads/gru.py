"""DeFlow's head (``decoder_option: gru``): the gathered pillar features
(128) are the hidden state of ``num_iters`` ConvGRU steps whose input is
the 64-wide offset embedding; then the MLP 192 → 32 → 3 over [hidden |
embedding].  Zero flow at invalid points."""

import torch
import torch.nn.functional as F

from portbench.reference.model import linear, mm
from portbench.reference.weights import dense

BLOCK = 2


def param_spec(cfg):
    spec = {}
    dense(spec, "head.offset_encoder", (64, 3))
    for gate in ("convz", "convr", "convq"):
        dense(spec, f"head.gru.{gate}", (128, 192, 1))
    dense(spec, "head.decoder.0", (32, 192))
    dense(spec, "head.decoder.2", (3, 32))
    return spec


def forward(feats, flat, offsets, valid, W, cfg, quant, step):
    off = linear(offsets, W, "head.offset_encoder", quant)
    h = feats
    wz, wr, wq = (W[f"head.gru.{g}.weight"][:, :, 0] for g in ("convz", "convr", "convq"))
    bz, br, bq = (W[f"head.gru.{g}.bias"] for g in ("convz", "convr", "convq"))
    for _ in range(int(cfg["num_iters"])):
        hx = torch.cat([h, off], -1)
        z = torch.sigmoid(mm(quant, hx, wz) + bz)
        r = torch.sigmoid(mm(quant, hx, wr) + br)
        rhx = torch.cat([r * h, off], -1)
        q = torch.tanh(mm(quant, rhx, wq) + bq)
        h = (1.0 - z) * h + z * q
    hid = F.gelu(linear(torch.cat([h, off], -1), W, "head.decoder.0", quant))
    flow = linear(hid, W, "head.decoder.2", quant)
    return torch.where(valid[..., None], flow, 0.0)
