"""FastFlow3D's head (``decoder_option: linear``): the MLP 256 → 32 → 3 over
the gathered pillar features (128) and a 128-wide offset embedding.  Zero
flow at invalid points."""

import torch
import torch.nn.functional as F

from portbench.reference.model import linear
from portbench.reference.weights import dense

BLOCK = 2


def param_spec(cfg):
    spec = {}
    dense(spec, "head.offset_encoder", (128, 3))
    dense(spec, "head.decoder.0", (32, 256))
    dense(spec, "head.decoder.2", (3, 32))
    return spec


def forward(feats, flat, offsets, valid, W, cfg, quant, step):
    off = linear(offsets, W, "head.offset_encoder", quant)
    hid = F.gelu(linear(torch.cat([feats, off], -1), W, "head.decoder.0", quant))
    flow = linear(hid, W, "head.decoder.2", quant)
    return torch.where(valid[..., None], flow, 0.0)
