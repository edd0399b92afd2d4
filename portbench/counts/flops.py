"""Model FLOPs of DeFlow / FastFlow3D from the configuration's shapes.

Counted: every multiply-add of the convolutions and matrix products that
the model defines, two FLOPs each; not counted: normalisation, activations,
scatters and gathers.  The U-Net's convolutions run over the whole grid
whatever its occupancy; the per-point layers count the valid points (in
range) of each cloud.  The head's count is its own
(``counts/heads/<decoder_option>.py``).  A train step is three forwards
(the forward and a backward of twice its products), whatever the program
recomputes; an eval step is one.  The counts depend on shapes only.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.counts import heads

_ENCODER = ((64, 8, 2, 3), (64, 3, 1, 1), (64, 3, 1, 1), (64, 3, 1, 1),
            (128, 8, 2, 3), (128, 3, 1, 1), (128, 3, 1, 1), (128, 3, 1, 1),
            (256, 8, 2, 3), (256, 3, 1, 1))


def _grid(cfg: Dict):
    lo, hi = cfg["point_cloud_range"][:3], cfg["point_cloud_range"][3:]
    return [int(round((h - l) / v)) for l, h, v in zip(lo, hi, cfg["voxel_size"])]


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    return 2.0 * cin * cout * k * k * h * w


def unet_flops(cfg: Dict) -> float:
    """Forward FLOPs of the U-Net for ONE frame pair (two images through
    the encoder, one pair through the decoder)."""
    c = int(cfg["feat_channels"])
    w, h, _ = _grid(cfg)
    total, cin, maps = 0.0, c, []
    for cout, k, s, p in _ENCODER:
        h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        total += 2 * _conv(cin, cout, k, h, w)
        cin = cout
        maps.append((cout, h, w))
    # decoder: UpsampleSkip(skip a at h x w, latent b at 2h x 2w) → out
    latents = [2 * maps[7][0], 2 * maps[3][0], 2 * c]
    outs = [256, 128, 64]
    _, h, w = maps[9]
    for skip, latent, out in zip((512, 256, 128), latents, outs):
        total += _conv(skip, skip // 4, 1, h, w)
        h, w = 2 * h, 2 * w
        total += (_conv(skip // 4, skip // 8, 1, h, w) + _conv(latent, skip // 8, 1, h, w)
                  + _conv(skip // 4, skip // 8, 1, h, w) + _conv(skip // 8, out, 1, h, w))
    total += _conv(64, 64, 3, h, w)
    return total


def point_flops(cfg: Dict) -> Dict[str, float]:
    """Forward FLOPs per valid point: ``pfn`` (each cloud's points) and, of a
    head whose count is per point, ``head`` (pc0's points)."""
    return {"pfn": 2.0 * 9 * int(cfg["feat_channels"]),
            "head": heads.of(cfg).point_flops(cfg)}


def _forward(cfg: Dict, pairs: int, valid0: float, valid1: float, head: float) -> float:
    pfn = 2.0 * 9 * int(cfg["feat_channels"])
    return pairs * unet_flops(cfg) + pfn * (valid0 + valid1) + head


def _forwards(mode: str) -> float:
    return 3.0 if mode == "train" else 1.0


def batch_flops(cfg: Dict, mode: str, stats: List[Dict]) -> float:
    """A train step (forward and backward: three forwards) or an eval step
    over the frame pairs ``stats`` (each a ``samples.sample_stats``)."""
    v0, v1 = (sum(s[k] for s in stats) for k in ("valid0", "valid1"))
    head = heads.of(cfg).forward_flops(cfg, stats)
    return _forwards(mode) * _forward(cfg, len(stats), v0, v1, head)


def step_flops(cfg: Dict, mode: str, pairs: int, valid0: float, valid1: float) -> float:
    """The same from the batch's sums alone, ``valid0`` / ``valid1`` valid
    points in all its pc0 / pc1 clouds together: of a head whose count is
    per point."""
    head = point_flops(cfg)["head"] * valid0
    return _forwards(mode) * _forward(cfg, pairs, valid0, valid1, head)
