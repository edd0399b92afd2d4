"""The benchmark's weights, made on the device from the seed.

One ``torch.rand`` call on a generator seeded with ``seed`` fills every
leaf of a parameter spec (``model.param_spec``), each leaf a slice of it
mapped to its range: a Linear or conv weight and its bias within
±1/√fan_in of the weight, BatchNorm scale in [0.9, 1.1], shift and running
mean in [-0.1, 0.1], running variance in [0.5, 1.5].  Both the program and
the reference are given these weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_RANGES = {"bn_weight": (0.9, 1.1), "bn_bias": (-0.1, 0.1), "bn_mean": (-0.1, 0.1),
           "bn_var": (0.5, 1.5)}


def _range(spec: Dict[str, tuple], name: str, kind: str):
    if kind != "dense":
        return _RANGES[kind]
    w_shape = spec[name.rsplit(".", 1)[0] + ".weight"][0]
    bound = 1.0 / math.sqrt(math.prod(w_shape[1:]))
    return -bound, bound


def make_weights(spec: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """name → f32 tensor on ``device``, drawn from ``seed``."""
    total = sum(math.prod(shape) for shape, _ in spec.values())
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, kind) in spec.items():
        n = math.prod(shape)
        lo, hi = _range(spec, name, kind)
        out[name] = (lo + (hi - lo) * u[at:at + n]).reshape(shape)
        at += n
    return out
