"""The benchmark's weights, made on the device from the seed.

One ``torch.rand`` call on a generator seeded with ``seed`` fills every
leaf of a parameter spec (``model.param_spec``), in the spec's order, each
leaf a slice of it mapped to its range: the leaf's own ``draw`` where it
states one; else a Linear or conv weight and its bias within ±1/√fan_in
of the weight (of the leaf ``fan_in`` names, where it names one),
BatchNorm scale in [0.9, 1.1], shift and running mean in [-0.1, 0.1],
running variance in [0.5, 1.5].  Both the program and the reference are
given these weights.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

_RANGES = {"bn_weight": (0.9, 1.1), "bn_bias": (-0.1, 0.1), "bn_mean": (-0.1, 0.1),
           "bn_var": (0.5, 1.5)}


class Leaf(NamedTuple):
    """A leaf of a parameter spec: its shape and kind (``dense``, ``bn_weight``,
    ``bn_bias``, ``bn_mean``, ``bn_var``, or a kind of its own); ``draw``, a
    range of its own; ``fan_in``, the leaf whose fan-in bounds a dense draw
    (else the sibling ``.weight``); ``trains``, whether the optimizer moves
    it (else by its kind: ``train.PARAM_KINDS``)."""

    shape: Tuple[int, ...]
    kind: str
    draw: Optional[Tuple[float, float]] = None
    fan_in: Optional[str] = None
    trains: Optional[bool] = None


def dense(spec: Dict[str, Leaf], name: str, shape, bias: bool = True) -> None:
    """A Linear or conv layer's ``weight`` and ``bias`` leaves."""
    spec[f"{name}.weight"] = Leaf(tuple(shape), "dense")
    if bias:
        spec[f"{name}.bias"] = Leaf((shape[0],), "dense")


def bn(spec: Dict[str, Leaf], name: str, ch: int) -> None:
    """A BatchNorm's scale, shift and running statistics."""
    for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        spec[f"{name}.{leaf}"] = Leaf((ch,), kind)


def _range(spec: Dict[str, Leaf], name: str, leaf: Leaf):
    if leaf.draw is not None:
        return leaf.draw
    if leaf.kind != "dense":
        if leaf.kind not in _RANGES:
            raise ValueError(f"leaf {name!r} of kind {leaf.kind!r} states no draw range")
        return _RANGES[leaf.kind]
    w_shape = spec[leaf.fan_in or name.rsplit(".", 1)[0] + ".weight"].shape
    bound = 1.0 / math.sqrt(math.prod(w_shape[1:]))
    return -bound, bound


def make_weights(spec: Dict[str, Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """name → f32 tensor on ``device``, drawn from ``seed``."""
    total = sum(math.prod(leaf.shape) for leaf in spec.values())
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, leaf in spec.items():
        n = math.prod(leaf.shape)
        lo, hi = _range(spec, name, leaf)
        out[name] = (lo + (hi - lo) * u[at:at + n]).reshape(leaf.shape)
        at += n
    return out
