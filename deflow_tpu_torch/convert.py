"""Weights into the port: flax variables or a reference state_dict.

The port's parameter names are the reference torch layout (the layout of
``deflow_tpu/convert.py`` ``export_state_dict`` without its ``model.``
prefix): Conv HWIO → OIHW, Dense → Linear ``[O, I]``, GRU gates as Conv1d
``[O, I, 1]``, BatchNorm and LayerNorm scale/bias → weight/bias and
batch_stats → running_mean/running_var, the MMHead's attention leaves
(flax ``query/key/value/out``) packed into ``nn.MultiheadAttention``'s
``in_proj_weight [3d, d]``, ``in_proj_bias`` and ``out_proj``, and the
module renames below (``layers_N`` → ``pts_off_transformer.layers.N``).  So one loader takes
both the JAX package's variables (via :func:`state_dict_from_flax`) and a
reference Lightning ``state_dict``; :func:`load_weights` reads a checkpoint
file into a model.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

# flax path → torch path, applied as ONE regex pass (sequential substring
# replacement would re-match inside its own output, e.g. "u2" in "u1_u2")
_REVERSE_MAP = {
    "feature_net.linear": "feature_net.pfn_layers.0.0",
    "feature_net.norm": "feature_net.pfn_layers.0.1",
    "u1": "u1_u2.0",
    "u2": "u1_u2.2",
    "u4": "u4_u5.0",
    "u5": "u4_u5.1",
    "decoder.fc1": "decoder.0",
    "decoder.fc2": "decoder.2",
}
_REVERSE_RE = re.compile(
    r"(?<!\w)(" + "|".join(re.escape(k) for k in sorted(
        _REVERSE_MAP, key=len, reverse=True)) + r")(?!\w)")
_LAYERS_RE = re.compile(r"(?<!\w)layers_(\d+)")
_GRU_GATES = ("convz", "convr", "convq")
_ATTENTION = ("self_attn", "multihead_attn")


def _torch_key(flax_path) -> str:
    key = _REVERSE_RE.sub(lambda m: _REVERSE_MAP[m.group(1)], ".".join(flax_path))
    return _LAYERS_RE.sub(r"pts_off_transformer.layers.\1", key)


def _pack_attention(leaves: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """flax ``MultiHeadDotProductAttention`` leaves (``query.kernel [d, h,
    d/h]``, ``query.bias [h, d/h]`` … ``out.kernel [h, d/h, d]``) →
    ``nn.MultiheadAttention``'s (rows of ``in_proj_weight`` = q, k, v
    outputs, head-major)."""
    d = leaves["query.kernel"].shape[0]
    out = {"in_proj_weight": np.concatenate(
        [leaves[f"{n}.kernel"].reshape(d, d).T for n in ("query", "key", "value")]),
           "out_proj.weight": leaves["out.kernel"].reshape(d, d).T}
    if "query.bias" in leaves:
        out["in_proj_bias"] = np.concatenate(
            [leaves[f"{n}.bias"].reshape(d) for n in ("query", "key", "value")])
    if "out.bias" in leaves:
        out["out_proj.bias"] = leaves["out.bias"]
    return out


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` nested dicts of arrays → the port's
    ``state_dict`` (f32 tensors, copied; zero ``num_batches_tracked``).

    Either collection may be missing, so the same mapping carries a
    gradient tree (``{"params": grads}``) or the state after a JAX train
    step onto the port's parameter names."""
    out: Dict[str, torch.Tensor] = {}
    attention: Dict[tuple, Dict[str, np.ndarray]] = {}

    def walk(tree, path, collection):
        for k, v in tree.items():
            p = path + [k]
            if hasattr(v, "items"):
                walk(v, p, collection)
                continue
            arr = np.array(v, np.float32)
            at = [i for i, seg in enumerate(p) if seg in _ATTENTION]
            if at:                      # packed after the walk
                attention.setdefault(tuple(p[:at[0] + 1]), {})[
                    ".".join(p[at[0] + 1:])] = arr
                continue
            leaf = p[-1]
            if collection == "batch_stats":
                leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
            elif leaf in ("scale", "kernel"):
                if leaf == "kernel" and arr.ndim == 4:      # HWIO → OIHW
                    arr = arr.transpose(3, 2, 0, 1)
                elif leaf == "kernel" and arr.ndim == 2:    # Dense → Linear
                    arr = arr.T
                    if p[-2] in _GRU_GATES:                 # Conv1d(k=1)
                        arr = arr[:, :, None]
                leaf = "weight"
            key = _torch_key(p[:-1] + [leaf])
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(variables.get("params", {}), [], "params")
    walk(variables.get("batch_stats", {}), [], "batch_stats")
    for module, leaves in attention.items():
        for leaf, arr in _pack_attention(leaves).items():
            out[_torch_key(list(module)) + "." + leaf] = torch.from_numpy(
                np.ascontiguousarray(arr))
    for key in [k for k in out if k.endswith("running_mean")]:
        out[key.replace("running_mean", "num_batches_tracked")] = torch.zeros(
            (), dtype=torch.int64)
    return out


def load_reference_state_dict(model: torch.nn.Module,
                              state_dict: Mapping, prefix: str = "model.") -> None:
    """Load a reference-layout ``state_dict`` (keys optionally prefixed, as
    in a Lightning checkpoint) into ``model``; every key must match."""
    sd = {}
    for k, v in state_dict.items():
        k = k[len(prefix):] if prefix and k.startswith(prefix) else k
        sd[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
    model.load_state_dict(sd, strict=True)


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a checkpoint file in the reference torch layout into ``model``:
    a Lightning ``.ckpt`` (its ``state_dict``), or a ``.pth``/``.pt`` holding
    a state dict or ``{"state_dict": ...}`` (what the JAX package's
    ``save_torch_checkpoint`` writes).  Read with ``weights_only=True``, so
    a file that holds more than tensors and plain containers is refused.
    Every key must match the model."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?); "
            "the port reads .ckpt/.pth/.pt files in the reference torch "
            "layout: convert with deflow_tpu.convert.save_torch_checkpoint")
    if not path.endswith((".ckpt", ".pth", ".pt")):
        raise ValueError(f"unsupported checkpoint {path!r}: want .ckpt, .pth or .pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state_dict(model, ckpt.get("state_dict", ckpt))
    return model
