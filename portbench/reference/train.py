"""The reference's first train steps, and the numbers that compare them
with the program's.

``follow`` runs the plain model, loss and Adam over the batches of the
program's first steps, from the benchmark's weights, in f32 with TF32 off
(or with ``quant``, the control's lower precision); step ``i`` is the
program's step ``i`` after the restart.  It returns what the
program's run is held to: each step's loss, each leaf's gradient norm at
the first step, and each leaf's change after the last.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from portbench.reference import model as ref_model
from portbench.reference.losses import loss_of
from portbench.reference.optim import Adam
from portbench.reference.weights import Leaf, make_weights

# the kinds of leaf that train, where a leaf does not say
PARAM_KINDS = ("dense", "bn_weight", "bn_bias")


def trains(leaf: Leaf) -> bool:
    """Whether the optimizer moves ``leaf``."""
    return leaf.kind in PARAM_KINDS if leaf.trains is None else leaf.trains


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def follow(cfg: Dict, loss_name: str, lr: float, seed: int, batches: List[Dict],
           device, quant: Optional[str] = None) -> Dict:
    """Losses, first-step gradient norms and the change norms after
    ``len(batches)`` steps (each batch a dict of raw tensors on
    ``device``)."""
    no_tf32()
    spec = ref_model.param_spec(cfg)
    weights = make_weights(spec, seed, device)
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()
              if trains(spec[k])}
    opt = Adam(params, lr)
    q = ref_model.QUANTS[quant or "f32"]
    W = {**weights, **params}      # the leaves that do not train, as drawn
    losses, grad_norms = [], {}
    for i, batch in enumerate(batches):
        out = ref_model.forward(W, batch, cfg, quant=q, step=i)
        loss = loss_of(loss_name, out, batch)
        loss.backward()
        if i == 0:
            grad_norms = {k: float(p.grad.norm()) if p.grad is not None else 0.0
                          for k, p in params.items()}
        losses.append(float(loss.detach()))
        opt.step()
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in params.items()}
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}


def _worst(gaps) -> float:
    """The largest gap; a gap that is not a number reads as infinite."""
    gaps = [g if g == g else float("inf") for g in gaps]
    return max(gaps)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    """Each kept leaf's gap; a gap that is not a number reads as infinite."""
    floor = statistics.median(ref[k] for k in keep)
    gaps = (abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor) for k in keep)
    return [g if g == g else float("inf") for g in gaps]


def worst_leaves(prog: Dict, ref: Dict, key: str, n: int = 3, floor_share: float = 1e-3):
    """The ``n`` leaves with the largest gap of ``key`` (a diagnostic)."""
    g_med = statistics.median(ref["grad_norm"].values())
    keep = [k for k, g in ref["grad_norm"].items() if g >= floor_share * g_med]
    floor = statistics.median(ref[key][k] for k in keep)
    gaps = {k: abs(prog[key].get(k, 0.0) - ref[key][k]) / max(ref[key][k], floor)
            for k in keep}
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def compare(prog: Dict, ref: Dict, floor_share: float = 1e-3) -> Dict[str, float]:
    """The numbers compared: ``loss_gap``, the largest relative gap of the
    steps' losses; ``grad_gap`` and ``change_gap``, the worst leaf's gap
    between the program's norm and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf;
    ``change_gap_median``, the median leaf's gap of the change, which a
    precision lost in every layer moves and a bf16 run's rounding in one
    leaf does not.  Leaves whose reference gradient is under
    ``floor_share`` of the median leaf's (a bias before a train-mode
    BatchNorm: zero but for rounding) are left out of all three."""
    g_med = statistics.median(ref["grad_norm"].values())
    keep = [k for k, g in ref["grad_norm"].items() if g >= floor_share * g_med]
    loss_gap = _worst(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = float("inf")
    grad = _leaf_gaps(prog["grad_norm"], ref["grad_norm"], keep)
    change = _leaf_gaps(prog["change_norm"], ref["change_norm"], keep)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad), "change_gap": max(change),
            "change_gap_median": statistics.median(change)}
