"""Train and eval steps of the port.

Counterpart of ``deflow_tpu/trainer.py``: ``make_optimizer``,
``init_train_state`` (here a :class:`TrainState` holding the model with its
parameters and BN running statistics, the optimizer with its state, and the
step counter), ``make_train_step`` (the supervised step, or the SeFlow
self-supervised one for ``seflowLoss``; optionally with the forward
recomputed in the backward), ``make_eval_step``, ``device_batch``,
``device_prefetch``, ``history_from_batch`` (a ``num_frames > 2`` model's
history frames), and the checkpoints (``save_checkpoint``,
``load_checkpoint``, ``BestCheckpointKeeper``, ``load_weights``).  In eval,
the final predicted flow is the rigid ego flow everywhere plus the network
flow at voxel-valid points.

Data parallelism (under a ``torch.distributed`` process group, see
``dist.py``): ``init_train_state`` broadcasts rank 0's parameters and BN
buffers, each rank's step computes its share of the global loss on its rows
and sums the gradients over ranks before the optimizer step, so every rank
takes the same step; ``aux`` holds the global values; checkpoints are
written by rank 0 and read by every rank.  No ``DistributedDataParallel``
wrapper: it would rename the state-dict keys and average the gradients.

Optimizer semantics follow optax: Adam (b1 0.9, b2 0.999, eps 1e-8), AdamW
with optax's default weight decay 1e-4, SGD with momentum 0.9; a global-norm
clip that scales the gradients by clip/norm only when norm >= clip; every
parameter is stepped, a parameter the loss does not reach with a zero
gradient.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deflow_tpu_torch import convert, dist
from deflow_tpu_torch.data.h5dataset import background
from deflow_tpu_torch.data.host_prep import (CHAMFER_CELL_KEYS, HOST_PREP_KEYS,
                                             host_prep_from_batch)
from deflow_tpu_torch.device import resolve_device
from deflow_tpu_torch.losses import SSL_LOSS_REGISTRY, get_loss
from deflow_tpu_torch.models.decoder import dropout_generator
from deflow_tpu_torch.models.running_stats import remat_contexts
from deflow_tpu_torch.utils.timer import span

# the loader's history frames (num_frames > 2: pch1 is the frame before
# pc0, ...), for every depth it can emit
HISTORY_KEYS = tuple(k for h in range(1, 17)
                     for k in (f"pch{h}", f"pch{h}_mask", f"pose_pch{h}"))
# the host-batch keys the model reads, and those the supervised and the SSL
# losses add
MODEL_KEYS = ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask",
              "ego_motion") + HOST_PREP_KEYS + HISTORY_KEYS
TRAIN_KEYS = MODEL_KEYS + ("flow", "flow_is_valid", "flow_category_indices")
SSL_TRAIN_KEYS = MODEL_KEYS + ("dufo_label0", "dufo_label1") + CHAMFER_CELL_KEYS


def device_batch(batch: Dict, device=None,
                 keys: Sequence[str] = MODEL_KEYS) -> Dict[str, torch.Tensor]:
    """Move ``keys`` of a host batch onto ``device`` (the card unless
    ``"cpu"``)."""
    dev = resolve_device(device)
    out = {}
    for k in keys:
        if k in batch:
            v = batch[k]
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = v.to(dev)
    return out


def history_from_batch(batch) -> Optional[list]:
    """The loader's ``pch{h}`` history frames as the model's ``history``
    argument (``[{"pc", "mask", "pose"}, ...]``, pch1 first); None for a
    frame pair."""
    hist, h = [], 1
    while f"pch{h}" in batch:
        hist.append({"pc": batch[f"pch{h}"], "mask": batch[f"pch{h}_mask"],
                     "pose": batch[f"pose_pch{h}"]})
        h += 1
    return hist or None


def _model_inputs(model: torch.nn.Module, b: Dict) -> Dict:
    """The keyword inputs of the model beside the two clouds: the host prep
    and, for a ``num_frames > 2`` model, the history."""
    return {"ego_motion": b.get("ego_motion"), "host_prep": host_prep_from_batch(b),
            "history": (history_from_batch(b)
                        if getattr(model, "num_frames", 2) > 2 else None)}


def device_prefetch(loader: Iterable[Dict], device=None, depth: int = 2,
                    keys: Sequence[str] = MODEL_KEYS
                    ) -> Iterator[Tuple[Dict, Dict[str, torch.Tensor]]]:
    """Iterate ``(host_batch, device_batch)`` with the host-to-device copy
    of ``keys`` (those the batch has) running up to ``depth`` batches ahead,
    in a background thread.

    On the card (unless ``device="cpu"``) the thread pins each batch's
    arrays and copies them with ``non_blocking=True`` on a side stream,
    then records an event; the consumer's stream waits on that event, and
    each tensor is marked as used by it (``record_stream``) before it is
    handed out.  On the CPU the batch is moved without a stream.  An error
    of the loader reaches the consumer; an abandoned iteration stops the
    thread at its next put.  The consumer's wait for each batch, the stream
    wait included, is the span ``deflow/loader/wait``."""
    dev = resolve_device(device)

    def moved():
        if dev.type == "cpu":
            for hb in loader:
                yield hb, device_batch(hb, dev, keys), None
            return
        torch.cuda.set_device(dev)
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            for hb in loader:
                db = {k: torch.from_numpy(np.ascontiguousarray(hb[k])).pin_memory()
                      .to(dev, non_blocking=True) for k in keys if k in hb}
                ready = torch.cuda.Event()
                ready.record(side)
                yield hb, db, ready

    it = background(moved(), depth)
    while True:
        with span("deflow/loader/wait"):
            got = next(it, None)
            if got is None:
                return
            hb, db, ready = got
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                for t in db.values():
                    t.record_stream(stream)
        yield hb, db


def make_eval_step(model: torch.nn.Module, device=None) -> Callable:
    """``eval_step(host_or_device_batch) -> dict`` on ``device`` (the card
    unless ``"cpu"``).  Outputs stay in the batch's sorted point order."""
    dev = resolve_device(device)
    model.to(dev)

    @torch.inference_mode()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        b = device_batch(batch, dev)
        out = model(b["pc0"], b["pc1"], b["pose0"], b["pose1"],
                    b["pc0_mask"], b["pc1_mask"], **_model_inputs(model, b))
        total = out["pose_flow"] + torch.where(
            out["pc0_valid"][..., None], out["flow"], 0.0)
        return {"pred_flow": total, "net_flow": out["flow"],
                "pose_flow": out["pose_flow"], "pc0_valid": out["pc0_valid"]}

    return eval_step


def _cfg(cfg: Any, key: str, default=None):
    if isinstance(cfg, dict):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


@dataclass(frozen=True)
class Optimizer:
    """An optimizer recipe: ``build(params)`` makes the torch optimizer;
    ``clip`` > 0 is the global-norm clip."""

    name: str
    lr: float
    clip: float = 0.0

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        params = list(params)
        if self.name == "adam":
            return torch.optim.Adam(params, lr=self.lr, eps=1e-8)
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=self.lr, eps=1e-8,
                                     weight_decay=1e-4)
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


def make_optimizer(cfg) -> Optimizer:
    """From the config keys ``lr``, ``optimizer`` (adam | adamw | sgd,
    default adam) and ``gradient_clip`` (0 = off)."""
    name = str(_cfg(cfg, "optimizer", "adam") or "adam").lower()
    if name not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(name, float(_cfg(cfg, "lr")),
                     float(_cfg(cfg, "gradient_clip", 0.0) or 0.0))


def apply_gradients(optimizer: torch.optim.Optimizer,
                    params: Iterable[torch.nn.Parameter],
                    clip: float = 0.0) -> torch.Tensor:
    """One optimizer step on the gradients in ``.grad`` (None counts as
    zero).  Returns the global gradient norm BEFORE clipping."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt()
    if clip > 0:
        keep = norm < clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * clip))
    optimizer.step()
    return norm


@dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer
    (with the optimizer state) and the step counter."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    clip: float = 0.0
    step: int = 0


def init_train_state(model: torch.nn.Module, cfg, device=None) -> TrainState:
    """The model on ``device`` (the card unless ``"cpu"``), with rank 0's
    parameters and BN buffers under a process group, and a fresh optimizer
    from ``cfg``."""
    dev = resolve_device(device)
    model.to(dev)
    dist.broadcast_module(model)
    opt = make_optimizer(cfg)
    return TrainState(model, opt.build(model.parameters()), opt.clip)


def make_train_step(model: torch.nn.Module, loss_name: str,
                    device=None, remat: bool = False) -> Callable:
    """``train_step(state, host_or_device_batch) -> (state, aux)`` on
    ``device`` (the card unless ``"cpu"``): the supervised step on target =
    flow − pose_flow over mask = pc0_valid & flow_is_valid, or for an SSL
    loss (``seflowLoss``) the self-supervised step, whose loss reads the
    model's output dict and the batch (DUFO labels, pc1's cell prep).
    ``aux`` holds device scalars ``loss``, ``epe`` (masked mean L2 of flow −
    target; 0 for SSL), ``valid_points`` (SSL: pc0_valid & pc0_mask) and
    ``grad_norm`` (before clipping), of the global batch under a process
    group (the gradients summed over ranks first).  Each step runs the model in train mode
    and each eval step in eval mode, so the two may alternate.

    ``remat``: the model's forward (not the loss) runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the JAX package wraps its
    ``model.apply`` in ``jax.checkpoint``: the backward recomputes it instead
    of keeping its saved tensors, so every forward kernel launches twice a
    step.  The recompute leaves the BN running statistics alone, and on the
    CPU the step is the plain step bit for bit.  Under a process group the
    recompute issues the forward's collectives again, in the same order on
    every rank.

    Spans (``utils.timer.span``): ``deflow/step`` around each step, and in
    it ``deflow/step/`` ``forward`` (the model, or its ``checkpoint`` call),
    ``loss``, ``backward``, ``all_reduce`` and ``optimizer``."""
    dev = resolve_device(device)
    model.to(dev)
    is_ssl = loss_name in SSL_LOSS_REGISTRY
    loss_fn = SSL_LOSS_REGISTRY[loss_name] if is_ssl else get_loss(loss_name)
    keys = SSL_TRAIN_KEYS if is_ssl else TRAIN_KEYS

    def forward(b, step):
        # a head with dropout draws from the step's stream; made here, so
        # that remat's recompute draws the same masks
        gen = dropout_generator(step, dev) if getattr(model.head, "dropout", 0.0) else None
        return model(b["pc0"], b["pc1"], b["pose0"], b["pose1"],
                     b["pc0_mask"], b["pc1_mask"], dropout=gen, **_model_inputs(model, b))

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        with span("deflow/step"):
            return run_step(state, batch)

    def run_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        b = device_batch(batch, dev, keys)
        state.optimizer.zero_grad(set_to_none=True)
        with span("deflow/step/forward"):
            out = (checkpoint(forward, b, state.step, use_reentrant=False,
                              context_fn=remat_contexts)
                   if remat else forward(b, state.step))
        with span("deflow/step/loss"):
            if is_ssl:
                mask = out["pc0_valid"] & b["pc0_mask"]
                loss = loss_fn(out, b)
            else:
                target = b["flow"] - out["pose_flow"]
                mask = out["pc0_valid"] & b["flow_is_valid"]
                loss = loss_fn(out["flow"], target, mask, b.get("flow_category_indices"))
        with span("deflow/step/backward"):
            loss.backward()
        with span("deflow/step/all_reduce"):
            dist.all_reduce_grads(model.parameters())
        with span("deflow/step/optimizer"):
            grad_norm = apply_gradients(state.optimizer, model.parameters(), state.clip)
        state.step += 1
        with torch.no_grad():
            if is_ssl:      # no gt flow to compare against
                err_sum = torch.zeros((), device=dev)
            else:
                err = torch.linalg.vector_norm(out["flow"] - target, dim=-1)
                err_sum = torch.where(mask, err, 0.0).sum()
            # the loss share, the error sum and the count, summed over ranks
            tot = dist.all_reduce_(torch.stack([loss.detach().float(), err_sum,
                                                mask.sum().float()]))
            loss_g, n = tot[0], tot[2].to(torch.int64)
            epe = tot[1] / n.clamp(min=1)
        return state, {"loss": loss_g, "epe": epe, "valid_points": n,
                       "grad_norm": grad_norm}

    return train_step


# ---------------------------------------------------------------- checkpoints
def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                    name: Optional[str] = None,
                    keeper: Optional["BestCheckpointKeeper"] = None) -> str:
    """Write ``<ckpt_dir>/epoch_<epoch>.ckpt`` (or ``<name>.ckpt``) after
    epoch ``epoch`` has run, in the Lightning layout the reference writes
    (README.md:76-77): ``state_dict`` (the model's parameters and BN
    buffers, keys prefixed ``model.``), ``optimizer_states`` (a list of the
    torch optimizer's ``state_dict``), ``global_step`` and ``epoch``, and
    with ``keeper`` its state under ``callbacks`` (as Lightning stores its
    ``ModelCheckpoint``'s ``best_model_score``).  So
    ``convert.load_weights`` and the eval entry read it as they read a
    reference checkpoint.  Written to a temporary name, then renamed: a
    reader never sees half a file.  Under a process group rank 0 writes and
    every rank waits until it has."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name or f'epoch_{epoch}'}.ckpt"))
    if dist.is_main():
        _write_checkpoint(ckpt_dir, path, state, epoch, keeper)
    dist.barrier()
    return path


def _write_checkpoint(ckpt_dir: str, path: str, state: TrainState, epoch: int,
                      keeper: Optional["BestCheckpointKeeper"]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "state_dict": {f"model.{k}": v.detach()
                       for k, v in state.model.state_dict().items()},
        "optimizer_states": [state.optimizer.state_dict()],
        "global_step": int(state.step),
        "epoch": int(epoch),
    }
    if keeper is not None:
        payload["callbacks"] = {"BestCheckpointKeeper": keeper.state_dict()}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState,
                    keeper: Optional["BestCheckpointKeeper"] = None
                    ) -> Tuple[TrainState, int]:
    """Restore a :func:`save_checkpoint` file into ``state``: the parameters
    and BN buffers (``num_batches_tracked`` too), copied into the model's
    tensors on its device; the optimizer state, whose moments the optimizer
    moves onto its parameters' device (the file is read with
    ``map_location="cpu"``, so Adam's ``step`` stays on the CPU, where torch
    keeps it); the step; and into ``keeper`` the best value the file
    holds for the keeper's monitor and mode (Lightning restores its
    ``best_model_score``; the JAX package's keeper starts empty, so a
    resumed run's first validation overwrote ``best.ckpt`` even when it
    was worse).  Returns the state and the NEXT epoch to run:
    the file was written after its epoch had run (the JAX package's
    ``load_checkpoint`` returns the saved epoch, and its ``main`` runs that
    epoch again)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    convert.load_reference_state_dict(state.model, ckpt["state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer_states"][0])
    state.step = int(ckpt["global_step"])
    if keeper is not None:
        keeper.load_state_dict(ckpt.get("callbacks", {}).get("BestCheckpointKeeper"))
    return state, int(ckpt["epoch"]) + 1


class BestCheckpointKeeper:
    """Keep the best checkpoint by a monitored validation metric, as the
    reference's Lightning ``ModelCheckpoint(monitor=...)`` does
    (``conf/model/*.yaml`` ``val_monitor``).

    ``monitor`` is the logged name (``val/EPE_3way_mean``); the metric dict
    is keyed without the ``val/`` prefix.  ``mode`` is ``"min"`` or
    ``"max"``."""

    def __init__(self, ckpt_dir: str, monitor: str, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"val_monitor mode must be min|max, got {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.key = monitor.split("/")[-1]
        self.mode = mode
        self.best: Optional[float] = None

    def update(self, metrics: Dict[str, Any], state: TrainState,
               epoch: int) -> Optional[str]:
        """Write ``<ckpt_dir>/best.ckpt`` if the monitored metric improved
        (the first value always does); returns its path then, else None.  A
        metric dict without the key is ignored."""
        if self.key not in metrics:
            return None
        v = float(metrics[self.key])
        improved = self.best is None or (
            v < self.best if self.mode == "min" else v > self.best)
        if not improved:
            return None
        self.best = v
        return save_checkpoint(self.ckpt_dir, state, epoch, name="best", keeper=self)

    def state_dict(self) -> Dict[str, Any]:
        return {"monitor": self.key, "mode": self.mode, "best_model_score": self.best}

    def load_state_dict(self, saved: Optional[Dict[str, Any]]) -> None:
        """The best value of a saved keeper of the same monitor and mode
        (another keeper's, or none, leaves this one as it is)."""
        if saved and saved.get("monitor") == self.key and saved.get("mode") == self.mode:
            self.best = saved.get("best_model_score")


def load_weights(path: str, state: TrainState) -> TrainState:
    """The weights of a ``.ckpt``/``.pth``/``.pt`` file in the reference
    layout (a training checkpoint of :func:`save_checkpoint` too) into
    ``state``'s model; the optimizer state and the step stay as they are."""
    convert.load_weights(state.model, path)
    return state
