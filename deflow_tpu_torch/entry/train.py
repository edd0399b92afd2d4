"""The train entry point (counterpart of ``deflow_tpu/entry/train.py``).

    python -m deflow_tpu_torch.entry.train [device=cpu] key=value ...

(the reference's CLI contract, README.md:66-74: ``model=deflow lr=2e-4
epochs=15 batch_size=16 loss_fn=deflowLoss`` plus nested and list
overrides).  Runs on the card unless ``device=cpu`` is given in the config
or the call; without a card it raises.

The path: ``HDF5Dataset`` → ``DataLoader`` (shuffled from ``seed`` +
epoch; the C++ host prep as ``post_collate``, in the loader's prefetch
thread) → ``trainer.device_prefetch`` of the train keys → the supervised or
SeFlow step (``remat`` recomputes the forward in the backward) → the JSONL
or wandb log every ``log_every`` steps; after each epoch the validation
sweep (``run_validation``, every ``eval_every`` epochs), the best
checkpoint on ``model.val_monitor`` and ``epoch_<N>.ckpt`` (every
``ckpt_every`` epochs) under ``<output_dir>/wandb/<model>-<slurm_id>/
checkpoints``.  ``resume=<.ckpt>`` continues with the epoch after the
file's, with that epoch's shuffle; ``checkpoint=<.ckpt|.pth|.pt>`` starts
from its weights.  ``profile=k`` traces steps 2 … 2+k with torch.profiler
into ``<run_dir>/profile`` (``trace.json``), with the program's spans
(``utils.timer.span``) on for those steps: their ranges in the trace, their
tallies in ``spans.json``.

``main`` composes the config and opens the ``.h5`` splits; :func:`fit`
does the rest on any datasets shaped like ``HDF5Dataset`` (lists of sample
dicts, where ``h5py`` is absent).

Data parallel over W cards, one rank each:

    torchrun --nproc_per_node=W -m deflow_tpu_torch.entry.train key=value ...

``batch_size`` is the global batch (it must divide by W, as the JAX
package's mesh requires); each rank loads and preps its rows of it, the
step computes the global batch's loss, BN statistics and gradients, and
rank 0 alone logs and writes the checkpoints (see ``dist.py``).
"""

from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from deflow_tpu_torch import dist
from deflow_tpu_torch.config import Config, check_num_devices, from_cli
from deflow_tpu_torch.data.h5dataset import DataLoader, HDF5Dataset
from deflow_tpu_torch.device import resolve_device
from deflow_tpu_torch.entry.evaluate import _sorted_prep, run_validation
from deflow_tpu_torch.losses import SSL_LOSS_REGISTRY
from deflow_tpu_torch.models import build_model
from deflow_tpu_torch.ops.chamfer import NNSpec, _dyn_cap_for
from deflow_tpu_torch.trainer import (SSL_TRAIN_KEYS, TRAIN_KEYS, BestCheckpointKeeper,
                                      TrainState, device_prefetch, init_train_state,
                                      load_checkpoint, load_weights, make_eval_step,
                                      make_train_step, save_checkpoint)
from deflow_tpu_torch.utils.logger import MetricLogger
from deflow_tpu_torch.utils.timer import StageTimer, set_spans, take_spans


class DynCapMonitor:
    """Host-side check of every SSL batch against the compacted f-term
    budget (``NNSpec.dyn_cap``): points beyond it lose their
    dynamic-chamfer gradient, so a denser DUFO labeling than expected warns,
    once for each new running maximum.

    ``dyn_cap`` resolves as the JAX package's monitor does: the argument,
    else a non-zero ``DEFLOW_SSL_DYNCAP``, else no budget (the cap is N and
    the monitor never warns).  ``DEFLOW_SSL_DYNCAP=0`` therefore means no
    override here, and no compaction in ``seflow_loss``."""

    def __init__(self, dyn_cap: Optional[int] = None):
        if dyn_cap is None:
            env_cap = os.environ.get("DEFLOW_SSL_DYNCAP")
            if env_cap is not None and int(env_cap):
                dyn_cap = int(env_cap)
        self.dyn_cap = dyn_cap
        self._warned_max = 0
        self.seen_max = 0

    def check(self, host_batch: dict) -> None:
        for side in ("0", "1"):
            dufo = host_batch.get(f"dufo_label{side}")
            mask = host_batch.get(f"pc{side}_mask")
            if dufo is None or mask is None:
                continue
            counts = np.sum(np.asarray(mask) & (np.asarray(dufo) > 0), axis=-1)
            cap = _dyn_cap_for(NNSpec(method="grid", dyn_cap=self.dyn_cap),
                               int(np.asarray(mask).shape[-1]))
            m = int(counts.max())
            self.seen_max = max(self.seen_max, m)
            if m > cap and m > self._warned_max:
                self._warned_max = m
                warnings.warn(
                    f"dufo_label{side}: up to {m} dynamic points per sample exceed "
                    f"the SSL dyn_cap budget ({cap}); the extra points lose their "
                    "dynamic-chamfer gradient (forward loss unaffected). Raise "
                    "NNSpec.dyn_cap / seflow_loss(dyn_cap=) or re-check the DUFO "
                    "label density (ops.chamfer.dyn_cap_overflow_stats).")


def check_supported(cfg) -> None:
    """Raise for what the port does not run, instead of doing something
    else: a ``num_devices`` other than the ranks the launcher started
    (``-1``, or 0, takes them all)."""
    check_num_devices(cfg, dist.world())


@dataclass
class FitResult:
    """What :func:`fit` ran to: the last validation metrics (empty without
    a validation split), the final state, the last step's aux (floats), the
    run directory and the stage timer."""

    metrics: Dict[str, float]
    state: TrainState
    last_aux: Dict[str, float]
    run_dir: str
    timer: StageTimer


def fit(cfg, train_ds, val_ds=None, device=None,
        val_batch_size: Optional[int] = None) -> FitResult:
    """Train ``cfg``'s model on ``train_ds`` (``HDF5Dataset`` or a list of
    its items) on ``device`` (``cfg["device"]`` when None; the card unless
    ``"cpu"``), validating on ``val_ds`` in batches of ``val_batch_size``
    (default ``batch_size``).  Under a process group ``batch_size`` is the
    global batch; every rank runs this with the same arguments."""
    dev = resolve_device(device if device is not None else cfg.get("device"))
    check_supported(cfg)
    loss_name = str(cfg["loss_fn"])
    is_ssl = loss_name in SSL_LOSS_REGISTRY
    batch_size = int(cfg["batch_size"])
    world, main_rank = dist.world(), dist.is_main()
    if batch_size % world:
        raise ValueError(
            f"batch_size={batch_size} must divide evenly over {world} devices")
    train_loader = DataLoader(train_ds, batch_size, shuffle=True, seed=int(cfg["seed"]),
                              post_collate=_sorted_prep(cfg),
                              num_workers=int(cfg.get("num_workers", 0)),
                              rank=dist.rank(), world=world)

    model = build_model(cfg["model"], precision=str(cfg.get("precision", "bf16")),
                        device=dev, seed=int(cfg["seed"]),
                        num_frames=int(cfg.get("num_frames", 2)))
    state = init_train_state(model, cfg, dev)

    cfg_dict = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
    # every rank knows the run's directories; rank 0 alone writes there
    logger = MetricLogger(
        project=str(cfg.get("wandb_project", "deflow-tpu")),
        run_name=f"{cfg['model']['name']}-{cfg['slurm_id']}",
        mode=str(cfg.get("wandb_mode", "offline")) if main_rank else "disabled",
        entity=str(cfg.get("wandb_entity", "") or ""),
        output_dir=str(cfg["output_dir"]), config=cfg_dict)
    say = print if main_rank else (lambda *a, **k: None)
    profile_steps = int(cfg.get("profile", 0) or 0) if main_rank else 0
    # host time of each stage: a sync at its stops would serialise the host
    # with the card, and a profile would show idle gaps a run does not have
    timer = StageTimer("Total")
    train_step = make_train_step(model, loss_name, dev, remat=bool(cfg.get("remat", False)))
    eval_step = make_eval_step(model, dev)
    val_cfg = Config(cfg_dict)
    val_cfg["batch_size"] = int(val_batch_size or batch_size)
    monitor = str(cfg["model"].get("val_monitor", "") or "")
    best_keeper = (BestCheckpointKeeper(logger.ckpt_dir, monitor,
                                        mode=str(cfg.get("val_monitor_mode", "min")))
                   if monitor and val_ds is not None else None)
    start_epoch = 0
    if cfg.get("resume"):
        # the keeper's best comes back too, as Lightning's best_model_score
        state, start_epoch = load_checkpoint(str(cfg["resume"]), state, best_keeper)
        say(f"resumed from {cfg['resume']}: epoch {start_epoch} is next")
    elif cfg.get("checkpoint"):
        state = load_weights(str(cfg["checkpoint"]), state)
        say(f"initialized weights from {cfg['checkpoint']}")

    dyn_cap_monitor = DynCapMonitor()
    log_every = int(cfg.get("log_every", 10))
    keys = SSL_TRAIN_KEYS if is_ssl else TRAIN_KEYS
    final_metrics: Dict[str, float] = {}
    prof = None
    frames_seen = global_it = 0
    # frames/s of each log over the frames and seconds since the one before
    # (the first log's since the first step ended: the warm-up left out)
    frames_mark, t_mark = 0, None
    aux = None
    for epoch in range(start_epoch, int(cfg["epochs"])):
        # the shuffle of epoch `epoch`, in a resumed run too
        train_loader.epoch = epoch
        for i, (host_batch, batch) in enumerate(device_prefetch(train_loader, dev,
                                                                keys=keys)):
            if profile_steps and global_it == 2:        # past the warm-up steps
                prof = _start_profile(dev)
            if prof is not None and global_it == 2 + profile_steps:
                _stop_profile(prof, logger.run_dir)
                prof = None
            global_it += 1
            if is_ssl:
                dyn_cap_monitor.check(host_batch)
            with timer.stage("step"):
                state, aux = train_step(state, batch)
            frames_seen += len(host_batch["scene_id"]) * world
            if i % log_every == 0:
                vals = {k: float(v) for k, v in aux.items()}
                now = time.perf_counter()
                fps = (float("nan") if t_mark is None
                       else (frames_seen - frames_mark) / (now - t_mark))
                frames_mark, t_mark = frames_seen, now
                logger.log({
                    "train/loss": vals["loss"], "train/epe": vals["epe"],
                    "train/grad_norm": vals["grad_norm"],
                    "train/frames_per_sec": fps,
                    "epoch": epoch,
                }, step=state.step)
                say(f"epoch {epoch} it {i} loss {vals['loss']:.4f} "
                    f"epe {vals['epe']:.4f}", flush=True)

        if val_ds is not None and (epoch + 1) % int(cfg.get("eval_every", 1)) == 0:
            with timer.stage("val"):
                metrics = run_validation(eval_step, val_ds, val_cfg, dev)
            logger.log({f"val/{k}": v for k, v in metrics.items()}, step=state.step)
            final_metrics = metrics
            say(f"epoch {epoch} val EPE_3way_mean "
                f"{metrics.get('EPE_3way_mean', float('nan')):.4f}", flush=True)
            if best_keeper is not None:
                with timer.stage("ckpt"):
                    path = best_keeper.update(metrics, state, epoch)
                if path:
                    logger.log({f"best/{best_keeper.key}": best_keeper.best},
                               step=state.step)
                    say(f"new best {monitor}={best_keeper.best:.4f}: {path}", flush=True)

        if (epoch + 1) % int(cfg.get("ckpt_every", 1)) == 0:
            with timer.stage("ckpt"):
                path = save_checkpoint(logger.ckpt_dir, state, epoch, keeper=best_keeper)
            say(f"saved checkpoint: {path}", flush=True)

    if prof is not None:
        _stop_profile(prof, logger.run_dir)
    say(timer.report())
    logger.finish()
    return FitResult(final_metrics, state,
                     {} if aux is None else {k: float(v) for k, v in aux.items()},
                     logger.run_dir, timer)


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    take_spans()
    prof.start()
    set_spans(True)
    return prof


def _stop_profile(prof, run_dir: str) -> None:
    set_spans(False)
    prof.stop()
    out = os.path.join(run_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    with open(os.path.join(out, "spans.json"), "w") as f:
        json.dump(take_spans(), f, indent=1, sort_keys=True)
    print(f"profile trace written to {out}")


def main(cfg: Optional[Config] = None, device=None) -> Dict[str, float]:
    """Train from the composed config; returns the last validation
    metrics.  Launched by torchrun, joins its process group first."""
    if cfg is None:
        cfg = from_cli(config_name="config")
    with dist.launched(device if device is not None else cfg.get("device")):
        return _main(cfg, device)


def _main(cfg, device) -> Dict[str, float]:
    dev = resolve_device(device if device is not None else cfg.get("device"))
    check_supported(cfg)
    kw = dict(max_points=int(cfg["max_points"]), remove_ground=bool(cfg["remove_ground"]),
              num_frames=int(cfg.get("num_frames", 2)))
    train_ds = HDF5Dataset(str(cfg["train_data"]), limit=int(cfg.get("overfit", 0)), **kw)
    val_dir = str(cfg["val_data"])
    val_ds = HDF5Dataset(val_dir, **kw) if os.path.isdir(val_dir) else None
    try:
        return fit(cfg, train_ds, val_ds, dev).metrics
    finally:
        train_ds.close()
        if val_ds is not None:
            val_ds.close()


if __name__ == "__main__":
    main()
