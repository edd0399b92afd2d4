"""The train cells' loop: the per-step body of the program's train entry
(``deflow_tpu_torch/entry/train.py`` ``fit``), composed from its own
pieces so that it stops at the window's end:

1. ``DataLoader(shuffle=True, post_collate=entry.evaluate._sorted_prep(cfg),
   num_workers=cfg.num_workers)`` over the in-memory pool, epoch after
   epoch (the host prep runs in the loader's thread, inside the ``prep``
   span);
2. ``trainer.device_prefetch(..., keys=TRAIN_KEYS)`` (the ``input_wait``
   span around each ``next``);
3. ``trainer.make_train_step(model, loss_fn, remat=cfg.remat)`` (the
   ``dispatch`` span);
4. every ``log_every`` steps the step's ``aux`` read as floats (the
   ``log_sync`` span).

Set-up builds the one training state that the window then drives: the
model with the benchmark's weights, its optimizer, the loader.  It warms
that state up through the same loop, then copies the seed's weights back
into the model's own tensors and zeroes the optimizer's state in place.
So the window's first ``CHECKED_STEPS`` steps start from the seed's
weights, and the reference follows them (losses, the first gradient as
Adam's first moment holds it, the parameters' change) once the window has
closed and the program's state is freed.

In a traced run the program's own spans (``lib/stages.py``) are on through
the window; their tallies of the window's steps, the profiled ones left
out, are the context's ``program_spans``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np

from portbench.counts.samples import sample_stats
from portbench.lib import stages
from portbench.lib.common import Spans
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference.weights import make_weights
from portbench.traffic.generator import make_pool, sample_index


def port_config(config: Dict, workload: Dict) -> Dict:
    """The program's config: the configuration's model group and train
    settings, then the cell's."""
    run = {**config["train"], **workload.get("run", {})}
    model = dict(config["model"])
    return {**run, "model": model, "voxel_size": model["voxel_size"],
            "point_cloud_range": model["point_cloud_range"]}


def _epochs(loader):
    while True:
        yield from loader


def raw_batch(pool: List[Dict], ids: List[int], device, keys) -> Dict:
    """The pool's samples ``ids`` stacked onto ``device``, as the benchmark
    made them (no host prep): those of ``keys`` the samples have."""
    import torch

    return {k: torch.from_numpy(np.stack([pool[i][k] for i in ids])).to(device)
            for k in keys if k in pool[ids[0]]}


# set-up steps before the window; the window's first steps that the
# reference follows; in a traced run the window's steps under the profiler
# (after the checked ones)
WARMUP_STEPS, CHECKED_STEPS = 4, 3
TRACE_AT, TRACE_STEPS = CHECKED_STEPS + 1, 8

RAW_KEYS = ("pc0", "pc1", "pc0_mask", "pc1_mask", "ego_motion", "flow", "flow_is_valid",
            "flow_category_indices", "dufo_label0", "dufo_label1")


class TrainRun:
    """One cell's training state, loop and checks."""

    def __init__(self, config: Dict, workload: Dict, seed: int, device, spans: Spans,
                 program=None):
        import torch

        from deflow_tpu_torch import trainer
        from deflow_tpu_torch.data.h5dataset import DataLoader
        from deflow_tpu_torch.entry.evaluate import _sorted_prep
        from deflow_tpu_torch.entry.train import DynCapMonitor
        from deflow_tpu_torch.losses import SSL_LOSS_REGISTRY
        from deflow_tpu_torch.models import build_model

        self.torch, self.dev, self.spans, self.seed = torch, device, spans, int(seed)
        self.cfg = cfg = port_config(config, workload)
        self.workload = workload
        self.pool = make_pool(workload["traffic"], seed)
        model = build_model(cfg["model"], precision=str(cfg["precision"]), device=device,
                            num_frames=int(cfg.get("num_frames", 2)))
        self.weights = make_weights(ref_model.param_spec(cfg["model"]), seed, device)
        missing, unexpected = model.load_state_dict(self.weights, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise RuntimeError(f"the benchmark's weights do not fit the program's model: "
                               f"missing {missing}, unexpected {unexpected}")
        self.state = trainer.init_train_state(model, cfg, device)
        self.step = trainer.make_train_step(model, str(cfg["loss_fn"]), device,
                                            remat=bool(cfg["remat"]))
        loader = DataLoader(self.pool, int(cfg["batch_size"]), shuffle=True, seed=self.seed,
                            post_collate=spans.timed("prep", _sorted_prep(cfg)),
                            num_workers=int(cfg["num_workers"]))
        ssl = str(cfg["loss_fn"]) in SSL_LOSS_REGISTRY
        # fit's check of each SSL batch's DUFO density against the budget
        self.monitor = DynCapMonitor() if ssl else None
        self.feed = trainer.device_prefetch(
            _epochs(loader), device, keys=trainer.SSL_TRAIN_KEYS if ssl else trainer.TRAIN_KEYS)
        self.log_every = int(cfg.get("log_every", 10))
        self.k = 0
        self.nonfinite = 0
        self.batches: List[List[int]] = []
        # CUDA events after the timed steps, in runs of consecutive steps;
        # each run starts with a mark recorded on an idle card
        self.segments: List[list] = []
        self.to_check = 0
        # the program's (set_spans, take_spans) where its spans are read;
        # their tallies before the profiled steps, and of the window's steps
        self.program = program
        self.program_before: Dict = {}
        self.program_spans: Dict = {}

    # ---------------------------------------------------------------- loop
    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def mark(self) -> None:
        """Start a new run of timed steps at this point of the stream."""
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.segments.append([ev])

    def one(self, timed: bool = False):
        torch = self.torch
        with self.spans.span("input_wait"):
            host, batch = next(self.feed)
        with self.spans.span("dispatch"):
            if self.monitor is not None:
                self.monitor.check(host)
            self.state, aux = self.step(self.state, batch)
        if self.to_check:
            self.record_checked(aux)
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.segments[-1].append(ev)
        self.batches.append([sample_index(s) for s in host["scene_id"]])
        if self.k % self.log_every == 0:
            with self.spans.span("log_sync"):
                vals = {k: float(v) for k, v in aux.items()}
            self.nonfinite += int(not np.isfinite(vals["loss"]))
        self.k += 1
        return aux

    def setup_steps(self, warmup: int) -> None:
        """The first ``warmup`` steps, which build and warm every kernel and
        shape the window uses."""
        for _ in range(warmup):
            self.one()
        self.sync()

    def restart(self, checked: int = CHECKED_STEPS) -> None:
        """The state back to the seed's, in the tensors the warm-up used:
        the weights and BN statistics copied into the model's own, the
        optimizer's state zeroed in place, the step count at 0.  The next
        ``checked`` steps are the ones the reference follows."""
        torch = self.torch
        model, opt = self.state.model, self.state.optimizer
        with torch.no_grad():
            model.load_state_dict(self.weights, strict=False)
            for name, buf in model.named_buffers():
                if name.endswith("num_batches_tracked"):
                    buf.zero_()
            for st in opt.state.values():
                for v in st.values():
                    if torch.is_tensor(v):
                        v.zero_()
        self.state.step = 0
        self.to_check, self.check_from = checked, len(self.batches)
        self.check_loss: list = []
        self.sync()

    def record_checked(self, aux) -> None:
        """Of a checked step, kept on the card until the window has closed:
        its loss; after the first, each leaf's first moment in Adam (the
        gradient times 1 - beta1); after the last, each leaf's change from
        the seed's weights."""
        torch = self.torch
        self.check_loss.append(aux["loss"])
        named = list(self.state.model.named_parameters())
        with torch.no_grad():
            if len(self.check_loss) == 1:
                state = self.state.optimizer.state
                moments = {n: state[p]["exp_avg"] for n, p in named
                           if "exp_avg" in state.get(p, {})}
                self.check_grad = (list(moments), torch._foreach_norm(list(moments.values()))
                                   if moments else [])
            self.to_check -= 1
            if not self.to_check:
                now = [p.detach().float() for _, p in named]
                was = [self.weights[n] for n, _ in named]
                self.check_change = ([n for n, _ in named],
                                     torch._foreach_norm(torch._foreach_sub(now, was)))
                self.weights = None

    def read_checked(self) -> None:
        """The checked steps' numbers as floats, once the window has closed."""
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        names, norms = self.check_grad
        grads = dict(zip(names, (float(x) / (1 - beta1) for x in norms)))
        self.prog_grad = {n: grads.get(n, 0.0) for n, _ in self.state.model.named_parameters()}
        names, norms = self.check_change
        self.prog_change = dict(zip(names, (float(x) for x in norms)))
        self.prog_loss = [float(x) for x in self.check_loss]
        self.checked_batches = self.batches[self.check_from:self.check_from + CHECKED_STEPS]

    @contextlib.contextmanager
    def spans_on(self):
        """The program's spans on while inside, where they are read; then
        ``program_spans`` holds the tallies of the steps run inside, those
        under the profiler left out."""
        if not self.program:
            yield
            return
        on, take = self.program
        on(True)
        take()
        try:
            yield
        finally:
            on(False)
        self.program_spans = stages.add_tallies(self.program_before, take())

    def window(self, seconds: float, trace_at: int = -1, trace_steps: int = 0) -> Dict:
        """Steps until ``seconds`` have passed and the checked steps have
        run; with ``trace_steps``, steps ``trace_at`` … under torch.profiler.
        The traced steps, with the profiler's start and stop, are left out
        of the step intervals and of ``timed_s`` / ``timed_batches``."""
        torch = self.torch
        cuda = self.dev.type == "cuda"
        first = len(self.batches)
        if cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.mark()
        self.spans.active = True
        traced, traced_s, traced_at = None, 0.0, (first, first)
        t_start = time.perf_counter()
        n = 0
        while (time.perf_counter() - t_start < seconds or self.to_check
               or (trace_steps and traced is None)):
            if trace_steps and traced is None and n == trace_at:
                t0, at = time.perf_counter(), len(self.batches)
                traced = self.traced(trace_steps)
                if cuda:
                    self.mark()
                traced_s, traced_at = time.perf_counter() - t0, (at, len(self.batches))
                n += trace_steps
                continue
            self.one(timed=cuda)
            n += 1
        if cuda:
            torch.cuda.synchronize(self.dev)
        t_end = time.perf_counter()
        self.spans.active = False
        self.read_checked()
        intervals = [a.elapsed_time(b) for seg in self.segments for a, b in zip(seg, seg[1:])]
        batches = self.batches[first:]
        a, b = traced_at
        return {"window_s": t_end - t_start, "steps": n,
                "pairs": sum(len(ids) for ids in batches),
                "intervals_ms": intervals, "traced": traced,
                "timed_s": t_end - t_start - traced_s,
                "timed_batches": self.batches[first:a] + self.batches[b:],
                "peak_bytes": torch.cuda.max_memory_allocated(self.dev) if cuda else 0}

    def traced(self, steps: int) -> Dict:
        """``steps`` steps under the profiler, inside the ``traced_window``
        range, with the wrappers' call counts over them (the trunk's and the
        head's: ``counts.kernels.wrappers``).  A wrapper that the program no
        longer has, or that counts no calls, stops the run."""
        import importlib

        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench.counts.kernels import wrappers

        def counts():
            out = {}
            for name, (mod, fn) in wrappers(self.cfg["model"]).items():
                wrapper = getattr(importlib.import_module(mod), fn, None)
                if not hasattr(wrapper, "launches"):
                    raise RuntimeError(f"kernel_roofline: the program has no call counter "
                                       f"{mod}.{fn}.launches (wrapper {name!r})")
                out[name] = int(wrapper.launches)
            return out

        self.sync()
        if self.program:
            self.program_before = self.program[1]()
        first = len(self.batches)
        before = counts()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        self.spans.profiling = True
        with record_function("traced_window"):
            for _ in range(steps):
                self.one()
            self.sync()
        self.spans.profiling = False
        prof.stop()
        after = counts()
        if self.program:
            self.program[1]()        # the profiled steps' tallies, left out
        return {"prof": prof, "steps": steps, "batches": self.batches[first:],
                "calls": {k: after[k] - before[k] for k in after}}

    def warm_profiler(self) -> None:
        """One set-up step under the profiler, so that its first start is
        not paid inside the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            self.one()
            self.sync()

    # ---------------------------------------------------------------- check
    def close(self) -> None:
        """Stop the loader and free the program's state."""
        self.feed.close()
        self.feed = self.state = self.step = None
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, controls=(), detail: bool = False) -> Dict:
        """The numbers compared with the reference's: the program's (key
        None), and for each of ``controls`` (a lower precision) those of the
        reference computed in it, put in the program's place; ``detail``
        adds each side's worst leaves."""
        batches = [raw_batch(self.pool, ids, self.dev, RAW_KEYS)
                   for ids in self.checked_batches]
        args = (self.cfg["model"], str(self.cfg["loss_fn"]), float(self.cfg["lr"]),
                self.seed, batches, self.dev)
        ref = ref_train.follow(*args)
        prog = {"loss": self.prog_loss, "grad_norm": self.prog_grad,
                "change_norm": self.prog_change}
        sides = {None: prog, **{q: ref_train.follow(*args, quant=q) for q in controls}}
        out = {}
        for q, side in sides.items():
            out[q] = ref_train.compare(side, ref)
            if detail:
                out[q]["worst"] = {key: ref_train.worst_leaves(side, ref, key)
                                   for key in ("grad_norm", "change_norm")}
        return out


def run(config: Dict, workload: Dict, seed: int, seconds: float, trace: bool,
        device, spans: Spans) -> Dict:
    """Set-up, the window, the check; the context the metric readers read."""
    r = TrainRun(config, workload, seed, device, spans,
                 stages.program_spans() if trace else None)
    r.setup_steps(WARMUP_STEPS)
    if trace:
        r.warm_profiler()
    r.restart()
    setup_done = time.perf_counter()
    with r.spans_on():
        win = r.window(seconds, trace_at=TRACE_AT, trace_steps=TRACE_STEPS if trace else 0)
    ctx = {"mode": "train", "cfg": r.cfg, "workload": workload, "setup_end": setup_done,
           "spans": {k: {"s": r.spans.total[k], "n": r.spans.count[k]}
                     for k in r.spans.total},
           "attempted": win["steps"], "failed": r.nonfinite,
           "program_spans": r.program_spans, **win}
    if win["traced"] is not None:
        from portbench.lib.trace import reduce_trace

        prof = win["traced"].pop("prof")
        tr = win["traced"]["trace"] = reduce_trace(prof, r.cfg["model"])
        if tr:
            tr["idle_by_stage"] = stages.idle_by_stage(prof)
    r.close()
    if trace:
        ctx["sample_stats"] = [sample_stats(s, r.cfg["model"]) for s in r.pool]
    ctx["check_run"] = r
    return ctx
