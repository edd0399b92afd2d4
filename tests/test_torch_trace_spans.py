"""The program's spans (``deflow_tpu_torch.utils.timer.span``) on the CPU:
where the train step, the model and the loader open them, how they nest
under ``torch.profiler``, and that with spans off they record nothing,
enter no profiler range and leave the step's numbers bit for bit as they
are with spans on.

Shapes are those of ``tests/test_torch_train_entry.py`` (B = 2, N = 512,
32² grid, 4 GRU iterations); torch runs on one thread."""

import json
import math
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, record_function

from deflow_tpu_torch import trainer as TT
from deflow_tpu_torch.config import compose
from deflow_tpu_torch.data.h5dataset import DataLoader
from deflow_tpu_torch.entry import train as TE
from deflow_tpu_torch.utils import timer

from test_torch_train_entry import _prepped, _same_state, _small_samples, _small_state
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

STAGES = ("deflow/step/forward", "deflow/step/loss", "deflow/step/backward",
          "deflow/step/all_reduce", "deflow/step/optimizer")
MODEL = ("deflow/embed", "deflow/unet", "deflow/head")


@pytest.fixture
def spans_on():
    timer.take_spans()
    was = timer.set_spans(True)
    yield
    timer.set_spans(was)
    timer.take_spans()


def test_the_tallies_lose_no_span_across_threads(spans_on):
    """More threads than cores open spans at once, with the interpreter
    switching threads as often as it can: every span is counted."""
    threads, each = 2 * (os.cpu_count() or 4), 300

    def work():
        for _ in range(each):
            with timer.span("a"):
                with timer.span("b"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = timer.take_spans()
    assert got["a"]["n"] == got["b"]["n"] == threads * each
    assert got["a"]["wall_s"] >= got["b"]["wall_s"]


def _step(remat, seed=3):
    state = _small_state(seed)
    return state, TT.make_train_step(state.model, "deflowLoss", device="cpu", remat=remat)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_a_step_records_each_step_span_once(spans_on, remat):
    """One step: the step and each of its stages once; the model's spans
    once in the forward, and once more in the backward's recompute under
    remat; each tally's wall and CPU time non-negative, a stage's inside the
    step's."""
    state, step = _step(remat)
    hb = _prepped(11)
    timer.take_spans()
    step(state, hb)
    got = timer.take_spans()
    assert got["deflow/step"]["n"] == 1
    for name in STAGES:
        assert got[name]["n"] == 1, name
    for name in MODEL:
        assert got[name]["n"] == (2 if remat else 1), name
    assert not set(got) - {"deflow/step", *STAGES, *MODEL}
    for v in got.values():
        assert v["wall_s"] >= 0 and v["cpu_s"] >= 0
    assert sum(got[s]["wall_s"] for s in STAGES) <= got["deflow/step"]["wall_s"]
    if not remat:
        assert sum(got[m]["wall_s"] for m in MODEL) <= got["deflow/step/forward"]["wall_s"]
    assert timer.take_spans() == {}


def _ranges(prof, names):
    """(start, end, thread) of every profiler range named in ``names``."""
    out = {}
    for e in prof.events():
        if e.name in names:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end,
                                               e.thread))
    return out


def _inside(inner, outer):
    return (inner[2] == outer[2] and outer[0] <= inner[0] and inner[1] <= outer[1])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_the_ranges_nest_under_the_profiler(spans_on, remat):
    """Under a CPU ``torch.profiler``: the step's range holds each stage's,
    on the calling thread; the forward holds the model's ranges, and under
    remat the backward holds their second run."""
    state, step = _step(remat)
    hb = _prepped(12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, hb)
    r = _ranges(prof, {"deflow/step", *STAGES, *MODEL})
    (outer,) = r["deflow/step"]
    for name in STAGES:
        (stage,) = r[name]
        assert _inside(stage, outer), name
    fwd, bwd = r["deflow/step/forward"][0], r["deflow/step/backward"][0]
    for name in MODEL:
        runs = sorted(r[name])
        assert len(runs) == (2 if remat else 1), name
        assert _inside(runs[0], fwd), name
        if remat:
            assert _inside(runs[1], bwd), name


def test_the_loader_records_collate_and_prep_on_its_thread(spans_on):
    """An epoch of a ``DataLoader`` with two decode workers: ``collate`` and
    ``prep`` once a batch, both in the loader's thread (a profiler of every
    thread sees them); the consumer's ``deflow/loader/wait`` once a batch in
    the calling thread."""
    samples = _small_samples(6)
    loader = DataLoader(samples, 2, num_workers=2, post_collate=lambda b: b)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        with record_function("caller"):
            got = list(TT.device_prefetch(loader, "cpu"))
    assert len(got) == 3
    tally = timer.take_spans()
    assert tally["deflow/loader/collate"]["n"] == 3
    assert tally["deflow/loader/prep"]["n"] == 3
    # three batches and the end of the epoch
    assert tally["deflow/loader/wait"]["n"] == 4
    r = _ranges(prof, {"caller", "deflow/loader/collate", "deflow/loader/prep",
                       "deflow/loader/wait"})
    (caller,) = r["caller"]
    loader_threads = {t for name in ("deflow/loader/collate", "deflow/loader/prep")
                      for _, _, t in r[name]}
    assert len(loader_threads) == 1 and caller[2] not in loader_threads
    assert all(_inside(w, caller) for w in r["deflow/loader/wait"])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_spans_off_record_nothing_and_change_no_number(monkeypatch, remat):
    """Two steps and a loader epoch with spans off: no tally, and no
    profiler range entered (``record_function`` raises if it is); the same
    steps with spans on give the same aux, parameters, optimizer state and
    BN statistics, bit for bit."""
    timer.set_spans(False)
    timer.take_spans()

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with spans off")

    batches = [_prepped(20 + s) for s in range(2)]
    runs = []
    for on in (False, True):
        state, step = _step(remat, seed=4)
        with monkeypatch.context() as m:
            if not on:
                m.setattr(timer, "record_function", refuse)
            timer.set_spans(on)
            try:
                auxes = [dict(step(state, hb)[1]) for hb in batches]
                list(DataLoader(_small_samples(4), 2, num_workers=2,
                                post_collate=lambda b: b))
            finally:
                timer.set_spans(False)
        tally = timer.take_spans()
        assert bool(tally) == on
        runs.append((state, auxes))
    (off, aux_off), (on, aux_on) = runs
    _same_state(off, on)
    for a, b in zip(aux_off, aux_on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_fit_profiles_with_spans_and_logs_frames_since_the_last_log(tmp_path):
    """``fit(profile=1)``: the profiled step's ranges in ``trace.json``, its
    tallies in ``spans.json``, the spans off again after it; frames/s of
    each log over the frames and seconds since the log before (the first
    log has none before it)."""
    cfg = compose("config", [
        "batch_size=2", "epochs=1", "num_workers=0", "max_points=512",
        "voxel_size=[3.2, 3.2, 6]", "model.target.num_iters=2",
        "model.target.grid_feature_size=[32, 32]", "precision=fp32", "log_every=2",
        "remat=false", "profile=1", f"output_dir={tmp_path}", "device=cpu",
        "wandb_mode=offline"])
    timer.take_spans()
    res = TE.fit(cfg, _small_samples(10))
    assert res.state.step == 5
    assert timer.set_spans(False) is False and timer.take_spans() == {}
    out = os.path.join(res.run_dir, "profile")
    with open(os.path.join(out, "spans.json")) as f:
        tally = json.load(f)
    assert tally["deflow/step"]["n"] == 1 and tally["deflow/step/forward"]["n"] == 1
    with open(os.path.join(out, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"deflow/step", *STAGES, *MODEL} <= names
    with open(os.path.join(res.run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    fps = [r["train/frames_per_sec"] for r in recs if "train/loss" in r]
    assert len(fps) == 3 and math.isnan(fps[0])
    assert all(np.isfinite(x) and x > 0 for x in fps[1:])
    assert res.timer.sync_fn is None and len(res.timer.child("step").samples) == 5
