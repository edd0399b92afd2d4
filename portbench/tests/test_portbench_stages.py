"""The program's spans as the harness reads them (``portbench/lib/stages.py``,
``portbench/stages.py``, ``portbench/drivers/train.py``): the idle labelling
by step stage on a hand-built trace, the readers on hand-built tallies, and
runs at a tiny size on the CPU with the program's spans, and without them as
a program that has none reads."""

from types import SimpleNamespace

import pytest
import torch

from conftest import TINY_MODEL
from portbench import run
from portbench import stages as tool
from portbench.lib import stages
from portbench.lib.trace import reduce_trace

TINY = {"model": TINY_MODEL, "traffic": {"samples": 8, "slots": 4096, "valid": [3000, 3800]},
        "train": {"batch_size": 4, "num_workers": 0, "precision": "fp32"}}


def test_idle_is_labelled_by_the_stage_open_on_the_calling_thread():
    """Times in µs.  The step on thread 1 over [0, 100] with its forward,
    backward and optimizer; the loader's wait after it; a loader range on
    thread 2 that spans everything and labels nothing."""
    ranges = [(0, 100, stages.STEP, 1), (5, 40, "deflow/step/forward", 1),
              (10, 30, "deflow/embed", 1), (50, 80, "deflow/step/backward", 1),
              (85, 95, "deflow/step/optimizer", 1), (100, 120, stages.WAIT, 1),
              (-50, 500, "deflow/loader/prep", 2)]
    ops = [(0, 20), (18, 25), (30, 45), (49, 60), (70, 86), (96, 104), (130, 140)]
    gaps = stages.idle_gaps(0, 150, ops)
    assert gaps == [(25, 30), (45, 49), (60, 70), (86, 96), (104, 130), (140, 150)]
    got = stages.label_by_stage(gaps, ranges)
    want = {"deflow/step/forward": 5, stages.STEP_SELF: 4, "deflow/step/backward": 10,
            "deflow/step/optimizer": 10, stages.WAIT: 26, stages.OUTSIDE: 10}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v / 1e6), k
    # the labels share out all the idle time
    assert sum(got.values()) == pytest.approx(sum(b - a for a, b in gaps) / 1e6)
    # a trace without the step's range labels nothing
    assert stages.label_by_stage(gaps, ranges[1:]) == {}


def test_the_readers_read_the_tallies_and_the_labelled_idle():
    spans = {"deflow/step/forward": {"n": 4, "wall_s": 0.4, "cpu_s": 0.3},
             "deflow/step/backward": {"n": 4, "wall_s": 0.2, "cpu_s": 0.2},
             "deflow/step/optimizer": {"n": 4, "wall_s": 0.1, "cpu_s": 0.1},
             stages.WAIT: {"n": 5, "wall_s": 0.01, "cpu_s": 0.001},
             "deflow/loader/prep": {"n": 6, "wall_s": 1.2, "cpu_s": 2.0}}
    ctx = {"program_spans": spans,
           "traced": {"steps": 8, "trace": {"idle_by_stage": {
               "deflow/step/forward": 0.16, "deflow/step/backward": 0.08}}}}
    got = {name: stages.read(name, ctx) for name in stages.METRICS}
    want = {"loader_wait_ms.train": 2.0, "host_prep_ms.train": 200.0,
            "forward_ms.train": 100.0, "backward_ms.train": 50.0,
            "optimizer_ms.train": 25.0, "launch_cpu_share.train": 80.0,
            "idle_forward_ms.train": 20.0, "idle_backward_ms.train": 10.0,
            "idle_optimizer_ms.train": 0.0}
    assert got == pytest.approx(want)
    assert stages.add_tallies(spans, spans)["deflow/step/forward"] == pytest.approx(
        {"n": 8, "wall_s": 0.8, "cpu_s": 0.6})


@pytest.mark.parametrize("ctx", [{}, {"program_spans": {}, "traced": {"steps": 8, "trace": {}}},
                                 {"program_spans": None, "traced": None}],
                         ids=["nothing", "empty", "none"])
def test_the_readers_give_none_without_the_programs_spans(ctx):
    assert all(stages.read(name, ctx) is None for name in stages.METRICS)


def test_a_program_without_spans_has_no_switch(monkeypatch):
    from deflow_tpu_torch.utils import timer

    assert stages.program_spans() == (timer.set_spans, timer.take_spans)
    monkeypatch.delattr(timer, "take_spans")
    assert stages.program_spans() is None


@pytest.mark.parametrize("spans", [True, False], ids=["spans", "no_spans"])
def test_a_tiny_run_on_the_cpu(monkeypatch, spans):
    """The tool at a tiny size: with spans, each step span once a window
    step outside the profiled ones and every reader reads; without them
    (a program with no spans reads the same) no reader reads, the harness's
    numbers are there, and the spans stay off."""
    from deflow_tpu_torch.utils import timer

    if not spans:
        monkeypatch.setattr(stages, "program_spans", lambda: None)
    got = tool.measure("deflow.train-b16", 2 ** 31 + 9, 0.0, True, torch.device("cpu"), TINY)
    assert timer.set_spans(False) is False and timer.take_spans() == {}
    assert got["profiled_steps"] == 8 and got["steps"] >= 8 + 3
    assert {"input_wait_ms", "dispatch_ms", "prep_ms"} <= set(got["harness_ms"])
    assert got["idle_ms_by_span"] and got["ops_per_step"] == 0
    metrics = got["metrics"]
    if not spans:
        assert all(v is None for v in metrics.values()) and got["program_n"] == {}
        assert got["idle_ms_by_stage"] == {}
        return
    assert all(v is not None for v in metrics.values()), metrics
    window = got["steps"] - got["profiled_steps"]
    n = got["program_n"]
    assert n[stages.STEP] == window
    assert all(n[s] == window for s in stages.STAGES)
    assert n[stages.WAIT] == window
    # the CPU has no device ops: the window is one idle gap
    assert sum(got["idle_ms_by_stage"].values()) == pytest.approx(got["window_ms"])
    assert 0 < metrics["launch_cpu_share.train"] <= 100 + 5


def test_the_programs_spans_are_no_device_ops():
    """A hand-built trace (times in µs) in which the program's spans and the
    optimizer's range lie on the device's timeline, as the profiler may put
    them: ``reduce_trace`` counts neither as a device op, busy time or
    cover of an idle gap, and the stage labelling sees the same ops."""
    from torch.autograd import DeviceType

    def ev(name, device, start, end):
        return SimpleNamespace(name=name, device_type=device, thread=1,
                               time_range=SimpleNamespace(start=start, end=end))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev("traced_window", cpu, 0, 100), ev("dispatch", cpu, 0, 100),
              ev(stages.STEP, cpu, 0, 100), ev("deflow/step/forward", cpu, 5, 45),
              ev(stages.STEP, cuda, 0, 100), ev("deflow/step/forward", cuda, 5, 45),
              ev("deflow/embed", cuda, 10, 30), ev("Optimizer.step#Adam.step", cuda, 80, 95),
              ev("segment_sum_kernel", cuda, 10, 30), ev("gemm", cuda, 50, 60)]
    prof = SimpleNamespace(events=lambda: events)
    tr = reduce_trace(prof)
    assert tr["ops"] == 2 and set(tr["by_name"]) == {"segment_sum_kernel", "gemm"}
    assert tr["busy_s"] == pytest.approx(30e-6) and tr["window_s"] == pytest.approx(100e-6)
    assert tr["idle_by_span"] == pytest.approx({"dispatch": 70e-6})
    assert stages.trace_ranges(prof)[2] == [(10, 30), (50, 60)]
    assert stages.idle_by_stage(prof) == pytest.approx(
        {"deflow/step/forward": 30e-6, stages.STEP_SELF: 40e-6})


@pytest.mark.parametrize("trace,spans", [(True, True), (True, False), (False, True)],
                         ids=["trace1", "trace1_no_spans", "trace0"])
def test_a_tiny_benchmark_run_reads_the_stage_metrics(monkeypatch, trace, spans):
    """``run_cell`` at a tiny size on the CPU: a ``--trace 1`` run switches the
    program's spans on for its window and off after it, and reports the six
    span metrics as numbers; for a program without spans all nine are None
    and left out of the line; a ``--trace 0`` run never asks for the spans."""
    from deflow_tpu_torch.utils import timer

    asked, switched = [], []

    def program_spans():
        asked.append(True)
        if not spans:
            return None

        def on(flag):
            switched.append(bool(flag))
            return timer.set_spans(flag)
        return on, timer.take_spans

    monkeypatch.setattr(stages, "program_spans", program_spans)
    result, ctx = run.run_cell("deflow.train-b16", 2 ** 31 + 11, 0.0, trace,
                               torch.device("cpu"), TINY)
    assert result["correct"], result["checks"]
    assert timer.set_spans(False) is False and timer.take_spans() == {}
    metrics = result["metrics"]
    if not trace:
        assert asked == [] and switched == [] and ctx["program_spans"] == {}
        assert "train_pairs_per_s" in metrics
        return
    assert asked == [True]
    if not spans:
        assert switched == [] and ctx["program_spans"] == {}
        assert all(stages.read(name, ctx) is None for name in stages.METRICS)
        assert not set(metrics) & set(stages.METRICS)
        assert "mfu.train" in metrics
        return
    assert switched == [True, False]
    for name in stages.METRICS:
        if not name.startswith("idle_"):
            assert isinstance(metrics[name]["value"], float), name
    # each step span once a window step outside the profiled ones
    window = ctx["steps"] - ctx["traced"]["steps"]
    assert ctx["program_spans"][stages.STEP]["n"] == window
