"""The comparison that decides ``correct`` fails where it must, on the CPU
at a tiny size: the control (the reference computed in float8 e4m3, the
precision below the configurations' bf16, in the program's place) fails
a cell's limits, and a run whose timed path is broken underneath comes
out not correct, once for each fault a train cell can have."""

import pytest
import torch

from conftest import TINY_MODEL
from portbench import calibrate, run

TRAFFIC = {"samples": 8, "slots": 4096, "valid": [3000, 3800]}
CELLS = ["deflow.train-b16", "fastflow3d.train-b16"]


def _tiny(precision):
    return {"model": TINY_MODEL, "traffic": TRAFFIC,
            "train": {"batch_size": 4, "num_workers": 0, "precision": precision}}


def _fails(numbers, limits):
    return any(not numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    limits = run.load_cell(cell)[3]["limits"]
    for seed in (31, 32):
        got = calibrate.readings(cell, seed, "program+fp8", torch.device("cpu"),
                                 _tiny("fp32"))
        control = next(g for g in got if g["kind"] == "fp8")
        assert _fails(control, limits), control


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", [None, "half_batch", "unchanged"])
def test_a_broken_step_is_not_correct(cell, kind):
    """Sound (f32 on the CPU): correct; a step given half its batch, or a
    step that leaves the state unchanged: not correct."""
    with calibrate.fault(kind or "none"):
        result, ctx = run.run_cell(cell, 2 ** 31 + 5, 0.5, False, torch.device("cpu"),
                                   _tiny("fp32"))
    assert result["correct"] is (kind is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert ctx["steps"] >= 1 and "setup_s" in result["metrics"]


def test_the_traced_steps_are_left_out_of_the_timed_steps():
    """The window's steps under the profiler, with its start and stop, count
    in neither ``timed_batches`` nor ``timed_s`` (what ``mfu`` reads)."""
    from portbench.drivers.train import TrainRun
    from portbench.lib.common import Spans

    _, _, config, workload = run.load_cell("deflow.train-b16", _tiny("fp32"))
    r = TrainRun(config, workload, 2 ** 31 + 7, torch.device("cpu"), Spans())
    r.setup_steps(1)
    r.restart()
    win = r.window(0.0, trace_at=4, trace_steps=2)
    r.close()
    assert win["steps"] == 6 and win["traced"]["steps"] == 2
    assert win["timed_batches"] == r.batches[1:5]
    assert r.batches[5:] == win["traced"]["batches"]
    assert 0 < win["timed_s"] < win["window_s"]
