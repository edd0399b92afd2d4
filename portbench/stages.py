"""A train cell's host time and the card's idle time split by the program's
step stages, from the program's own spans, in one process.

    python3 portbench/stages.py --workload <cell> --seed <n> --seconds <s> --spans <0|1>

Set-up, the restart and the window run as in a ``--trace 1`` benchmark run
(``drivers/train.py``: 8 steps under torch.profiler after the checked
ones), with the program's spans (``lib/stages.py``) on through the window
when ``--spans 1``.  Printed, one JSON line: the harness's spans (ms a step,
of the window's steps without the profiled ones, as ``run.py``'s ``host``
reads them over all), the program's spans in the same steps (ms each, the
thread's CPU ms each), the device's busy and idle share and ops a step of
the profiled steps, their idle ms a step by the harness's spans and by the
program's stages, and the per-layer numbers of ``lib/stages.METRICS``.
``--spans 0`` gives the same without the program's numbers: the spans'
overhead is the difference.  The comparison with the reference is not
run.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(cell: str, seed: int, seconds: float, spans: bool, device,
            overrides=None):
    """The numbers of one run (see the module's docstring)."""
    import torch

    from portbench import run
    from portbench.drivers.train import TRACE_AT, TRACE_STEPS, WARMUP_STEPS, TrainRun
    from portbench.lib import stages
    from portbench.lib.common import Spans, power_limit
    from portbench.lib.trace import reduce_trace

    _, _, config, workload = run.load_cell(cell, overrides)
    parts = {}

    class StagedRun(TrainRun):
        def traced(self, steps):
            harness = {k: (self.spans.total[k], self.spans.count[k]) for k in self.spans.total}
            out = super().traced(steps)
            parts["harness"] = {k: (self.spans.total[k] - harness.get(k, (0, 0))[0],
                                    self.spans.count[k] - harness.get(k, (0, 0))[1])
                                for k in self.spans.total}
            prof = out.pop("prof")
            out["trace"] = reduce_trace(prof)
            out["trace"]["idle_by_stage"] = stages.idle_by_stage(prof)
            return out

    r = StagedRun(config, workload, seed, device, Spans(),
                  stages.program_spans() if spans else None)
    r.setup_steps(WARMUP_STEPS)
    r.warm_profiler()
    r.restart()
    with r.spans_on():
        win = r.window(seconds, trace_at=TRACE_AT, trace_steps=TRACE_STEPS)
    r.close()
    traced, tr = win["traced"], win["traced"]["trace"]
    n_traced = traced["steps"]
    harness = {}
    for k, total in r.spans.total.items():
        s, n = parts["harness"].get(k, (0.0, 0))
        if r.spans.count[k] - n:
            harness[f"{k}_ms"] = (total - s) / (r.spans.count[k] - n) * 1e3
    tally = r.program_spans
    ctx = {"program_spans": tally, "traced": traced}
    step = tally.get(stages.STEP)
    inner = [tally[s] for s in stages.STAGES if s in tally]
    return {
        "cell": cell, "seed": seed, "spans": bool(spans),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   power_limit()),
        "steps": win["steps"], "profiled_steps": n_traced,
        "harness_ms": harness,
        "program_ms": {k: t["wall_s"] / t["n"] * 1e3 for k, t in tally.items() if t["n"]},
        "program_cpu_ms": {k: t["cpu_s"] / t["n"] * 1e3 for k, t in tally.items() if t["n"]},
        "program_n": {k: t["n"] for k, t in tally.items()},
        "step_self_ms": ((step["wall_s"] - sum(t["wall_s"] for t in inner)) / step["n"] * 1e3
                         if step and step["n"] else None),
        "busy_ms": tr["busy_s"] / n_traced * 1e3, "window_ms": tr["window_s"] / n_traced * 1e3,
        "idle_share": 100.0 * (1 - tr["busy_s"] / tr["window_s"]) if tr["window_s"] else None,
        "ops_per_step": tr["ops"] / n_traced,
        "idle_ms_by_span": {k: v / n_traced * 1e3 for k, v in tr["idle_by_span"].items()},
        "idle_ms_by_stage": {k: v / n_traced * 1e3 for k, v in tr["idle_by_stage"].items()},
        "metrics": {name: stages.read(name, ctx) for name in stages.METRICS},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("portbench.stages: needs a CUDA card", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    got = measure(args.workload, args.seed, args.seconds, bool(args.spans),
                  torch.device("cuda", 0))
    got["run_s"] = time.perf_counter() - t0
    print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
