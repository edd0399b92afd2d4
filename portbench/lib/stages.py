"""The program's own spans, read beside the harness's.

The program (``deflow_tpu_torch.utils.timer``) opens named spans at its
layer boundaries: ``deflow/step`` around its train step, one span a stage
inside it (``STAGES``), ``deflow/loader/wait`` around the consumer's wait
for a batch, ``deflow/loader/collate`` and ``deflow/loader/prep`` in the
loader's thread.  Switched on, each is a ``record_function`` range in the
profiler's trace and adds to a tally (count, wall seconds, the thread's CPU
seconds) that ``take_spans`` returns and resets.

Here: the switch and the tallies, found with ``getattr`` (None for a
program without spans); a second labelling of the device's idle gaps, by
the step's stage open at each gap's middle on the step's calling thread
(``trace.reduce_trace`` labels them by the harness's spans and stays as it
is); and the per-layer numbers that read both (:data:`METRICS`).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence, Tuple

STEP = "deflow/step"
STAGES = ("deflow/step/forward", "deflow/step/loss", "deflow/step/backward",
          "deflow/step/all_reduce", "deflow/step/optimizer")
WAIT = "deflow/loader/wait"
PREFIX = "deflow/"
# the idle labels besides the stages: the step outside its stages, the
# consumer's wait for a batch, and the rest
STEP_SELF, OUTSIDE = "deflow/step:self", "outside"


def program_spans():
    """The program's ``(set_spans, take_spans)``, or None where it has no
    spans."""
    try:
        mod = importlib.import_module("deflow_tpu_torch.utils.timer")
    except ImportError:
        return None
    on, take = getattr(mod, "set_spans", None), getattr(mod, "take_spans", None)
    return (on, take) if callable(on) and callable(take) else None


def add_tallies(*parts: Optional[Dict]) -> Dict[str, Dict[str, float]]:
    """The sum of ``take_spans`` results, name by name."""
    out: Dict[str, Dict[str, float]] = {}
    for part in parts:
        for name, t in (part or {}).items():
            acc = out.setdefault(name, {"n": 0, "wall_s": 0.0, "cpu_s": 0.0})
            for k in acc:
                acc[k] += t[k]
    return out


def idle_gaps(t0: float, t1: float, ops: Sequence[Tuple[float, float]]) -> List[tuple]:
    """The intervals of [t0, t1] (and past t1 while an op runs on) that no
    device op of ``ops`` (start, end; sorted by start) covers."""
    gaps, cur = [], float(t0)
    for start, end in ops:
        if start > cur:
            gaps.append((cur, start))
        cur = max(cur, end)
    end_all = max(float(t1), cur)
    if end_all > cur:
        gaps.append((cur, end_all))
    return gaps


def label_by_stage(gaps: Sequence[Tuple[float, float]],
                   ranges: Sequence[Tuple[float, float, str, int]]) -> Dict[str, float]:
    """Idle seconds (times in µs) by what the step's calling thread was in
    at each gap's middle: a stage of ``STAGES``, the step outside them
    (``STEP_SELF``), ``WAIT``, else ``OUTSIDE``.  ``ranges``: the program's
    ranges, (start, end, name, thread); the calling thread is the one that
    ran ``STEP``.  Empty without a ``STEP`` range."""
    threads = {th for _, _, name, th in ranges if name == STEP}
    if not threads:
        return {}
    mine = [r for r in ranges if r[3] in threads and r[2] in (STEP, WAIT, *STAGES)]
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = {name for s, e, name, _ in mine if s <= mid <= e}
        stage = next((s for s in STAGES if s in open_), None)
        label = (stage or (STEP_SELF if STEP in open_ else WAIT if WAIT in open_
                           else OUTSIDE))
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


def trace_ranges(prof) -> Tuple[float, float, list, list]:
    """Of a profiler run with the harness's ``traced_window`` range: its
    start and end (µs), its device ops (start, end; sorted) as
    ``trace.reduce_trace`` counts them, the program's ranges ``(start,
    end, name, thread)`` on the host (empty without a window)."""
    from torch.autograd import DeviceType

    from portbench.lib.trace import device_ops

    events = prof.events()
    win = [e for e in events if e.name == "traced_window"]
    if not win:
        return 0.0, 0.0, [], []
    t0 = min(e.time_range.start for e in win)
    t1 = max(e.time_range.end for e in win)
    ops = [(a, b) for a, b, _ in device_ops(events, t0, t1)]
    ranges = [(e.time_range.start, e.time_range.end, e.name, e.thread) for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)
              and e.time_range.end >= t0 and e.time_range.start <= t1]
    return float(t0), float(t1), ops, ranges


def idle_by_stage(prof) -> Dict[str, float]:
    """The traced window's idle seconds by :func:`label_by_stage`."""
    t0, t1, ops, ranges = trace_ranges(prof)
    return label_by_stage(idle_gaps(t0, t1, ops), ranges)


def _ms_each(name):
    def read(ctx):
        t = (ctx.get("program_spans") or {}).get(name)
        return t["wall_s"] / t["n"] * 1e3 if t and t["n"] else None
    return read


def _cpu_share(ctx):
    """The calling thread's CPU seconds over its wall seconds inside the
    forward and the optimizer, in %."""
    spans = ctx.get("program_spans") or {}
    got = [spans[s] for s in ("deflow/step/forward", "deflow/step/optimizer") if s in spans]
    wall = sum(t["wall_s"] for t in got)
    return 100.0 * sum(t["cpu_s"] for t in got) / wall if len(got) == 2 and wall else None


def _idle_ms(label):
    def read(ctx):
        traced = ctx.get("traced") or {}
        idle = (traced.get("trace") or {}).get("idle_by_stage")
        if not idle or not traced.get("steps"):
            return None
        return idle.get(label, 0.0) / traced["steps"] * 1e3
    return read


# name -> reader of a context that holds ``program_spans`` (the tallies of
# the window's steps, the profiled ones left out) and
# ``traced.trace.idle_by_stage`` with ``traced.steps``; None where the
# program has no spans
METRICS = {
    "loader_wait_ms.train": _ms_each(WAIT),
    "host_prep_ms.train": _ms_each("deflow/loader/prep"),
    "forward_ms.train": _ms_each("deflow/step/forward"),
    "backward_ms.train": _ms_each("deflow/step/backward"),
    "optimizer_ms.train": _ms_each("deflow/step/optimizer"),
    "launch_cpu_share.train": _cpu_share,
    "idle_forward_ms.train": _idle_ms("deflow/step/forward"),
    "idle_backward_ms.train": _idle_ms("deflow/step/backward"),
    "idle_optimizer_ms.train": _idle_ms("deflow/step/optimizer"),
}


def read(name: str, ctx) -> Optional[float]:
    """Metric ``name`` of :data:`METRICS` read from ``ctx``."""
    return METRICS[name](ctx)
