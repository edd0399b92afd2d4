"""Hierarchical wall-clock stage timers.

The port's own copy of ``deflow_tpu/utils/timer.py``.  The reference
instruments its forward with ``dztimer.Timing()`` (reference
deflow.py:13,38-39,55-95: Total -> {Data Preprocess{pose, transform},
Voxelization, Encoder, Decoder}); ``dztimer`` is not a dependency here.
The card runs asynchronously, so a stage measures host time unless the
timer is given a ``sync_fn`` (``torch.cuda.synchronize``), which it calls
before each stop.

Beside it, named spans at the program's layer boundaries (:func:`span`):
off by default, when each costs one check of a flag; switched on
(:func:`set_spans`, as ``entry.train.fit`` does for its ``profile=k``
steps) each span is a ``torch.profiler.record_function`` range, on the
profiler's timeline with the kernels it launches, and adds to a
process-wide tally per name (count, wall seconds, the entering thread's CPU
seconds) that :func:`take_spans` returns and resets.  Spans nest: a tally
holds its children's time.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

from torch.profiler import record_function

_spans_on = False
_OFF = contextlib.nullcontext()
_tally_lock = threading.Lock()
# name -> [count, wall ns, thread CPU ns]
_tally: Dict[str, List[int]] = {}


class _Span:
    __slots__ = ("name", "range", "wall0", "cpu0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = record_function(self.name).__enter__()
        self.wall0, self.cpu0 = time.perf_counter_ns(), time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter_ns() - self.wall0
        cpu = time.thread_time_ns() - self.cpu0
        self.range.__exit__(*exc)
        with _tally_lock:
            t = _tally.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += wall
            t[2] += cpu
        return False


def span(name: str):
    """A context manager around one pass through a layer of the program:
    while spans are off, a shared no-op; while on, a profiler range named
    ``name`` and one more entry in ``name``'s tally."""
    return _Span(name) if _spans_on else _OFF


def set_spans(on: bool) -> bool:
    """Switch the spans on or off for every thread; returns the previous
    setting."""
    global _spans_on
    was, _spans_on = _spans_on, bool(on)
    return was


def take_spans() -> Dict[str, Dict[str, float]]:
    """The tallies since the last call, ``{name: {"n", "wall_s", "cpu_s"}}``
    (``cpu_s``: the CPU time of the thread that ran the span), and a fresh
    start."""
    global _tally
    with _tally_lock:
        got, _tally = _tally, {}
    return {k: {"n": n, "wall_s": w / 1e9, "cpu_s": c / 1e9} for k, (n, w, c) in got.items()}


class StageTimer:
    """Nested named timers with start/stop and mean/total reporting.

    Usage::

        timer = StageTimer("Total")
        timer.start()
        with timer.stage("Voxelization"):
            ...
        print(timer.report())
    """

    def __init__(self, name: str = "Total", sync_fn: Optional[Callable[[], None]] = None):
        self.name = name
        self.sync_fn = sync_fn
        self.children: Dict[str, "StageTimer"] = {}
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def child(self, name: str) -> "StageTimer":
        if name not in self.children:
            self.children[name] = StageTimer(name, sync_fn=self.sync_fn)
        return self.children[name]

    def start(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            return 0.0
        if self.sync_fn is not None:
            self.sync_fn()
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        self._t0 = None
        return dt

    class _Ctx:
        def __init__(self, timer: "StageTimer"):
            self.timer = timer

        def __enter__(self):
            self.timer.start()
            return self.timer

        def __exit__(self, *exc):
            self.timer.stop()
            return False

    def stage(self, *path: str) -> "_Ctx":
        node = self
        for name in path:
            node = node.child(name)
        return StageTimer._Ctx(node)

    @property
    def total(self) -> float:
        return sum(self.samples)

    @property
    def mean(self) -> float:
        return self.total / len(self.samples) if self.samples else 0.0

    def report(self, indent: int = 0) -> str:
        lines = [
            "%s%-24s total %8.3fs  mean %8.4fs  n=%d"
            % ("  " * indent, self.name, self.total, self.mean, len(self.samples))
        ]
        for ch in self.children.values():
            lines.append(ch.report(indent + 1))
        return "\n".join(lines)

    def as_dict(self, prefix: str = "") -> Dict[str, float]:
        key = f"{prefix}{self.name}"
        out = {key: self.mean}
        for ch in self.children.values():
            out.update(ch.as_dict(prefix=key + "/"))
        return out
