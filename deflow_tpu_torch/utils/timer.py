"""Hierarchical wall-clock stage timers.

The port's own copy of ``deflow_tpu/utils/timer.py``.  The reference
instruments its forward with ``dztimer.Timing()`` (reference
deflow.py:13,38-39,55-95: Total -> {Data Preprocess{pose, transform},
Voxelization, Encoder, Decoder}); ``dztimer`` is not a dependency here.
The card runs asynchronously, so a stage measures host time unless the
timer is given a ``sync_fn`` (``torch.cuda.synchronize``), which it calls
before each stop.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


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
