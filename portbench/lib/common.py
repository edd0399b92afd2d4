"""What every driver shares: host spans, the card's description, and the
context that the metric readers read."""

from __future__ import annotations

import contextlib
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict


class Spans:
    """Host spans of the harness around its calls into the program: the
    total seconds and the count of each name, taken while ``active``; under
    ``profiling`` each span is also a ``record_function`` range, so the
    trace can label the device's idle gaps."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.active = False
        self.profiling = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function(name)
        t0 = time.perf_counter()
        with rf:
            yield
        dt = time.perf_counter() - t0
        if self.active:
            with self._lock:
                self.total[name] += dt
                self.count[name] += 1

    def timed(self, name: str, fn):
        """``fn`` with each call inside the span ``name``."""
        def call(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return call


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def device_info(torch, chips: int, peak_bytes: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0)
            if torch.cuda.is_available() else "cpu",
            "count": chips, "memory_peak_bytes": int(peak_bytes),
            "power_limit": power_limit()}
