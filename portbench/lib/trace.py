"""Reduction of a torch.profiler trace of the traced steps to the numbers
the per-layer metrics read.

The arithmetic of the repository's ``chip_smoke.profile_step``, applied
to a window of steps: device operations (kernels, memcpys, memsets; not
annotation ranges, such as the optimizer's or the program's spans) that
start inside the harness's ``traced_window`` range; busy time as the union
of their intervals; idle gaps between them, each labelled with the harness
span the host was in at the gap's middle.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench.counts.kernels import kernel_of

# the main thread's spans (one at a time); ``prep`` runs in the loader's thread
HOST_SPANS = ("input_wait", "dispatch", "log_sync")
# ranges that the profiler also puts on the device's timeline: the
# optimizer's and the program's spans (``lib/stages.py``)
ANNOTATIONS = ("Optimizer.", "deflow/")


def device_ops(events, t0: float, t1: float) -> list:
    """The device operations among ``events`` that start in [t0, t1), as
    (start, end, name) sorted by start."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CUDA
                  and t0 <= e.time_range.start < t1
                  and not getattr(e, "is_user_annotation", False)
                  and e.name != "traced_window"
                  and not e.name.startswith(ANNOTATIONS))


def reduce_trace(prof, cfg: Optional[Dict] = None) -> Dict:
    """busy_s, window_s, ops, by_name (device s), by_kernel (device s of the
    hand-written kernels' wrappers: the trunk's and those of ``cfg``'s head,
    or of every head), idle_gaps ([label, s], longest first),
    idle_by_span."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events if e.name == "traced_window"]
    if not win:
        return {}
    t0 = min(e.time_range.start for e in win)
    t1 = max(e.time_range.end for e in win)
    spans = device_ops(events, t0, t1)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.name in HOST_SPANS
                  and e.time_range.end >= t0 and e.time_range.start <= t1)
    by_name: Dict[str, float] = {}
    by_kernel: Dict[str, float] = {}
    busy, cur = 0.0, float(t0)
    gaps: List[tuple] = []
    for start, end, name in spans:
        dt = (end - start) / 1e6
        by_name[name] = by_name.get(name, 0.0) + dt
        k = kernel_of(name, cfg)
        if k is not None:
            by_kernel[k] = by_kernel.get(k, 0.0) + dt
        if start > cur:
            gaps.append((cur, start))
        busy += max(0.0, end - max(start, cur)) / 1e6
        cur = max(cur, end)
    end_all = max(float(t1), cur)
    if end_all > cur:
        gaps.append((cur, end_all))
    labelled = []
    idle_by_span: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "other"
        for hs, he, hn in host:
            if hs <= mid <= he:
                label = hn
        s = (b - a) / 1e6
        labelled.append([label, s])
        idle_by_span[label] = idle_by_span.get(label, 0.0) + s
    labelled.sort(key=lambda g: -g[1])
    return {"busy_s": busy, "window_s": (end_all - t0) / 1e6, "ops": len(spans),
            "by_name": by_name, "by_kernel": by_kernel, "idle_gaps": labelled,
            "idle_by_span": idle_by_span}


def breakdown(tr: Dict) -> Dict:
    """The result line's ``breakdown``: the 10 device operations that took
    most time, and the idle time by host span followed by the longest
    single gaps (10 entries at most)."""
    ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr["idle_by_span"].items(), key=lambda kv: -kv[1])
    idle = [[f"all:{k}", v] for k, v in idle]
    idle += [[f"longest:{k}", v] for k, v in tr["idle_gaps"][:10 - len(idle)]]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle[:10]}
