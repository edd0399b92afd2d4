"""Arithmetic the metric readers share: each returns None where the run
has nothing to read."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from portbench.counts import flops, kernels

H100_BF16_FLOP_PER_S = 989e12   # NVIDIA H100 SXM data sheet, dense bf16


def of_mode(ctx: Dict, mode: str) -> bool:
    return ctx.get("mode") == mode


def p90_ms(intervals) -> Optional[float]:
    """The 90th percentile (``statistics.quantiles``, exclusive) of all
    intervals, given ten or more."""
    if len(intervals) < 10:
        return None
    return statistics.quantiles(intervals, n=10)[8]


def trace(ctx: Dict) -> Optional[Dict]:
    t = ctx.get("traced") or {}
    return t.get("trace") or None


def idle_share(ctx: Dict) -> Optional[float]:
    tr = trace(ctx)
    if not tr or tr["window_s"] <= 0 or tr["ops"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def ops_per_step(ctx: Dict) -> Optional[float]:
    tr = trace(ctx)
    if not tr or not tr["ops"]:
        return None
    return tr["ops"] / ctx["traced"]["steps"]


def mfu(ctx: Dict) -> Optional[float]:
    """Model FLOPs of the window's steps over their seconds and the bf16
    peak, in %; the traced steps and the profiler's start and stop are
    left out of both."""
    stats = ctx.get("sample_stats")
    if not stats or not ctx.get("timed_s"):
        return None
    mode, cfg = ctx["mode"], ctx["cfg"]["model"]
    total = sum(flops.batch_flops(cfg, mode, [stats[i] for i in ids])
                for ids in ctx["timed_batches"])
    return 100.0 * total / ctx["timed_s"] / H100_BF16_FLOP_PER_S


def kernel_roofline(ctx: Dict) -> Optional[float]:
    """The hand-written kernels' summed bound time over their summed device
    time in the traced steps, in %.  A wrapper counts where the step's
    shapes give it calls; its bound is the mean bound of those calls times
    the calls its counter counted.  A wrapper whose counter counted calls
    while the trace shows none of its kernels, or the other way round,
    stops the run: a renamed kernel or counter would otherwise change the
    mix unseen.  One with neither is off this step's path."""
    tr, stats = trace(ctx), ctx.get("sample_stats")
    if not tr or not stats:
        return None
    cfg, traced = ctx["cfg"], ctx["traced"]
    calls, by_kernel = traced["calls"], tr["by_kernel"]
    for name in sorted(set(calls) | set(by_kernel)):
        seen, dev_s = calls.get(name, 0), by_kernel.get(name, 0.0)
        if (seen > 0) != (dev_s > 0):
            raise RuntimeError(f"kernel_roofline: wrapper {name!r} counted {seen} calls "
                               f"and the trace shows {dev_s} s of its kernels")
    slots = int(ctx["workload"]["traffic"].get("slots", 98304))
    expected: Dict[str, list] = {}
    for ids in traced["batches"]:
        step = kernels.step_calls(cfg["model"], ctx["mode"], bool(cfg.get("remat")),
                                  [stats[i] for i in ids], slots)
        for name, s in step:
            expected.setdefault(name, []).append(s)
    bound = device = 0.0
    for name, times in expected.items():
        if calls.get(name, 0):
            bound += sum(times) / len(times) * calls[name]
            device += by_kernel[name]
    if device <= 0:
        return None
    return 100.0 * bound / device
