"""step_ms_p90.train: the 90th percentile of the intervals between
consecutive steps' completion in the window, in ms, on the card's clock: a
CUDA event after each step, the first interval of a run of steps from a
mark on the idle card (the window's start, the end of the profiled steps).
The steps under the profiler, and its start and stop, are left out.  A
per-layer metric: the train cells' steps are paced in part by the host, so
the tail swings from run to run by more than an end-to-end bound may hold."""

from portbench.lib.readers import of_mode, p90_ms


def read(ctx):
    return p90_ms(ctx.get("intervals_ms", [])) if of_mode(ctx, "train") else None
