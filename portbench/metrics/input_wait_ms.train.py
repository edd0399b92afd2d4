"""input_wait_ms.train: the harness's span around each next() on the
loader's device_prefetch, in ms a step of the window."""

from portbench.lib.readers import of_mode, span_ms


def read(ctx):
    return span_ms(ctx, "input_wait") if of_mode(ctx, "train") else None
