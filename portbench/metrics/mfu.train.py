"""mfu.train: the model's FLOPs of every window step (portbench/counts/flops.py)
over the window's seconds and 989 TFLOP/s (H100 SXM, dense bf16), in %."""

from portbench.lib.readers import mfu, of_mode


def read(ctx):
    return mfu(ctx) if of_mode(ctx, "train") else None
