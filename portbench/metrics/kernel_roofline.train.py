"""kernel_roofline.train: the hand-written kernels' bound time from the step's
shapes (portbench/counts/kernels.py) over their device time in the traced
steps, in %."""

from portbench.lib.readers import kernel_roofline, of_mode


def read(ctx):
    return kernel_roofline(ctx) if of_mode(ctx, "train") else None
