"""device_ops_per_step.train: kernels, memcpys and memsets in the traced
steps' profile, over those steps."""

from portbench.lib.readers import of_mode, ops_per_step


def read(ctx):
    return ops_per_step(ctx) if of_mode(ctx, "train") else None
