"""idle_share.train: 1 minus the union of device activity over the traced
window's wall time, in %."""

from portbench.lib.readers import idle_share, of_mode


def read(ctx):
    return idle_share(ctx) if of_mode(ctx, "train") else None
