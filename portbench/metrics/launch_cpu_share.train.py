"""launch_cpu_share.train: the step's calling thread's CPU seconds over its
wall seconds inside the program's forward and optimizer spans, in %. Read in
--trace 1 runs (lib/stages.py); None for a program without spans."""

from portbench.lib import stages


def read(ctx):
    return stages.read("launch_cpu_share.train", ctx)
