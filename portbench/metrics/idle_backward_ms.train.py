"""idle_backward_ms.train: device idle time in the profiled steps whose gap's
middle falls in the program's span deflow/step/backward, in ms a step. Read
in --trace 1 runs (lib/stages.py); None for a program without spans."""

from portbench.lib import stages


def read(ctx):
    return stages.read("idle_backward_ms.train", ctx)
