"""backward_ms.train: the program's span deflow/step/backward (autograd's
backward, remat's recompute in it), in ms a step. Read in --trace 1 runs
(lib/stages.py); None for a program without spans."""

from portbench.lib import stages


def read(ctx):
    return stages.read("backward_ms.train", ctx)
