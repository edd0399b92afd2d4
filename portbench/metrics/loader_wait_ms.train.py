"""loader_wait_ms.train: the program's span deflow/loader/wait
(device_prefetch's get of the next batch and its stream wait, in the step's
calling thread), in ms a step. Read in --trace 1 runs (lib/stages.py); None
for a program without spans."""

from portbench.lib import stages


def read(ctx):
    return stages.read("loader_wait_ms.train", ctx)
