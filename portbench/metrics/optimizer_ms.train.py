"""optimizer_ms.train: the program's span deflow/step/optimizer (Adam's step),
in ms a step. Read in --trace 1 runs (lib/stages.py); None for a program
without spans."""

from portbench.lib import stages


def read(ctx):
    return stages.read("optimizer_ms.train", ctx)
