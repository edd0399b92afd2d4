"""forward_ms.train: the program's span deflow/step/forward (the model's
forward: embedder, U-Net, head), in ms a step. Read in --trace 1 runs
(lib/stages.py); None for a program without spans."""

from portbench.lib import stages


def read(ctx):
    return stages.read("forward_ms.train", ctx)
