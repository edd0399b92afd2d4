"""host_prep_ms.train: the program's span deflow/loader/prep (post_collate, the
C++ host prep of a batch, in the loader's thread), in ms a batch. Read in
--trace 1 runs (lib/stages.py); None for a program without spans."""

from portbench.lib import stages


def read(ctx):
    return stages.read("host_prep_ms.train", ctx)
