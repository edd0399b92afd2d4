"""prep_ms.train: the harness's span around the loader's post_collate (the
C++ host prep of a batch), in ms a batch prepared during the window."""

from portbench.lib.readers import of_mode, span_ms


def read(ctx):
    return span_ms(ctx, "prep") if of_mode(ctx, "train") else None
