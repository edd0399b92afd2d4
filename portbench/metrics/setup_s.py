"""setup_s: process start to the window's start, compilation included (host clock)."""


def read(ctx):
    return ctx.get("setup_s")
