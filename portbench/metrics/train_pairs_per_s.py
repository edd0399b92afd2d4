"""train_pairs_per_s: frame pairs whose train step completed in the window,
over the window's seconds; the window ends at a torch.cuda.synchronize()."""

from portbench.lib.readers import of_mode


def read(ctx):
    if not of_mode(ctx, "train") or not ctx.get("window_s"):
        return None
    return ctx["pairs"] / ctx["window_s"]
