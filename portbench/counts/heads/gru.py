"""DeFlow's head (``decoder_option: gru``): ``num_iters`` ConvGRU steps on
the 128-wide features with the 64-wide offset embedding as input, through
the program's fused GRU kernels, forward and backward (bound: chip_smoke's
GRU timings, 2·M·384·(64 + 128·iters) FLOPs a product, the backward's
three)."""

from portbench.counts.kernels import bound_s

HIDDEN, XDIM = 128, 64

WRAPPERS = {
    "fused_gru": ("deflow_tpu_torch.ops.gru", "fused_gru"),
    "fused_gru_bwd": ("deflow_tpu_torch.ops.gru", "fused_gru_bwd"),
}
NAME_KEYS = (("fused_gru_bwd", ("gru_bwd", "reduce_partials")),
             ("fused_gru", ("gru_fwd",)))


def point_flops(cfg):
    it = int(cfg["num_iters"])
    return 2.0 * (3 * 64 + it * (192 * 256 + 192 * 128) + 192 * 32 + 32 * 3)


def forward_flops(cfg, stats):
    return point_flops(cfg) * sum(s["valid0"] for s in stats)


def gru_fwd_bound(m: int, iters: int) -> float:
    flops = 2.0 * m * (3 * HIDDEN) * (XDIM + HIDDEN * iters)
    nbytes = 2 * m * (HIDDEN + XDIM + HIDDEN) + 2 * (HIDDEN + XDIM) * 3 * HIDDEN + 2 * 3 * HIDDEN
    return bound_s(nbytes, flops)


def gru_bwd_bound(m: int, iters: int) -> float:
    flops = 3 * 2.0 * m * (3 * HIDDEN) * (XDIM + HIDDEN * iters)
    nbytes = 2 * m * (HIDDEN + XDIM + HIDDEN) * 2 + 2 * (HIDDEN + XDIM) * 3 * HIDDEN * 2
    return bound_s(nbytes, flops)


def step_calls(cfg, stats, slots):
    n, iters = len(stats) * slots, int(cfg["num_iters"])
    return [("fused_gru", gru_fwd_bound(n, iters))], [("fused_gru_bwd", gru_bwd_bound(n, iters))]
