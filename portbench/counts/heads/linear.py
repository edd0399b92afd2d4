"""FastFlow3D's head (``decoder_option: linear``): the MLP 256 → 32 → 3 over
the 128-wide features and a 128-wide offset embedding, on library matrix
products: no hand-written kernel of its own."""

WRAPPERS = {}
NAME_KEYS = ()


def point_flops(cfg):
    return 2.0 * (3 * 128 + 256 * 32 + 32 * 3)


def forward_flops(cfg, stats):
    return point_flops(cfg) * sum(s["valid0"] for s in stats)


def step_calls(cfg, stats, slots):
    return [], []
