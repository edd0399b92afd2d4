"""The traffic generator and the FLOP and byte counts."""

import numpy as np
import pytest

from portbench.counts import flops, kernels
from portbench.counts.samples import sample_stats
from portbench.traffic.generator import make_pool, params

TRAFFIC = {"samples": 8, "slots": 4096, "valid": [2000, 3500]}
CFG = {"voxel_size": [0.2, 0.2, 6.0], "point_cloud_range": [-51.2, -51.2, -3.0, 51.2, 51.2, 3.0],
       "feat_channels": 32, "decoder_option": "gru", "num_iters": 4}


def test_one_seed_gives_the_same_arrays():
    a, b = make_pool(TRAFFIC, 2 ** 31 + 11), make_pool(TRAFFIC, 2 ** 31 + 11)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
    c = make_pool(TRAFFIC, 12)
    assert not np.array_equal(a[0]["pc0"], c[0]["pc0"])


def test_every_seed_draws_the_same_sizes():
    """The per-sample sizes are the same set for every seed, in another
    order, so the seed does not change the work."""
    sizes = [sorted(int(s["pc0_mask"].sum()) for s in make_pool(TRAFFIC, seed))
             for seed in (1, 2, 3)]
    assert sizes[0] == sizes[1] == sizes[2]
    orders = [[int(s["pc0_mask"].sum()) for s in make_pool(TRAFFIC, seed)] for seed in (1, 2)]
    assert orders[0] != orders[1]


def test_valid_counts_stay_in_range_and_masks_hold():
    for s in make_pool(TRAFFIC, 7):
        n = int(s["pc0_mask"].sum())
        assert 2000 <= n <= 3500
        assert s["pc0_mask"][:n].all() and not s["pc0_mask"][n:].any()
        assert s["pc0"].shape == (4096, 3) and s["pc0"].dtype == np.float32
        assert np.all(s["pc0"][n:] == 0) and np.all(s["pc1"][n:] == 0)
        assert np.all(np.abs(s["pc0"][:n, :2]) < 51.2)
        assert (s["flow_category_indices"][n:] == 0).all()
        st = sample_stats(s, CFG)
        assert st["valid0"] <= n and st["valid1"] <= n and st["valid0"] > 0.99 * n
        assert 0 < st["occupied0"] <= st["valid0"]


def test_dufo_labels_follow_the_share():
    pool = make_pool({**TRAFFIC, "dufo_share": 0.15}, 3)
    share = np.mean([s["dufo_label0"][s["pc0_mask"]].mean() for s in pool])
    assert 0.13 < share < 0.17
    with pytest.raises(ValueError):
        params({"no_such_key": 1})


def test_flops_of_a_tiny_configuration_by_hand():
    """A 16 x 16 grid (6.4 m pillars): the encoder's maps are 8², 8², 8², 8²,
    4², 4², 4², 4², 2², 2²; the decoder works at 4², 8² and 16²."""
    cfg = {**CFG, "voxel_size": [6.4, 6.4, 6.0]}
    conv = lambda cin, cout, k, hw: 2 * cin * cout * k * k * hw
    enc = (conv(32, 64, 8, 64) + 3 * conv(64, 64, 3, 64) + conv(64, 128, 8, 16)
           + 3 * conv(128, 128, 3, 16) + conv(128, 256, 8, 4) + conv(256, 256, 3, 4))
    dec = (conv(512, 128, 1, 4) + conv(128, 64, 1, 16) + conv(256, 64, 1, 16)
           + conv(128, 64, 1, 16) + conv(64, 256, 1, 16)
           + conv(256, 64, 1, 16) + conv(64, 32, 1, 64) + conv(128, 32, 1, 64)
           + conv(64, 32, 1, 64) + conv(32, 128, 1, 64)
           + conv(128, 32, 1, 64) + conv(32, 16, 1, 256) + conv(64, 16, 1, 256)
           + conv(32, 16, 1, 256) + conv(16, 64, 1, 256)
           + conv(64, 64, 3, 256))
    assert flops.unet_flops(cfg) == 2 * enc + dec
    gru_point = 2 * (3 * 64 + 4 * (192 * 256 + 192 * 128) + 192 * 32 + 32 * 3)
    assert flops.point_flops(cfg) == {"pfn": 2 * 9 * 32, "head": gru_point}
    lin = flops.point_flops({**cfg, "decoder_option": "linear"})["head"]
    assert lin == 2 * (3 * 128 + 256 * 32 + 32 * 3)
    want = 3 * (2 * (2 * enc + dec) + 2 * 9 * 32 * (100 + 90) + gru_point * 100)
    assert flops.step_flops(cfg, "train", 2, 100, 90) == want
    assert flops.step_flops(cfg, "eval", 2, 100, 90) == want / 3


def test_counts_depend_on_shapes_only():
    """Two pools of one traffic, drawn from other seeds, give the same FLOPs
    a step for the same per-sample sizes; the grid changes them."""
    stats = [sample_stats(s, CFG) for s in make_pool(TRAFFIC, 4)]
    again = [sample_stats(s, CFG) for s in make_pool(TRAFFIC, 4)]
    assert stats == again
    f = flops.step_flops(CFG, "train", 2, 5000, 4000)
    assert f == flops.step_flops(dict(CFG), "train", 2, 5000, 4000)
    assert f != flops.step_flops({**CFG, "voxel_size": [0.4, 0.4, 6.0]}, "train", 2, 5000, 4000)


def test_kernel_bounds_of_a_step():
    """The calls of a remat train step: the launch counts the program's
    wrappers show for it (5 segment-sums, 4 gathers, 2 GRU forwards, 1
    backward), each bound the larger of bytes over HBM and FLOPs over the
    bf16 peak."""
    stats = [{"valid0": 80000, "valid1": 79000, "occupied0": 30000, "occupied1": 29000}] * 16
    calls = kernels.bound_by_wrapper(kernels.step_calls(CFG, "train", True, stats, 98304))
    assert {k: v[0] for k, v in calls.items()} == {
        "segment_sum": 5, "sorted_gather": 4, "fused_gru": 2, "fused_gru_bwd": 1}
    m = 16 * 98304
    gru_flops = 2.0 * m * 384 * (64 + 128 * 4)
    assert calls["fused_gru"][1] == pytest.approx(2 * gru_flops / 989e12)
    seg = (16 * 80000 * 33 * 2 + m * 4 + 16 * (512 * 512 + 8) * 33 * 2) / 3.35e12
    assert kernels.segment_sum_bound(m, 16 * 80000, 33, 16 * (512 * 512 + 8)) == pytest.approx(seg)
    lin = kernels.bound_by_wrapper(kernels.step_calls(
        {**CFG, "decoder_option": "linear"}, "train", False, stats, 98304))
    assert {k: v[0] for k, v in lin.items()} == {"segment_sum": 3, "sorted_gather": 3}
    assert kernels.kernel_of("void (anonymous namespace)::gru_bwd_main<bf16>") == "fused_gru_bwd"
    assert kernels.kernel_of("segment_sum_kernel<__nv_bfloat16>") == "segment_sum"
    assert kernels.kernel_of("at::native::radix_sort_kernel") is None


def test_every_wrapper_the_roofline_reads_has_its_counter():
    import importlib

    for name, (mod, fn) in kernels.WRAPPERS.items():
        assert isinstance(getattr(importlib.import_module(mod), fn).launches, int), name


def _roofline_ctx(calls, by_kernel):
    stats = sample_stats(make_pool(TRAFFIC, 3)[0], CFG)
    return {"mode": "train", "cfg": {"model": CFG, "remat": True},
            "workload": {"traffic": TRAFFIC}, "sample_stats": [stats],
            "traced": {"batches": [[0]], "calls": calls,
                       "trace": {"by_kernel": by_kernel}}}


@pytest.mark.parametrize("calls, by_kernel", [
    ({"segment_sum": 3, "fused_gru": 2}, {"segment_sum": 1e-3}),      # kernel renamed
    ({"segment_sum": 3, "fused_gru": 0}, {"segment_sum": 1e-3, "fused_gru": 2e-3}),  # counter gone
])
def test_the_roofline_stops_on_counters_and_trace_that_disagree(calls, by_kernel):
    from portbench.lib import readers

    with pytest.raises(RuntimeError, match="kernel_roofline"):
        readers.kernel_roofline(_roofline_ctx(calls, by_kernel))


def test_the_roofline_of_counters_and_trace_that_agree():
    from portbench.lib import readers

    calls = {"segment_sum": 3, "sorted_gather": 3, "fused_gru": 2, "fused_gru_bwd": 1,
             "cell_sweep": 0}
    by_kernel = {"segment_sum": 1e-3, "sorted_gather": 1e-3, "fused_gru": 2e-3,
                 "fused_gru_bwd": 3e-3}
    got = readers.kernel_roofline(_roofline_ctx(calls, by_kernel))
    step = kernels.bound_by_wrapper(kernels.step_calls(
        CFG, "train", True, _roofline_ctx(calls, by_kernel)["sample_stats"],
        TRAFFIC["slots"]))
    want = sum(step[k][1] / step[k][0] * calls[k] for k in by_kernel) / sum(by_kernel.values())
    assert got == pytest.approx(100 * want)
