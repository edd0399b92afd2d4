"""Each kernel's plain PyTorch version vs the JAX Pallas kernel it replaces
(``pl.pallas_call`` in interpret mode on the CPU).

Tolerances: f32 sums differ only in summation order (1e-5); bf16 outputs are
one f32-accumulated sum rounded once on both sides, so they may differ by
one bf16 rounding (relative 2^-8); the gather is a copy and must be exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflow_tpu_torch.ops.gather import sorted_rows_gather
from deflow_tpu_torch.ops.gru import fused_gru
from deflow_tpu_torch.ops import voxel as tv
from deflow_tpu_torch.ops.voxel import TRASH_PAD, segment_sum_batched
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    import deflow_tpu.ops.voxel as V
    from deflow_tpu.ops import pallas_scatter as ps

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(V, "_use_pallas", lambda: True)
    ps._sorted_scatter.clear_cache()
    yield
    ps._sorted_scatter.clear_cache()


def _bf16_round(a):
    """f32 array holding bf16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segment_sum_matches_pallas(interpret_pallas, dtype):
    from deflow_tpu.ops.voxel import make_presorted_plan
    from deflow_tpu.ops.voxel import segment_sum_batched as jax_seg

    rng = np.random.default_rng(0)
    b, n, p, c = 3, 1500, 1024, 33
    s = p + TRASH_PAD
    # ascending per-sample ids with trash (== p) tails and empty pillars
    ids = np.sort(rng.integers(0, p + 1, (b, n)), axis=1)
    ids[:, -200:] = p
    ids[:, :100] = np.sort(rng.integers(0, 50, (b, 100)), axis=1)
    ids = np.sort(ids, axis=1).astype(np.int32)
    data = rng.normal(size=(b, n, c)).astype(np.float32)
    if dtype == "bf16":
        data = _bf16_round(data)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))

    jids = jnp.asarray(ids)
    plan = make_presorted_plan(jids, s)
    # the same flat ids, sentinel rule included
    np.testing.assert_array_equal(
        tv.make_presorted_plan(torch.from_numpy(ids), s).numpy(),
        np.asarray(plan.pid))
    want = np.asarray(jax_seg(jnp.asarray(data, jdt), jids, s,
                              plan).astype(jnp.float32))
    got = segment_sum_batched(_to_torch(data, tdt), torch.from_numpy(ids), s)
    assert got.shape == (b, s, c) and got.dtype == tdt
    got = got.float().numpy()

    occupied = np.zeros((b, s), bool)
    for i in range(b):
        occupied[i, ids[i][ids[i] < p]] = True
    assert (~occupied[:, :p]).any()
    assert (got[~occupied] == 0).all() and (want[~occupied] == 0).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sorted_segment_sum_in_parts_matches_pallas(interpret_pallas, dtype):
    """``sorted_segment_sum(..., samples=b)`` called directly on the
    presorted plan's flat ids (trash tails: sentinel runs between the
    samples), at the gather's backward width (C = 128), against the JAX
    package's segment_sum_batched; the plan ascends within each sample, not
    over the whole stream."""
    from deflow_tpu.ops.voxel import make_presorted_plan
    from deflow_tpu.ops.voxel import segment_sum_batched as jax_seg
    from deflow_tpu_torch.ops.scatter import plan_is_sorted, sorted_segment_sum

    rng = np.random.default_rng(3)
    b, n, p, c = 3, 1200, 1024, 128
    s = p + TRASH_PAD
    ids = np.sort(rng.integers(0, p, (b, n)), axis=1)
    ids[:, -150:] = p
    ids = ids.astype(np.int32)
    data = rng.normal(size=(b, n, c)).astype(np.float32)
    if dtype == "bf16":
        data = _bf16_round(data)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jids = jnp.asarray(ids)
    want = np.asarray(jax_seg(jnp.asarray(data, jdt), jids, s,
                              make_presorted_plan(jids, s)).astype(jnp.float32))
    flat = tv.make_presorted_plan(torch.from_numpy(ids), s)
    assert plan_is_sorted(flat, b * s, b) and not plan_is_sorted(flat, b * s)
    got = sorted_segment_sum(_to_torch(data, tdt).reshape(b * n, c), flat, b * s,
                             samples=b)
    assert got.shape == (b * s, c) and got.dtype == tdt
    got = got.float().numpy().reshape(b, s, c)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


def test_sorted_segment_sum_refuses_parts_that_do_not_divide():
    from deflow_tpu_torch.ops.scatter import sorted_segment_sum

    feats, ids = torch.ones(6, 33), torch.zeros(6, dtype=torch.int32)
    for samples, rows in ((4, 12), (3, 10), (0, 12)):
        with pytest.raises(ValueError, match="samples"):
            sorted_segment_sum(feats, ids, rows, samples=samples)
    out = sorted_segment_sum(feats, ids, 12, samples=3)
    assert out.shape == (12, 33) and (out[0] == 6).all() and (out[1:] == 0).all()


def test_plan_is_sorted_rejects_what_the_kernel_cannot_search():
    from deflow_tpu_torch.ops.scatter import plan_is_sorted

    t = lambda *v: torch.tensor(v, dtype=torch.int32)
    assert plan_is_sorted(t(0, 0, 3, 9, 9), 10)
    assert plan_is_sorted(t(1, 4, 20, 5, 9, 20), 10, 2)
    assert not plan_is_sorted(t(0, 3, 2, 9), 10)            # descends
    assert not plan_is_sorted(t(0, 12, 3, 9), 10)           # a sentinel mid-stream
    assert not plan_is_sorted(t(1, 6, 20, 5, 9, 20), 10, 2)  # a row of the next sample


@pytest.mark.parametrize("voxel", [(3.2, 3.2, 6.0), (3.3, 3.2, 6.0)],
                         ids=["s2d", "row_major"])
def test_path_plans_ascend_within_each_sample(voxel):
    """The flat ids that the embedder's scatter and the gather's backward
    feed the segment-sum, built from a host-sorted batch with padding and
    out-of-range points, ascend within each sample, sentinels last."""
    from deflow_tpu_torch.data.host_prep import attach_host_prep
    from deflow_tpu_torch.ops.scatter import plan_is_sorted

    rng = np.random.default_rng(4)
    b, n = 3, 900
    rng_range = [-51.2, -51.2, -3.0, 51.2, 51.2, 3.0]
    cloud = lambda: np.stack([rng.uniform(-56, 56, (b, n)), rng.uniform(-56, 56, (b, n)),
                              rng.uniform(-3.5, 3.5, (b, n))], -1).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    hb = attach_host_prep({"pc0": cloud(), "pc1": cloud(), "pose0": pose,
                           "pose1": pose.copy(), "pc0_mask": rng.random((b, n)) < 0.85,
                           "pc1_mask": rng.random((b, n)) < 0.85}, list(voxel), rng_range)
    cfg = tv.VoxelConfig(voxel, tuple(rng_range))
    p = cfg.num_pillars
    s = p + TRASH_PAD
    sorted_id = torch.from_numpy(hb["pc0_sorted"])
    assert (sorted_id == p).any()
    assert plan_is_sorted(tv.make_presorted_plan(sorted_id, s), b * s, b)
    info = tv.pillar_info_from_ids(torch.from_numpy(hb["pc0_transformed"]),
                                   torch.from_numpy(hb["pc0_mask"]),
                                   torch.from_numpy(hb["pc0_ids"]), cfg)
    gplan = tv.make_presorted_plan(torch.where(info.valid, info.pillar_id, p), s)
    assert plan_is_sorted(gplan, b * s, b)


@pytest.mark.parametrize("dtype,c", [("f32", 33), ("bf16", 128)])
def test_gather_matches_pallas_exactly(interpret_pallas, dtype, c):
    from deflow_tpu.ops.pallas_gather import sorted_rows_gather_pallas

    rng = np.random.default_rng(1)
    num_rows, m = 3000, 1200
    table = rng.normal(size=(num_rows, c)).astype(np.float32)
    if dtype == "bf16":
        table = _bf16_round(table)
    half = m // 2
    ids = np.concatenate([
        np.sort(rng.integers(0, num_rows // 2, half - 7)), np.full(7, 2 ** 30),
        np.sort(rng.integers(num_rows // 2, num_rows, m - half - 9)),
        np.full(9, 2 ** 30)]).astype(np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(sorted_rows_gather_pallas(
        jnp.asarray(table, jdt), jnp.asarray(ids), num_rows).astype(jnp.float32))
    got = sorted_rows_gather(_to_torch(table, tdt), torch.from_numpy(ids),
                             num_rows)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (got[ids >= num_rows] == 0).all()


def _gru_inputs(seed, m=700, xdim=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (m, 128)), rng.normal(0, 0.5, (m, xdim)),
            rng.normal(0, 0.1, (128 + xdim, 256)), rng.normal(0, 0.1, 256),
            rng.normal(0, 0.1, (128 + xdim, 128)), rng.normal(0, 0.1, 128))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("iters", [1, 4])
def test_gru_matches_pallas(interpret_pallas, iters, dtype):
    from deflow_tpu.ops.pallas_gru import fused_gru as jax_fused_gru

    args = [a.astype(np.float32) for a in _gru_inputs(0)]
    if dtype == "bf16":
        args = [_bf16_round(a) for a in args]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_fused_gru(*(jnp.asarray(a, jdt) for a in args),
                                    iters).astype(jnp.float32))
    got = fused_gru(*(_to_torch(a, tdt) for a in args), iters)
    assert got.dtype == tdt and got.shape == (700, 128)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        # f32 state on both sides; only the final bf16 rounding (and rare
        # flips of an intermediate bf16 operand) differ
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2e-3)
