"""The training slice's kernels, plain versions and autograd, against the
JAX package on the CPU in f32.

- the GRU backward (``fused_gru_bwd_plain``) vs the VJP of the Pallas
  ``fused_gru`` in interpret mode: all six gradients within 1e-4;
- ``cbg_chain`` (plain blocks and the chain's hand-written VJP) vs a stack of
  train-mode flax ``ConvWithNorms`` under ``jax.grad``, with and without the
  deferred head BN, at the tolerances of ``tests/test_pallas_cbg.py``; and
  vs the Pallas ``cbg_chain`` in interpret mode at its smallest shape;
- the autograd of the sorted segment-sum and of the unpillar gather vs
  ``jax.grad`` through the JAX package's planned (Pallas) versions: sums of
  the same f32 values in another order, 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu_torch.ops import cbg
from deflow_tpu_torch.ops.gru import fused_gru_bwd_plain
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

EPS = 1e-5


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("iters", [1, 4])
def test_gru_bwd_matches_pallas_vjp(interpret_pallas, iters):
    from deflow_tpu.ops.pallas_gru import fused_gru

    rng = np.random.default_rng(iters)
    m, xdim = 300, 64
    args = [rng.normal(0, 0.5, (m, 128)), rng.normal(0, 0.5, (m, xdim)),
            rng.normal(0, 0.1, (128 + xdim, 256)), rng.normal(0, 0.1, 256),
            rng.normal(0, 0.1, (128 + xdim, 128)), rng.normal(0, 0.1, 128)]
    args = [a.astype(np.float32) for a in args]
    g = rng.normal(0, 1, (m, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: fused_gru(*a, iters), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    got = fused_gru_bwd_plain(*map(_t, args), _t(g), iters)
    for name, a, w in zip(("dh0", "dx", "dw_zr", "db_zr", "dw_q", "db_q"),
                          got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def _mk_params(rng, chans):
    return [(rng.normal(0, 0.2, (3, 3, ci, co)).astype(np.float32),
             rng.normal(0, 0.1, co).astype(np.float32),
             (1.0 + 0.1 * rng.normal(0, 1, co)).astype(np.float32),
             (0.05 * rng.normal(0, 1, co)).astype(np.float32))
            for ci, co in zip(chans[:-1], chans[1:])]


def _jax_stack(x, params, head):
    """Train-mode flax ConvWithNorms blocks (after an optional head BN+GELU
    on the pre-BN input); returns (y, batch means)."""
    from deflow_tpu.models.unet import ConvWithNorms

    means = []
    if head:
        g0, b0 = head
        mu = x.mean(axis=(0, 1, 2))
        var = (x * x).mean(axis=(0, 1, 2)) - mu * mu
        x = jax.nn.gelu((x - mu) * jax.lax.rsqrt(var + EPS) * g0 + b0,
                        approximate=False)
        means.append(mu)
    for wm, bi, ga, be in params:
        co = wm.shape[-1]
        variables = {"params": {"conv": {"kernel": wm, "bias": bi},
                                "batchnorm": {"scale": ga, "bias": be}},
                     "batch_stats": {"batchnorm": {"mean": jnp.zeros(co),
                                                   "var": jnp.ones(co)}}}
        x, upd = ConvWithNorms(co, 3, 1, 1).apply(variables, x, True,
                                                  mutable=["batch_stats"])
        means.append(upd["batch_stats"]["batchnorm"]["mean"] / 0.1)
    return x, means


@pytest.mark.parametrize("chans,head", [((8, 8, 8, 8), False),
                                        ((8, 16, 8), False),
                                        ((8, 8, 8), True)],
                         ids=["3blocks", "widen", "head"])
def test_cbg_chain_matches_flax_stack(chans, head):
    rng = np.random.default_rng(len(chans) + 10 * head)
    b, h, w = 2, 16, 8
    x = rng.normal(0, 1.3, (b, h, w, chans[0])).astype(np.float32)
    tgt = rng.normal(0, 1, (b, h, w, chans[-1])).astype(np.float32)
    params = _mk_params(rng, chans)
    head_gb = ([(1.0 + 0.1 * rng.normal(0, 1, chans[0])).astype(np.float32),
                (0.05 * rng.normal(0, 1, chans[0])).astype(np.float32)]
               if head else [])

    def jloss(x, params, head_gb):
        y, _ = _jax_stack(x, params, head_gb)
        return jnp.sum((y - tgt) ** 2)

    jargs = (jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in params],
             [jnp.asarray(t) for t in head_gb])
    y_ref, mu_ref = _jax_stack(*jargs)
    v_ref, g_ref = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*jargs)

    tx = _t(x).requires_grad_()
    tp = [tuple(_t(a).requires_grad_() for a in p) for p in params]
    th = [_t(a).requires_grad_() for a in head_gb]
    y, means, variances = cbg.cbg_chain(tx, tp, th)
    loss = ((y - _t(tgt)) ** 2).sum()
    loss.backward()

    assert len(means) == len(variances) == len(params) + head
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-4)
    for m, mr in zip(means, mu_ref):
        np.testing.assert_allclose(m.numpy(), np.asarray(mr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(v_ref), rtol=1e-5)
    gx, gp, gh = g_ref
    atol = 3e-4 if head else 2e-4
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-3, atol=atol)
    for blk, ref in zip(tp, gp):
        for a, r in zip(blk, ref):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=1e-3,
                                       atol=atol)
    for a, r in zip(th, gh):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=1e-3, atol=atol)


def test_cbg_chain_matches_pallas_chain(interpret_pallas):
    """The smallest shape of ``tests/test_pallas_cbg.py`` (one block, 8x8)."""
    from deflow_tpu.ops import pallas_cbg as C

    rng = np.random.default_rng(4)
    b, h, w = 1, 8, 8
    x = rng.normal(0, 1, (b, h, w, 8)).astype(np.float32)
    params = _mk_params(rng, (8, 8))

    def fused(x, params):
        x_g = C.guard_pad(x.reshape(b * h * w, 8), b, h, w)
        y_g, _, var = C.cbg_chain((b, h, w, EPS), x_g,
                                  tuple((p[0], p[1][None], p[2], p[3]) for p in params))
        return C.guard_slice(y_g, b, h, w).reshape(b, h, w, 8), var

    jargs = (jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in params])
    y_ref, var_ref = fused(*jargs)
    gx_ref, gp_ref = jax.grad(lambda *a: jnp.sum(fused(*a)[0] ** 2),
                              argnums=(0, 1))(*jargs)

    tx = _t(x).requires_grad_()
    tp = [tuple(_t(a).requires_grad_() for a in p) for p in params]
    y, _, var = cbg.cbg_chain(tx, tp)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var[0].numpy(), np.asarray(var_ref[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref), rtol=1e-3, atol=1e-4)
    for a, r in zip(tp[0], gp_ref[0]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r).reshape(a.shape),
                                   rtol=1e-3, atol=2e-4)


def _sorted_ids(rng, b, n, p):
    ids = np.sort(rng.integers(0, p + 1, (b, n)), axis=1)
    ids[:, -n // 5:] = p                                   # trash tail
    return ids.astype(np.int32)


def test_scatter_autograd_matches_jax(interpret_pallas):
    from deflow_tpu.ops.voxel import make_presorted_plan, segment_sum_batched
    from deflow_tpu_torch.ops import voxel as tv

    rng = np.random.default_rng(0)
    b, n, p, c = 2, 700, 256, 33
    s = p + tv.TRASH_PAD
    ids = _sorted_ids(rng, b, n, p)
    data = rng.normal(size=(b, n, c)).astype(np.float32)
    wout = rng.normal(size=(b, s, c)).astype(np.float32)
    jids = jnp.asarray(ids)

    def jloss(d):
        out = segment_sum_batched(d, jids, s, make_presorted_plan(jids, s))
        return jnp.sum(out * wout)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    td = _t(data).requires_grad_()
    (tv.segment_sum_batched(td, torch.from_numpy(ids), s) * _t(wout)).sum().backward()
    np.testing.assert_allclose(td.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (td.grad.numpy()[ids >= p] == 0).all()


def test_gather_autograd_matches_jax(interpret_pallas):
    from deflow_tpu.ops import voxel as jv
    from deflow_tpu_torch.ops import voxel as tv

    rng = np.random.default_rng(1)
    b, n, p, c = 2, 700, 256, 128
    ids = _sorted_ids(rng, b, n, p)
    valid = ids < p
    table = rng.normal(size=(b, p, c)).astype(np.float32)
    wout = rng.normal(size=(b, n, c)).astype(np.float32)
    zeros = jnp.zeros((b, n, 3))
    jinfo = jv.PillarInfo(jnp.asarray(ids), jnp.asarray(valid),
                          jnp.zeros((b, n, 2), jnp.int32), zeros, zeros)
    plan = jv.make_presorted_plan(jnp.asarray(ids), p + jv.TRASH_PAD)

    def jloss(t):
        return jnp.sum(jv.pseudoimage_gather_batched(t, jinfo, plan) * wout)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    tt = _t(table).requires_grad_()
    tinfo = tv.PillarInfo(torch.from_numpy(ids), torch.from_numpy(valid),
                          None, None, None)
    (tv.pseudoimage_gather_batched(tt, tinfo) * _t(wout)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (want != 0).any() and (want == 0).any()
