"""``NNSpec.dyn_cap``, the compacted backward of the SeFlow chamfer's
dynamic terms, against the JAX package on the CPU in f32 (its chamfer on the
Pallas path in interpret mode, the fixture of ``test_torch_ssl_kernels.py``).

Tolerances, each with its reason (those of ``test_torch_ssl_kernels.py``):
distances 1e-6 relative + 1e-5 absolute (the same sweep; XLA may contract
a product-sum), gradients within 1e-5 of their largest element
(matched-pair sums of the same terms in another order); the loss 1e-6
relative.  Against the port's own uncompacted backward: 1e-5 of the
largest element above the cap (the same terms, added in another order),
and below it every row but the flagged ones past the cap within the same
bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu_torch.ops import chamfer as TC

from test_torch_ssl_kernels import (T2, _clouds, _close, _grads_close, _host_c1, _specs,
                                    _t, interpret_pallas)  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

# clouds of 2 x 300 / 400 rows, about 127 flagged pc0 rows and 170 pc1 rows a
# sample: a cap above every count, and one below
CAPS = {"above": 250, "below": 60}


def _port_grads(p, q, mp, mq, fp, fq, tspec, hc):
    tp, tq = (x.requires_grad_() for x in _t(p, q))
    d = TC.ssl_chamfer_distances(tp, tq, *_t(mp, mq, fp, fq), truncate=2.0,
                                 spec=tspec, host_c1=hc)
    sum(x.clamp(max=T2).sum() for x in d).backward()
    return [x.detach() for x in d], tp.grad, tq.grad


@pytest.mark.parametrize("layout", ["sorted", "hosted"])
@pytest.mark.parametrize("cap", sorted(CAPS))
def test_compacted_backward_matches_jax(interpret_pallas, layout, cap):
    """The four distance sets and the gradients wrt both clouds against
    ``jax.grad`` of the JAX package's ``ssl_chamfer_distances`` at the same
    ``dyn_cap``; and against the port's uncompacted backward: equal above
    the cap, differing only on the flagged rows past it below."""
    JC = interpret_pallas
    jspec, tspec = _specs()
    p, q, mp, mq, fp, fq = _clouds(11)
    counts0, counts1 = fp.sum(-1), fq.sum(-1)
    k = CAPS[cap]
    assert (counts0.max() < k and counts1.max() < k) if cap == "above" else \
        (counts0.min() > k and counts1.min() > k)
    jspec, tspec = jspec._replace(dyn_cap=k), tspec._replace(dyn_cap=k)
    hc = _host_c1(q, mq, fq) if layout == "hosted" else None
    fixed = [jnp.asarray(x) for x in (mp, mq, fp, fq)]

    def jloss(p0, p1):
        d = JC.ssl_chamfer_distances(p0, p1, *fixed, truncate=2.0, spec=jspec,
                                     host_c1=None if hc is None else tuple(
                                         map(jnp.asarray, hc)))
        return sum(jnp.sum(jnp.minimum(x, T2)) for x in d), d

    (_, jd), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p), jnp.asarray(q))
    thc = None if hc is None else tuple(_t(*hc))
    d, g0, g1 = _port_grads(p, q, mp, mq, fp, fq, tspec, thc)
    for a, b in zip(d, jd):
        _close(a, b, atol=1e-5)
    _grads_close(g0, jg[0])
    _grads_close(g1, jg[1])

    d_full, f0, f1 = _port_grads(p, q, mp, mq, fp, fq, tspec._replace(dyn_cap=None), thc)
    for a, b in zip(d, d_full):
        assert torch.equal(a, b)                 # the forward never changes
    # the flagged rows past the first k of each sample, in row order, lose
    # their own f-term, and their f-matches in the other cloud its mirror
    i0f, i1f = (x.numpy() for x in TC._SSLNN.apply(
        *_t(p, q, mp, mq, fp, fq), tspec, thc)[6:8])
    past0, past1 = (f & (np.cumsum(f, axis=-1) > k) for f in (fp, fq))
    for got, full, flag, own, other, i_other in ((g0, f0, fp, past0, past1, i1f),
                                                 (g1, f1, fq, past1, past0, i0f)):
        keep = np.ones(flag.shape, bool)
        if cap == "below":
            keep &= ~own
            for s_ in range(keep.shape[0]):
                hit = i_other[s_][other[s_]]
                keep[s_, hit[hit >= 0]] = False
            assert flag[~keep].all()                      # only flagged rows may differ
            assert not np.allclose(got.numpy()[~keep], full.numpy()[~keep])
        tol = 1e-5 * full.abs().max().item()
        np.testing.assert_allclose(got.numpy()[keep], full.numpy()[keep], rtol=0, atol=tol)


@pytest.mark.parametrize("env", ["0", "60"])
def test_seflow_loss_dyncap_env_matches_jax(interpret_pallas, monkeypatch, env):
    """``seflow_loss`` on the grid branch under ``DEFLOW_SSL_DYNCAP`` (``0``:
    uncompacted; ``60``: below the dynamic counts) against the JAX package's
    under the same variable, value and gradient; an explicit ``dyn_cap``
    takes precedence over the variable."""
    from deflow_tpu.losses import seflow_loss as jax_seflow
    from deflow_tpu_torch.losses import seflow_loss

    monkeypatch.setenv("DEFLOW_SSL_DYNCAP", env)
    rng = np.random.default_rng(13)
    b, n = 2, 300
    pc0 = rng.uniform(-30, 30, (b, n, 3)).astype(np.float32)
    pc1 = (pc0 + rng.normal(0, 0.5, (b, n, 3))).astype(np.float32)
    flow = rng.normal(0, 0.3, (b, n, 3)).astype(np.float32)
    out = {"pose_flow": rng.normal(0, 0.1, (b, n, 3)).astype(np.float32),
           "pc0_valid": rng.random((b, n)) > 0.05, "pc1_valid": rng.random((b, n)) > 0.05}
    batch = {"pc0": pc0, "pc1": pc1, "pc0_mask": rng.random((b, n)) > 0.1,
             "pc1_mask": rng.random((b, n)) > 0.1,
             "dufo_label0": (rng.random((b, n)) < 0.4).astype(np.int32),
             "dufo_label1": (rng.random((b, n)) < 0.4).astype(np.int32)}

    jv, jg = jax.value_and_grad(lambda f: jax_seflow(
        {**{k: jnp.asarray(v) for k, v in out.items()}, "flow": f},
        {k: jnp.asarray(v) for k, v in batch.items()}, chamfer_method="grid"))(
            jnp.asarray(flow))

    def port(**kw):
        tf = torch.from_numpy(flow).requires_grad_()
        tv = seflow_loss({**dict(zip(out, _t(*out.values()))), "flow": tf},
                         dict(zip(batch, _t(*batch.values()))), chamfer_method="grid",
                         **kw)
        tv.backward()
        return tv, tf.grad

    tv, tg = port()
    _close(float(tv), float(jv), rtol=1e-6, atol=0)
    _grads_close(tg, jg)
    uv, ug = port(dyn_cap=n)                     # explicit: no compaction
    assert float(uv) == float(tv)
    assert torch.equal(ug, tg) == (env == "0")


def test_overflow_stats_match_jax():
    """``dyn_cap_overflow_stats`` and ``grid_overflow_stats`` against the
    JAX package's on skewed clouds (a dense cluster overflows the cells)."""
    from deflow_tpu.ops import chamfer as JC

    rng = np.random.default_rng(3)
    b, n = 3, 2000
    pts = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    pts[0, :600, :2] = rng.normal(0, 0.3, (600, 2))          # one crowded cell
    pts[1, :300, :2] = 5.0 + rng.normal(0, 0.2, (300, 2))
    mask = rng.random((b, n)) > 0.1
    flags = mask & (rng.random((b, n)) < np.array([0.05, 0.2, 0.1])[:, None])
    for cap in (None, 150, 300):
        jspec = JC.NNSpec(method="grid", dyn_cap=cap)
        tspec = TC.NNSpec(method="grid", dyn_cap=cap)
        want = JC.dyn_cap_overflow_stats(jnp.asarray(flags), spec=jspec)
        got = TC.dyn_cap_overflow_stats(torch.from_numpy(flags), spec=tspec)
        assert int(got[0]) == int(want[0]) and got[1] == want[1]
        assert float(got[2]) == pytest.approx(float(want[2]), abs=1e-7)
    for capacity, batched in ((128, True), (32, True), (32, False)):
        jspec = JC.NNSpec(method="grid", capacity=capacity, cell=2.0)
        tspec = TC.NNSpec(method="grid", cell=2.0)
        p, m = (pts, mask) if batched else (pts[0], mask[0])
        want = JC.grid_overflow_stats(jnp.asarray(p), jnp.asarray(m), jspec)
        got = TC.grid_overflow_stats(torch.from_numpy(p), torch.from_numpy(m), tspec,
                                     capacity=capacity)
        for a, w in zip(got, want):
            assert float(a) == pytest.approx(float(w), rel=1e-6, abs=1e-7)
        assert float(got[0]) > 0 and int(got[2]) > capacity
