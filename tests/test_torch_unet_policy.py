"""The train-mode U-Net's chain policy against the JAX package on the CPU in
f32: which encoder groups chain, the 64² group's chain at 256 channels
included.  The port's chained groups are the constant
``models.unet._CHAINED_GROUPS``, which each case substitutes, and the JAX
package's are ``DEFLOW_FUSED_CBG``, which each case sets to the matching
value.  Siamese batch 2B > 4 against the JAX package is in
``test_torch_unet_remat.py``; the port's own route at the benchmark's
2B = 32 in bf16 is checked here with a stub in place of the chain.

The JAX package ignores ``DEFLOW_FUSED_CBG`` off the TPU, so its side runs
with ``deflow_tpu.ops.voxel._use_pallas`` patched on and the Pallas chain in
interpret mode (as ``tests/test_pallas_cbg.py`` does).  The grid is 64²
(B = 1, 2B = 2): the groups' maps are 32², 16² and 8², all multiples of 8,
so every chain-capable group chains.

Tolerances, each with its reason (those of ``test_torch_train_modules.py``'s
U-Net test): the output 1e-4, the BN running statistics 1e-5 (reductions in
another order), the gradients rtol 2e-3 / atol 2e-2 (sums of O(1e2-1e3)
reordered, and the analytically zero biases of the convs before a BN).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from deflow_tpu_torch.models import unet as TU
from deflow_tpu_torch.ops import cbg as TC

from test_torch_modules import randomize_variables
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

HW = 64
# the JAX package's DEFLOW_FUSED_CBG values and the port's chained groups
POLICIES = {"0": (), "auto": ("256", "128"), "all": ("256", "128", "64"),
            "64": ("64",), "128,64": ("128", "64")}
# channels of each group's chained blocks: the 256, 128 and 64 groups
GROUP_OF = {64: "256", 128: "128", 256: "64"}


@pytest.fixture
def interpret_cbg(monkeypatch):
    """The JAX U-Net's chain on the CPU: ``_use_pallas`` on, Pallas in
    interpret mode, every chain call recorded by its group."""
    from jax.experimental import pallas as pl

    import deflow_tpu.ops.voxel as V
    from deflow_tpu.ops import pallas_cbg as C

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(V, "_use_pallas", lambda: True)
    calls = []
    chain = C.cbg_chain

    def spy(dims, x_g, params, head_gb=()):
        calls.append((GROUP_OF[params[0][0].shape[-1]], len(params), bool(head_gb)))
        return chain(dims, x_g, params, head_gb)

    monkeypatch.setattr(C, "cbg_chain", spy)
    return calls


def _port_chain_spy(monkeypatch):
    calls = []
    chain = TU.cbg_chain

    def spy(x, params, head_gb=(), eps=1e-5):
        calls.append((GROUP_OF[params[0][0].shape[-1]], len(params), bool(head_gb)))
        return chain(x, params, head_gb, eps)

    monkeypatch.setattr(TU, "cbg_chain", spy)
    return calls


def _inputs(b, seed=8):
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(b, HW, HW, 32)).astype(np.float32) for _ in range(2)]
    w = rng.normal(size=(b, HW, HW, 64)).astype(np.float32)
    return imgs, w


def _jax_variables(b):
    from deflow_tpu.models.unet import FastFlow3DUNet as JUNet

    imgs, _ = _inputs(b)
    shapes = jax.eval_shape(lambda: JUNet().init(jax.random.key(0),
                                                 *map(jnp.asarray, imgs)))
    return randomize_variables(shapes, 8)


def _jax_grad_fn(variables, b):
    """The JAX U-Net's train-mode forward and ``jax.grad`` under the current
    environment (the modules read it when built): params → ((loss, (output,
    updated batch_stats)), gradients)."""
    from deflow_tpu.models.unet import FastFlow3DUNet as JUNet

    imgs, w = _inputs(b)
    jm = JUNet()

    def jloss(params):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            *map(jnp.asarray, imgs), True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    return jax.value_and_grad(jloss, has_aux=True)


def _jax_step(variables, b):
    """(output, updated batch_stats, parameter gradients) of the JAX U-Net."""
    (_, (out, stats)), grads = jax.jit(_jax_grad_fn(variables, b))(variables["params"])
    return (np.asarray(out), state_dict_from_flax({"batch_stats": stats}),
            state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)}))


def _port_step(variables, b):
    """The port's U-Net in train mode: (output NHWC, state_dict, gradients)."""
    imgs, w = _inputs(b)
    port = TU.FastFlow3DUNet(stem_cin=32).train()
    load_reference_state_dict(port, state_dict_from_flax(variables), prefix="")
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    out = port(nchw(imgs[0]), nchw(imgs[1]), torch.float32).permute(0, 2, 3, 1)
    (out * torch.from_numpy(w)).sum().backward()
    grads = {k: p.grad.clone() for k, p in port.named_parameters()}
    return out.detach().numpy(), port.state_dict(), grads


def _hold(port, want):
    out, sd, grads = port
    w_out, w_stats, w_grads = want
    np.testing.assert_allclose(out, w_out, rtol=1e-4, atol=1e-4)
    for key, v in w_stats.items():
        if "num_batches" not in key:
            np.testing.assert_allclose(sd[key].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    assert set(w_grads) == set(grads)
    for key, g in w_grads.items():
        np.testing.assert_allclose(grads[key].numpy(), g.numpy(), rtol=2e-3,
                                   atol=2e-2, err_msg=key)


@pytest.mark.parametrize("policy", POLICIES)
def test_fused_cbg_policy_matches_jax(interpret_cbg, monkeypatch, policy):
    """With the port's chained groups those of each ``DEFLOW_FUSED_CBG``
    value of the JAX package, the port chains the groups the JAX U-Net
    chains (stem head and block count), and its output, BN statistics and
    gradients are the JAX U-Net's."""
    monkeypatch.setenv("DEFLOW_FUSED_CBG", policy)
    monkeypatch.setattr(TU, "_CHAINED_GROUPS", POLICIES[policy])
    variables = _jax_variables(1)
    want = _jax_step(variables, 1)
    port_calls = _port_chain_spy(monkeypatch)
    got = _port_step(variables, 1)
    assert port_calls == interpret_cbg
    assert tuple(c[0] for c in port_calls) == POLICIES[policy]
    assert all(c[2] and c[1] == (1 if c[0] == "64" else 3) for c in port_calls)
    _hold(got, want)


def test_policy_values_follow_jax(monkeypatch):
    """The port's chained groups are the JAX package's under ``auto``
    (``use_fused_cbg``, ``_use_pallas`` on), and its batch rule is JAX's
    ``chain_at_batch`` in f32 at 2B = 4, 8 and 32.  In bf16 the port keeps
    the card's rule instead of the TPU's 2B <= 4: it chains at every
    batch."""
    import deflow_tpu.ops.voxel as V
    from deflow_tpu.ops import pallas_cbg as C

    monkeypatch.setattr(V, "_use_pallas", lambda: True)
    monkeypatch.setenv("DEFLOW_FUSED_CBG", "auto")
    assert frozenset(TU._CHAINED_GROUPS) == C.use_fused_cbg()
    for rows2b in (4, 8, 32):
        assert TU._chain_at_batch(rows2b, torch.float32) == C.chain_at_batch(rows2b)
        assert TU._chain_at_batch(rows2b, torch.bfloat16)


def _stub_chain(monkeypatch):
    """``cbg_chain`` replaced by a recorder that returns zeros of its
    outputs' shapes (nothing computed): the groups it was called for."""
    calls = []

    def stub(x, params, head_gb=(), eps=1e-5):
        calls.append(GROUP_OF[params[0][0].shape[-1]])
        b, h, w, c = x.shape
        chans = ([c] if head_gb else []) + [p[0].shape[-1] for p in params]
        stats = tuple(x.new_zeros(k, dtype=torch.float32) for k in chans)
        return x.new_zeros(b, h, w, chans[-1]), stats, stats

    monkeypatch.setattr(TU, "cbg_chain", stub)
    return calls


@pytest.mark.parametrize("case,grid,expect", [
    ("train", 64, ["256", "128"]), ("eval", 64, []), ("map_not_8", 48, ["256"])])
def test_auto_route_at_the_cells_batch(monkeypatch, case, grid, expect):
    """The cells' batch (16 pairs, 2B = 32) in bf16: in training
    ``_encode`` takes ``cbg_chain`` for the 256 and 128 groups; in eval it
    chains none; at a 48² grid the 128 group's 12² map is not a multiple of
    8 and only the 256 group (24²) chains."""
    calls = _stub_chain(monkeypatch)
    model = TU.FastFlow3DUNet(stem_cin=32)
    model.train(case != "eval")
    x = torch.zeros(32, 32, grid, grid, dtype=torch.bfloat16)
    with torch.no_grad():
        taps = model._encode(x, torch.bfloat16)
    assert calls == expect
    assert [t.shape[1:] for t in taps] == [(64, grid // 2, grid // 2),
                                           (128, grid // 4, grid // 4),
                                           (256, grid // 8, grid // 8)]


def test_cbg_chain_256_matches_pallas_chain(interpret_cbg):
    """The plain block versions at 256 channels (the 64² group: the stem's
    BN + GELU deferred into one 256 → 256 block) against the Pallas chain
    in interpret mode: output, batch variances, gradients of the input and
    of every parameter (the fused U-Net's tolerances)."""
    from deflow_tpu.ops import pallas_cbg as C

    rng = np.random.default_rng(6)
    b, h, w, c = 2, 8, 8, 256
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    params = [(rng.normal(0, (9 * c) ** -0.5, (3, 3, c, c)).astype(np.float32),
               rng.normal(0, 0.1, c).astype(np.float32),
               (1.0 + 0.1 * rng.normal(0, 1, c)).astype(np.float32),
               (0.05 * rng.normal(0, 1, c)).astype(np.float32))]
    head = [(1.0 + 0.1 * rng.normal(0, 1, c)).astype(np.float32),
            (0.05 * rng.normal(0, 1, c)).astype(np.float32)]
    tgt = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)

    def fused(x, params, head):
        x_g = C.guard_pad(x.reshape(b * h * w, c), b, h, w)
        y_g, _, var = C.cbg_chain((b, h, w, 1e-5), x_g,
                                  tuple((p[0], p[1][None], p[2], p[3]) for p in params),
                                  tuple(head))
        return C.guard_slice(y_g, b, h, w).reshape(b, h, w, c), var

    jargs = (jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in params],
             [jnp.asarray(t) for t in head])
    y_ref, var_ref = fused(*jargs)
    g_ref = jax.grad(lambda *a: jnp.sum((fused(*a)[0] - tgt) ** 2), argnums=(0, 1, 2))(*jargs)
    tx = torch.from_numpy(x).requires_grad_()
    tp = [tuple(torch.from_numpy(a).requires_grad_() for a in p) for p in params]
    th = [torch.from_numpy(a).requires_grad_() for a in head]
    y, _, var = TC.cbg_chain(tx, tp, th)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-4, atol=1e-4)
    for v, vr in zip(var, var_ref):
        np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=1e-4, atol=1e-5)
    gx, gp, gh = g_ref
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=2e-3, atol=2e-2)
    for a, r in zip(tp[0], gp[0]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r).reshape(a.shape),
                                   rtol=2e-3, atol=2e-2)
    for a, r in zip(th, gh):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=2e-3, atol=2e-2)
