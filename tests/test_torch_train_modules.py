"""The training slice's modules against the JAX package on the CPU: losses,
the optimizer, train-mode BatchNorm and the train-mode U-Net (siamese batch
2B = 4, so the U-Net takes the fused encoder chains).  The whole train step
is in ``test_torch_train_step.py``.

Tolerances, each with its reason:
- losses and the optimizer: the same f32 formulas, 1e-6;
- BN outputs and running statistics: reductions in another order, 1e-5;
- the train-mode U-Net: the output 1e-4 (the eval U-Net's bound), the
  statistics 1e-5, the gradients rtol 2e-3 / atol 2e-2 (the bound
  ``tests/test_pallas_cbg.py`` holds the fused U-Net's gradients to: sums of
  O(1e2-1e3) reordered, and the analytically zero biases of the convs before
  a BN);
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deflow_tpu import losses as JL
from deflow_tpu import trainer as JT
from deflow_tpu_torch import losses as TL
from deflow_tpu_torch import trainer as TT
from deflow_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax

from test_torch_host_prep import RANGE
from test_torch_modules import VOXEL, randomize_variables
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ losses
def _loss_inputs(seed, b=2, n=300):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 0.08, (b, n, 3)).astype(np.float32)
    pred = (gt + rng.normal(0, 0.05, (b, n, 3))).astype(np.float32)
    mask = rng.random((b, n)) < 0.8
    classes = rng.integers(0, 5, (b, n)).astype(np.int32)
    return pred, gt, mask, classes


@pytest.mark.parametrize("name", ["deflowLoss", "ff3dLoss", "zeroflowLoss"])
@pytest.mark.parametrize("case", ["mixed", "empty_bucket", "all_invalid"])
def test_losses_match_jax(name, case):
    pred, gt, mask, classes = _loss_inputs(1)
    if case == "empty_bucket":        # no point moves faster than 1 m/s
        gt = np.clip(gt, -0.05, 0.05)
    if case == "all_invalid":
        mask = np.zeros_like(mask)
    want = float(JL.get_loss(name)(*(jnp.asarray(a) for a in (pred, gt, mask, classes))))
    got = TL.get_loss(name)(*(_t(a) for a in (pred, gt, mask, classes)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-7)
    if case == "all_invalid":
        assert got.item() == 0.0
    if case == "empty_bucket" and name == "deflowLoss":
        speed = np.linalg.norm(gt, axis=-1) / 0.1
        assert not (mask & (speed > 1.0)).any() and np.isfinite(got.item())


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("clip", [0.0, 50.0, 0.5], ids=["noclip", "under", "over"])
def test_optimizer_matches_optax(opt, clip):
    rng = np.random.default_rng(3)
    params = [rng.normal(0, 1, s).astype(np.float32) for s in ((4, 5), (7,), (3, 2, 2))]
    grads = [[rng.normal(0, 1, p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    cfg = {"lr": 0.01, "optimizer": opt, "gradient_clip": clip}
    tx = JT.make_optimizer(type("C", (), {"lr": 0.01, "get": cfg.get})())
    jp, state = [jnp.asarray(p) for p in params], None
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    spec = TT.make_optimizer(cfg)
    topt = spec.build(tp)
    for step in grads:
        upd, state = tx.update([jnp.asarray(g) for g in step], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, step):
            p.grad = _t(g)
        norm = TT.apply_gradients(topt, tp, spec.clip)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(step)),
                                   rtol=1e-6)
    if clip == 0.5:
        assert norm.item() > clip
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------- train-mode BN
def test_masked_batch_norm_train_matches_flax():
    from deflow_tpu.models.embedder import MaskedBatchNorm
    from deflow_tpu_torch.models.embedder import masked_batch_norm

    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, (2, 300, 32)).astype(np.float32)
    mask = rng.random((2, 300)) < 0.7
    w = rng.normal(size=x.shape).astype(np.float32)
    var = {"params": {"scale": rng.uniform(0.8, 1.2, 32).astype(np.float32),
                      "bias": rng.uniform(-0.1, 0.1, 32).astype(np.float32)},
           "batch_stats": {"mean": rng.uniform(-0.2, 0.2, 32).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, 32).astype(np.float32)}}

    def jloss(xx):
        y, upd = MaskedBatchNorm().apply(var, xx, jnp.asarray(mask), True,
                                         mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (y_ref, stats)), gx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    bn = torch.nn.BatchNorm1d(32, eps=1e-3, momentum=0.01).train()
    with torch.no_grad():
        bn.weight.copy_(_t(var["params"]["scale"]))
        bn.bias.copy_(_t(var["params"]["bias"]))
        bn.running_mean.copy_(_t(var["batch_stats"]["mean"]))
        bn.running_var.copy_(_t(var["batch_stats"]["var"]))
    tx = _t(x).requires_grad_()
    y = masked_batch_norm(tx, _t(mask), bn)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [8, 1], ids=["map", "1x1_skip"])
def test_conv_with_norms_train_matches_flax(hw):
    from deflow_tpu.models.unet import ConvWithNorms as JCWN
    from deflow_tpu_torch.models.unet import ConvWithNorms

    rng = np.random.default_rng(hw)
    x = rng.normal(size=(4, hw, hw, 16)).astype(np.float32)
    var = {"params": {"conv": {"kernel": rng.normal(0, 0.2, (3, 3, 16, 8)).astype(np.float32),
                               "bias": rng.normal(0, 0.1, 8).astype(np.float32)},
                      "batchnorm": {"scale": rng.uniform(0.8, 1.2, 8).astype(np.float32),
                                    "bias": rng.uniform(-0.1, 0.1, 8).astype(np.float32)}},
           "batch_stats": {"batchnorm": {"mean": rng.uniform(-0.2, 0.2, 8).astype(np.float32),
                                         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}}}
    y_ref, upd = JCWN(8, 3, 1, 1).apply(var, jnp.asarray(x), True, mutable=["batch_stats"])
    m = ConvWithNorms(16, 8, 3, 1, 1).train()
    load_reference_state_dict(m, state_dict_from_flax(var), prefix="")
    y = m(_t(x).permute(0, 3, 1, 2), torch.float32)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    st = upd["batch_stats"]["batchnorm"]
    np.testing.assert_allclose(m.batchnorm.running_mean.numpy(), np.asarray(st["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.batchnorm.running_var.numpy(), np.asarray(st["var"]),
                               rtol=1e-5, atol=1e-6)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_unet_train_matches_jax():
    """The train-mode U-Net at 2B = 4 (the chain route) vs the JAX U-Net in
    train mode on its plain path: output, updated statistics, gradients."""
    from deflow_tpu.models.unet import FastFlow3DUNet as JUNet
    from deflow_tpu_torch.models.unet import FastFlow3DUNet
    from deflow_tpu_torch.ops import voxel as tv

    rng = np.random.default_rng(8)
    imgs = [rng.normal(size=(2, 16, 16, 128)).astype(np.float32) for _ in range(2)]
    w = rng.normal(size=(2, 16, 16, 256)).astype(np.float32)
    jm = JUNet(s2d=True, stem_cin=32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *map(jnp.asarray, imgs)))
    variables = randomize_variables(shapes, 8)

    def jloss(params):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            *map(jnp.asarray, imgs), True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    (_, (out_ref, stats)), grads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])

    port = FastFlow3DUNet(stem_cin=32).train()
    load_reference_state_dict(port, state_dict_from_flax(variables), prefix="")
    cfg = tv.VoxelConfig(VOXEL, tuple(RANGE))
    to_img = lambda a: tv.table_to_image(_t(a).reshape(2, 32 * 32, 32), cfg)
    out = port(to_img(imgs[0]), to_img(imgs[1]), torch.float32)
    got = tv.image_to_table(out, cfg).reshape(2, 16, 16, 256)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out_ref), rtol=1e-4, atol=1e-4)
    sd = port.state_dict()
    for key, v in state_dict_from_flax({"batch_stats": stats}).items():
        if "num_batches" not in key:
            np.testing.assert_allclose(sd[key].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    named = dict(port.named_parameters())
    gsd = state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)})
    assert set(gsd) == set(named)
    for key, g in gsd.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), rtol=2e-3,
                                   atol=2e-2, err_msg=key)


