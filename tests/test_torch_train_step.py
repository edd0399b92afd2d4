"""The whole supervised train step of the port vs
``deflow_tpu.trainer.make_train_step`` on the CPU (B = 2, N = 512, 32x32
grid, 4 GRU iterations; the siamese batch 2B = 4 takes the fused encoder
chains), with the same random weights carried across by ``convert.py``.

Tolerances, each with its reason:
- f32: loss and aux 1e-5 relative; updated batch statistics 1e-5 (sums in
  another order); each parameter's gradient within 1e-4 of its largest
  element (the worst leaf lands near 1e-5), except the biases of the convs
  before a train-mode BN.  Their gradient is zero in exact arithmetic, so
  each side holds rounding noise: both are held below 1e-4 of the largest
  gradient of the same conv's weight.  Updated parameters 1e-6 + lr·1e-2
  after one Adam step; Adam's first step, lr·g/(|g| + eps), is ±lr for any
  gradient that is not tiny, so this checks the signs, and the gradient
  check above the sizes.  The zero-gradient biases can step anywhere in
  [−lr, lr] and are held to 2·lr;
- bf16: loss within 2e-2 relative (bf16 rounds at other places in the two
  frameworks).
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from deflow_tpu import trainer as JT
from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu.models import DeFlow as JaxDeFlow
from deflow_tpu_torch import trainer as TT
from deflow_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.models.deflow import DeFlow

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import GRID, VOXEL, randomize_variables
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

LR = 2e-4


def _pair(hb, precision, seed=21, model_kw=None):
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    kw = {"num_iters": 4, **(model_kw or {})}
    jm = JaxDeFlow(voxel_size=VOXEL, point_cloud_range=tuple(RANGE),
                   grid_feature_size=GRID, dtype=dt, **kw)
    args = [jnp.asarray(hb[k]) for k in
            ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask")]
    variables = randomize_variables(
        jax.eval_shape(lambda: jm.init(jax.random.key(0), *args)), seed)
    port = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE, grid_feature_size=GRID,
                  dtype=torch.bfloat16 if precision == "bf16" else torch.float32, **kw)
    load_reference_state_dict(port, state_dict_from_flax(variables))
    jb = jax_attach(copy.deepcopy(hb), list(VOXEL), RANGE, sort=True)
    tb = attach_host_prep(copy.deepcopy(hb), list(VOXEL), RANGE)
    return jm, variables, port, jb, tb


def run_steps(hb, loss_name="deflowLoss", precision="fp32", remat=False,
              model_kw=None, opt=None):
    """One step on each side from the host batch ``hb`` (with ``remat``,
    each side's step recomputes its forward in the backward).  Returns the
    JAX state, aux and gradients (read by a pass-through transform chained
    before the optimizer, so before any clip) and the port's state and aux;
    the port's gradients (after its clip) stay in each parameter's
    ``.grad``.  ``model_kw`` overrides the model's ``num_iters`` (4) or sets
    its ``decoder_option``; ``opt`` the optimizer keys (``lr``,
    ``optimizer``, ``gradient_clip``; Adam at LR by default)."""
    jm, variables, port, jb, tb = _pair(hb, precision, model_kw=model_kw)
    cfg = {"lr": LR, "optimizer": "adam", **(opt or {})}
    seen = {}

    def keep(updates, state, params=None):
        seen["grads"] = updates
        return updates, state

    tx = optax.chain(optax.GradientTransformation(lambda p: optax.EmptyState(), keep),
                     JT.make_optimizer(type("C", (), {"lr": cfg["lr"], "get": cfg.get})()))
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstate, jaux = JT.make_train_step(jm, loss_name, remat=remat)(
        jstate, JT.device_batch(jb, None))
    state = TT.init_train_state(port, cfg, device="cpu")
    state, aux = TT.make_train_step(port, loss_name, device="cpu", remat=remat)(state, tb)
    return jstate, jaux, seen["grads"], state, aux


def assert_step_matches_jax(jstate, jaux, jgrads, state, aux, lr=LR, clip=0.0):
    """The f32 tolerances of the module docstring, at learning rate ``lr``:
    aux, parameters and BN statistics after the step, and every parameter's
    gradient; with a ``clip`` the JAX gradients (taken before its clip) are
    scaled by min(1, clip / grad_norm) as the port's clipped ones are."""
    assert state.step == 1
    for k in ("loss", "epe", "valid_points", "grad_norm"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    assert 0 < float(aux["valid_points"]) < 2 * 512
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jstate.params),
                                 "batch_stats": jax.tree.map(np.asarray,
                                                             jstate.batch_stats)})
    got = state.model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        if "num_batches" in key:
            continue
        g = got[key].numpy()
        if "running" in key:
            tol = 1e-5
        elif key.startswith("backbone.encoder_step_") and key.endswith("conv.bias"):
            tol = 2 * lr
        else:
            tol = 1e-6 + lr * 1e-2
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=tol, err_msg=key)
    named = dict(state.model.named_parameters())
    scale = min(1.0, clip / float(jaux["grad_norm"])) if clip > 0 else 1.0
    want = state_dict_from_flax({"params": jax.tree.map(lambda g: np.asarray(g) * scale,
                                                        jgrads)})
    assert set(want) == set(named)
    for key, w in want.items():
        g, w = named[key].grad.numpy(), w.numpy()
        if key.startswith("backbone.encoder_step_") and key.endswith("conv.bias"):
            scale = np.abs(want[key[:-4] + "weight"].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-4 * scale, key
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=key)


def test_train_step_matches_jax_f32():
    assert_step_matches_jax(*run_steps(make_host_batch(21, 2, 512, VOXEL)))


def test_train_step_matches_jax_bf16():
    _, jaux, _, state, aux = run_steps(make_host_batch(21, 2, 512, VOXEL),
                                       precision="bf16")
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=2e-2)
    assert all(np.isfinite(p.detach().float().numpy()).all()
               for p in state.model.parameters())
