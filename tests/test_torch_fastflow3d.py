"""The FastFlow3D head (``decoder_option=linear``, ``conf/model/
fastflow3d.yaml``) through the port's eval step against the JAX package's
eval step on the CPU in f32, on the host-sorted batch and on the raw batch
(device binning); and the reference's other ablations of the train step
(``assets/slurm/1_train.sh``, README:68) against
``deflow_tpu.trainer.make_train_step``: FastFlow3D with ff3dLoss (the
classes given) under Adam at lr 4e-5, and the DeFlow head at
``num_iters=2`` with zeroflowLoss under SGD with a gradient clip below the
step's norm, so that it acts.

Tolerances: the eval's flow within 2e-4 m, the bound of
``test_torch_slice.py`` (convolution stacks reordered); the train step's,
those of ``test_torch_train_step.py`` at the case's lr (loss and aux 1e-5
relative; every gradient 1e-4 of its parameter's largest element, the
JAX gradients scaled by the clip's factor; parameters after the step
1e-6 + lr·1e-2, the zero-gradient conv biases 2·lr).  SGD moves an
element by lr·g, mostly far below that, so under SGD each parameter's
change in the step is also held to JAX's change, within 1e-2 of its
largest element plus one f32 spacing of the parameter's largest value
(the step rounds to it).  Torch runs on one thread
(``torch_threads.one_torch_thread``).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deflow_tpu import trainer as JT
from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu.models import DeFlow as JaxDeFlow
from deflow_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.models.deflow import DeFlow
from deflow_tpu_torch.trainer import make_eval_step

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import GRID, VOXEL, randomize_variables
from test_torch_train_step import _pair, assert_step_matches_jax, run_steps
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

# the train-step cases: model keys, loss, optimizer keys
STEP_CASES = {
    "ff3d_adam": ({"decoder_option": "linear"}, "ff3dLoss", {"lr": 4e-5}),
    "iters2_zeroflow_sgd_clip": ({"num_iters": 2}, "zeroflowLoss",
                                 {"lr": 2e-4, "optimizer": "sgd", "gradient_clip": 0.05}),
}


@pytest.fixture(scope="module")
def host_batch():
    """The batch every case of the file starts from (each copies it)."""
    return make_host_batch(21, 2, 512, VOXEL)


@pytest.mark.parametrize("route", ["hosted", "device"])
def test_fastflow3d_eval_matches_jax(route, host_batch):
    hb = copy.deepcopy(host_batch)
    jm = JaxDeFlow(voxel_size=VOXEL, point_cloud_range=tuple(RANGE),
                   grid_feature_size=GRID, decoder_option="linear")
    args = [jnp.asarray(hb[k]) for k in
            ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask")]
    variables = randomize_variables(
        jax.eval_shape(lambda: jm.init(jax.random.key(0), *args)), 21)
    port = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE, grid_feature_size=GRID,
                  decoder_option="linear").eval()
    load_reference_state_dict(port, state_dict_from_flax(variables))
    if route == "hosted":
        jb = jax_attach(copy.deepcopy(hb), list(VOXEL), RANGE, sort=True)
        tb = attach_host_prep(copy.deepcopy(hb), list(VOXEL), RANGE)
    else:
        jb, tb = hb, copy.deepcopy(hb)
    want = JT.make_eval_step(jm)(variables["params"], variables["batch_stats"],
                                 {k: jnp.asarray(v) for k, v in jb.items()})
    got = make_eval_step(port, device="cpu")(tb)
    valid = got["pc0_valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["pc0_valid"]))
    assert valid.any() and not valid.all()
    for k in ("pred_flow", "net_flow", "pose_flow"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (2, 512, 3) and np.isfinite(g).all()
        assert np.abs(g - w).max() < 2e-4, k
    assert np.abs(got["net_flow"].numpy()[valid]).max() > 1e-2     # not all zero


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case, host_batch):
    model_kw, loss_name, opt = STEP_CASES[case]
    jstate, jaux, jgrads, state, aux = run_steps(copy.deepcopy(host_batch), loss_name,
                                                 model_kw=model_kw, opt=opt)
    clip = opt.get("gradient_clip", 0.0)
    assert not clip or float(jaux["grad_norm"]) > clip        # the clip acts
    assert state.model.head.__class__.__name__ == (
        "LinearDecoder" if model_kw.get("decoder_option") == "linear" else "ConvGRUDecoder")
    assert_step_matches_jax(jstate, jaux, jgrads, state, aux, lr=opt["lr"], clip=clip)
    if opt.get("optimizer") == "sgd":
        _, variables, *_ = _pair(copy.deepcopy(host_batch), "fp32", model_kw=model_kw)
        before = state_dict_from_flax({"params": jax.tree.map(np.asarray,
                                                              variables["params"])})
        after = state_dict_from_flax({"params": jax.tree.map(np.asarray, jstate.params)})
        got = state.model.state_dict()
        seen = 0
        for key, b in before.items():
            b = b.numpy().astype(np.float64)
            dj, dp = after[key].numpy() - b, got[key].numpy() - b
            spacing = np.spacing(np.float32(np.abs(b).max()))
            np.testing.assert_allclose(dp, dj, rtol=0,
                                       atol=1e-2 * np.abs(dj).max() + spacing, err_msg=key)
            seen += np.abs(dj).max() > 10 * spacing
        assert seen > 0          # the step moved parameters by more than its rounding
