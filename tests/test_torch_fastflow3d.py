"""The FastFlow3D head (``decoder_option=linear``, ``conf/model/
fastflow3d.yaml``) through the port's eval step against the JAX package's
eval step on the CPU in f32, on the host-sorted batch and on the raw batch
(device binning).  Tolerance: the flow within 2e-4 m, the bound of
``test_torch_slice.py`` (convolution stacks reordered)."""

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


@pytest.mark.parametrize("route", ["hosted", "device"])
def test_fastflow3d_eval_matches_jax(route):
    hb = make_host_batch(21, 2, 512, VOXEL)
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
