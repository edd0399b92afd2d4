"""The 0.1 m voxel of the reference's voxel-size ablations
(``assets/slurm/1_train.sh:74,78``): ``voxel_size=[0.1, 0.1, 6]`` over the
AV2 range is a 1024² grid.  On the CPU in f32, one sample of 4,096 slots
at that grid: the port's pillar coordinates, ids, offsets and validity
(binned on the device and from the host prep's ids), the presorted plan's
flat ids and the unpillar gather through them, each against
``deflow_tpu/ops/voxel.py``; the embedder's 1024² pseudo-image against the
JAX embedder; and ``build_model`` giving the JAX package's grid, which it
derives from range / voxel (``deflow_tpu/models/deflow.py:194-201``).

Tolerances: coordinates, ids, validity, flat ids and the gather (a copy)
equal; offsets and points within 1e-6 m (true f32 division on both
sides); the pseudo-image rtol 1e-4 / atol 1e-5, the embedder bound of
``test_torch_modules.py`` (the JAX embedder computes the centroids on the
device, the port reads them from the host record).  The JAX references
are computed once, by the module fixture.  Torch runs on one thread
(``torch_threads.one_torch_thread``).
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu.config import compose as jax_compose
from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu.models import build_model as jax_build_model
from deflow_tpu.models.embedder import DynamicEmbedder as JaxEmbedder
from deflow_tpu.ops import voxel as jv
from deflow_tpu_torch.config import compose
from deflow_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.models import build_model
from deflow_tpu_torch.models.embedder import DynamicEmbedder
from deflow_tpu_torch.ops import voxel as tv

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import randomize_variables
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

FINE_VOXEL = (0.1, 0.1, 6.0)
FINE_GRID = (1024, 1024)
INFO_INT = ("pillar_id", "valid", "coords_yx")
INFO_FLOAT = ("offsets", "points")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def fine():
    """One sample of 4,096 slots prepped by both packages at the 1024²
    grid, and the JAX package's pillar infos (binned on the device and from
    the host ids), flat ids, gather and pseudo-image."""
    hb = make_host_batch(16, 1, 4096, FINE_VOXEL)
    jb = jax_attach(copy.deepcopy(hb), list(FINE_VOXEL), RANGE, sort=True)
    tb = attach_host_prep(copy.deepcopy(hb), list(FINE_VOXEL), RANGE)
    jcfg = jv.VoxelConfig(FINE_VOXEL, tuple(RANGE))
    pts, mask = jnp.asarray(tb["pc0_transformed"]), jnp.asarray(tb["pc0_mask"])
    ref = SimpleNamespace(info={
        "device": jax.vmap(lambda p, m: jv.compute_pillar_info(p, m, jcfg))(pts, mask),
        "host": jax.vmap(lambda p, m, i: jv.pillar_info_from_ids(p, m, i, jcfg))(
            pts, mask, jnp.asarray(tb["pc0_ids"]))})
    # the presorted plan as the JAX package builds it for its Pallas path
    jv_use_pallas = jv._use_pallas
    jv._use_pallas = lambda: True
    try:
        ref.flat = np.asarray(jv.make_presorted_plan(jnp.asarray(tb["pc0_sorted"]),
                                                     jcfg.num_pillars + jv.TRASH_PAD).pid)
    finally:
        jv._use_pallas = jv_use_pallas
    rng = np.random.default_rng(17)
    ref.table = rng.normal(size=(1, jcfg.num_pillars, 8)).astype(np.float32)
    ref.gathered = np.asarray(jv.pseudoimage_gather_batched(
        jnp.asarray(ref.table), ref.info["host"]))
    # the embedder at this grid, with random weights
    emb = JaxEmbedder(voxel_cfg=jcfg, feat_channels=32)
    host = {k: jnp.asarray(jb[f"pc1_{v}"]) for k, v in
            (("ids", "ids"), ("sorted_id", "sorted"), ("sorted_rec", "sorted_rec"))}
    args = (jnp.asarray(jb["pc1"]), jnp.asarray(jb["pc1_mask"]), False)
    ref.variables = randomize_variables(jax.eval_shape(
        lambda: emb.init(jax.random.key(0), *args, host=host)), 16)
    img, _, _ = emb.apply(ref.variables, *args, host=host)
    ref.image = np.asarray(jv.image_to_table(img, jcfg))
    return SimpleNamespace(tb=tb, cfg=tv.VoxelConfig(FINE_VOXEL, tuple(RANGE)), ref=ref)


@pytest.mark.parametrize("route", ["device", "host"])
def test_pillar_info_at_the_fine_grid(fine, route):
    tb, cfg = fine.tb, fine.cfg
    assert cfg.grid_size[:2] == FINE_GRID and cfg.num_pillars == 2 ** 20
    pts, mask = _t(tb["pc0_transformed"]), _t(tb["pc0_mask"])
    got = (tv.compute_pillar_info(pts, mask, cfg) if route == "device"
           else tv.pillar_info_from_ids(pts, mask, _t(tb["pc0_ids"]), cfg))
    want = fine.ref.info[route]
    for f in INFO_INT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in INFO_FLOAT:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    # the cells reach past the 512² grid's, on both axes
    yx = got.coords_yx[got.valid]
    assert yx.max() > 1000 and (yx[:, 0].max() > 512) and (yx[:, 1].max() > 512)
    assert 0 < int(got.valid.sum()) < 4096


def test_flat_ids_and_gather_at_the_fine_grid(fine):
    tb, cfg, ref = fine.tb, fine.cfg, fine.ref
    flat = tv.make_presorted_plan(_t(tb["pc0_sorted"]), cfg.num_pillars + tv.TRASH_PAD)
    np.testing.assert_array_equal(flat.numpy(), ref.flat)
    info = tv.pillar_info_from_ids(_t(tb["pc0_transformed"]), _t(tb["pc0_mask"]),
                                   _t(tb["pc0_ids"]), cfg)
    got = tv.pseudoimage_gather_batched(_t(ref.table), info)
    np.testing.assert_array_equal(got.numpy(), ref.gathered)
    assert (got.numpy()[0][info.valid[0].numpy()] != 0).all()


def test_embedder_at_the_fine_grid(fine):
    port = DynamicEmbedder(fine.cfg, feat_channels=32).eval()
    port.requires_grad_(False)
    tree = {c: {"embedder": v} for c, v in fine.ref.variables.items()}
    load_reference_state_dict(port, state_dict_from_flax(tree), prefix="embedder.")
    got = port(_t(fine.tb["pc1_sorted_rec"]), _t(fine.tb["pc1_sorted"]), torch.float32)
    want = fine.ref.image
    assert got.shape == want.shape == (1, 2 ** 20, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    occupied = (want != 0).any(-1)
    assert 1000 < occupied.sum() < 4096                  # sparse at 0.1 m


@pytest.mark.parametrize("group", ["deflow", "fastflow3d"])
def test_build_model_gives_the_jax_grid(group):
    """The voxel-size run overrides only ``voxel_size`` (the group keeps
    grid_feature_size [512, 512]); both packages build the 1024² grid."""
    over = [f"model={group}", "voxel_size=[0.1, 0.1, 6]"]
    jmodel = jax_build_model(jax_compose("config", over).model, precision="fp32")
    cfg = compose("config", over)
    assert list(cfg.model.target.grid_feature_size) == [512, 512]
    model = build_model(cfg.model, precision="fp32", device="cpu")
    assert tuple(jmodel.grid_feature_size) == FINE_GRID
    assert model.voxel_cfg.grid_size[:2] == tuple(jmodel.grid_feature_size)
    assert tuple(model.voxel_cfg.voxel_size) == tuple(jmodel.voxel_size)
    assert type(model.head).__name__ == (
        "LinearDecoder" if group == "fastflow3d" else "ConvGRUDecoder")
