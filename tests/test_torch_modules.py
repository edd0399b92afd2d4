"""Port modules vs their JAX modules in f32 on a 32x32 grid (voxel 3.2 m).

Weights and BN running statistics are random (numpy, seeded) in the JAX
variable tree and reach the port through ``deflow_tpu_torch.convert``.
The JAX embedder on the CPU computes the pillar centroids on the device,
the port reads them from the host record; the two paths agree to
rtol 1e-4 / atol 1e-5 (the bound ``tests/test_host_prep.py`` holds the two
JAX paths to).  Convolution stacks are held to 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu.convert import export_state_dict
from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu.models import DeFlow as JaxDeFlow
from deflow_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.models.deflow import DeFlow
from deflow_tpu_torch.ops import voxel as tv

from test_torch_host_prep import RANGE, make_host_batch
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

VOXEL = (3.2, 3.2, 6.0)
GRID = (32, 32)


def randomize_variables(variables, seed):
    """Random params (fan-in scaled) and BN running stats, as numpy."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name == "kernel":
            bound = float(np.prod(shape[:-1])) ** -0.5
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "mean": (-0.2, 0.2),
                  "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def make_pair(seed=0, num_iters=4, b=2, n=512):
    """(JAX model, its random variables, port model with the same weights,
    a host batch prepped by JAX and a copy prepped by the port)."""
    hb = make_host_batch(seed, b, n, VOXEL)
    jm = JaxDeFlow(voxel_size=VOXEL, point_cloud_range=tuple(RANGE),
                   grid_feature_size=GRID, num_iters=num_iters)
    args = [jnp.asarray(hb[k]) for k in
            ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask")]
    # every leaf is replaced, so the variable shapes are all init must give
    variables = randomize_variables(
        jax.eval_shape(lambda: jm.init(jax.random.key(0), *args)), seed)
    port = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE,
                  grid_feature_size=GRID, num_iters=num_iters).eval()
    port.requires_grad_(False)
    load_reference_state_dict(port, state_dict_from_flax(variables))
    jb = jax_attach(copy.deepcopy(hb), list(VOXEL), RANGE, sort=True)
    tb = attach_host_prep(copy.deepcopy(hb), list(VOXEL), RANGE)
    return jm, variables, port, jb, tb


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _sub(variables, name):
    return {c: variables[c][name] for c in ("params", "batch_stats")
            if name in variables[c]}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_state_dict_keys_match_reference_layout(pair):
    from torch_twin import TorchDeFlow

    _, variables, port, _, _ = pair
    exported = {k[len("model."):] for k in export_state_dict(variables)}
    twin = set(TorchDeFlow(voxel_size=VOXEL,
                           point_cloud_range=tuple(RANGE)).state_dict())
    assert set(port.state_dict()) == exported == twin


def test_pose_ops_match_jax():
    from deflow_tpu.ops.pose import cal_pose0to1 as jcal, transform_points as jtp
    from deflow_tpu_torch.ops.pose import cal_pose0to1, transform_points

    hb = make_host_batch(3, 2, 64, VOXEL)
    pose = cal_pose0to1(_t(hb["pose0"]), _t(hb["pose1"]))
    jpose = jcal(jnp.asarray(hb["pose0"]), jnp.asarray(hb["pose1"]))
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-6)
    np.testing.assert_allclose(transform_points(_t(hb["pc0"]), pose).numpy(),
                               np.asarray(jtp(jnp.asarray(hb["pc0"]), jpose)),
                               atol=1e-5)


@pytest.mark.parametrize("voxel", [VOXEL, (3.3, 3.2, 6.0)],
                         ids=["s2d", "row_major"])
def test_pillar_info_matches_jax(voxel):
    from deflow_tpu.ops import voxel as jv

    hb = make_host_batch(4, 2, 600, voxel)
    tb = attach_host_prep(copy.deepcopy(hb), list(voxel), RANGE)
    jcfg = jv.VoxelConfig(voxel, tuple(RANGE))
    tcfg = tv.VoxelConfig(voxel, tuple(RANGE))
    pts, mask = tb["pc0_transformed"], tb["pc0_mask"]
    want_dev = jax.vmap(lambda p, m: jv.compute_pillar_info(p, m, jcfg))(
        jnp.asarray(pts), jnp.asarray(mask))
    want_host = jax.vmap(lambda p, m, i: jv.pillar_info_from_ids(p, m, i, jcfg))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(tb["pc0_ids"]))
    got_dev = tv.compute_pillar_info(_t(pts), _t(mask), tcfg)
    got_host = tv.pillar_info_from_ids(_t(pts), _t(mask), _t(tb["pc0_ids"]), tcfg)
    for got, want in ((got_dev, want_dev), (got_host, want_host)):
        for f in ("pillar_id", "valid", "coords_yx"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
        for f in ("offsets", "points"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    # host ids and device binning agree on this cloud
    np.testing.assert_array_equal(got_dev.pillar_id.numpy(),
                                  got_host.pillar_id.numpy())


def test_embedder_matches_jax(pair):
    from deflow_tpu.models.embedder import DynamicEmbedder as JEmb
    from deflow_tpu.ops.voxel import VoxelConfig, image_to_table

    _, variables, port, jb, tb = pair
    jcfg = VoxelConfig(VOXEL, tuple(RANGE))
    host = {"ids": jnp.asarray(jb["pc1_ids"]),
            "sorted_id": jnp.asarray(jb["pc1_sorted"]),
            "sorted_rec": jnp.asarray(jb["pc1_sorted_rec"])}
    img, _, _ = JEmb(voxel_cfg=jcfg, feat_channels=32).apply(
        _sub(variables, "embedder"), jnp.asarray(jb["pc1"]),
        jnp.asarray(jb["pc1_mask"]), False, host=host)
    want = np.asarray(image_to_table(img, jcfg))
    got = port.embedder(_t(tb["pc1_sorted_rec"]), _t(tb["pc1_sorted"]),
                        torch.float32)
    assert got.shape == want.shape == (2, 32 * 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert (want == 0).any(axis=-1).any()   # some pillars are empty


def test_unet_matches_jax(pair):
    from deflow_tpu.models.unet import FastFlow3DUNet as JUNet

    _, variables, port, _, _ = pair
    rng = np.random.default_rng(5)
    # phase-folded JAX images [B, H/2, W/2, 4*32] == id-ordered tables
    imgs = [rng.normal(size=(2, 16, 16, 128)).astype(np.float32)
            for _ in range(2)]
    want = np.asarray(JUNet(s2d=True, stem_cin=32).apply(
        _sub(variables, "backbone"), *(jnp.asarray(i) for i in imgs)))
    cfg = port.voxel_cfg
    to_img = lambda a: tv.table_to_image(_t(a).reshape(2, 32 * 32, 32), cfg)
    out = port.backbone(to_img(imgs[0]), to_img(imgs[1]), torch.float32)
    assert out.shape == (2, 64, 32, 32)
    got = tv.image_to_table(out, cfg).numpy()
    np.testing.assert_allclose(got, want.reshape(2, 32 * 32, 64),
                               rtol=1e-4, atol=1e-4)


def test_image_table_roundtrip_is_s2d_order():
    cfg = tv.VoxelConfig(VOXEL, tuple(RANGE))
    cy, cx = torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij")
    ids = tv.encode_pillar_id(cy, cx, cfg)            # [H, W]
    table = torch.zeros(1, 32 * 32, 2)
    table[0, ids.reshape(-1), 0] = cy.reshape(-1).float()
    table[0, ids.reshape(-1), 1] = cx.reshape(-1).float()
    img = tv.table_to_image(table, cfg)
    assert torch.equal(img[0, 0], cy.float()) and torch.equal(img[0, 1], cx.float())
    assert torch.equal(tv.image_to_table(img, cfg), table)


def test_decoder_matches_jax(pair):
    from deflow_tpu.models.decoder import ConvGRUDecoder as JDec
    from deflow_tpu.ops.voxel import VoxelConfig, pillar_info_from_ids

    _, variables, port, jb, tb = pair
    jcfg = VoxelConfig(VOXEL, tuple(RANGE))
    rng = np.random.default_rng(6)
    tabs = [rng.normal(size=(2, 32 * 32, 64)).astype(np.float32)
            for _ in range(2)]
    jinfo = jax.vmap(lambda p, m, i: pillar_info_from_ids(p, m, i, jcfg))(
        jnp.asarray(jb["pc0_transformed"]), jnp.asarray(jb["pc0_mask"]),
        jnp.asarray(jb["pc0_ids"]))
    want = np.asarray(JDec(num_iters=4).apply(
        _sub(variables, "head"), *(jnp.asarray(t) for t in tabs), jinfo))
    tinfo = tv.pillar_info_from_ids(_t(tb["pc0_transformed"]),
                                    _t(tb["pc0_mask"]), _t(tb["pc0_ids"]),
                                    port.voxel_cfg)
    got = port.head(_t(tabs[0]), _t(tabs[1]), tinfo, torch.float32)
    assert got.shape == (2, 512, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert (got[~tinfo.valid] == 0).all()
