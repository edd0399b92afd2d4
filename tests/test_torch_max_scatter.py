"""``scatter_mode="max"`` (the pillar max scatter) against the JAX package on
the CPU: the scatter itself with ties, forward and gradient, in f32 and bf16,
through the device sort's plan and the presorted plan; the embedder in train
mode on both routes (host-sorted ids and device binning); and the whole eval
step with the max embedder on both routes.

Tolerances, each with its reason: the max is exact (the same f32 or bf16
values, selected); its gradient, the cotangent split evenly over tied
points, within two roundings of the compute type, 2^-22 (f32) and 2^-7
(bf16) relative (JAX rounds the share 1/k and then the product, torch
divides once); the embedder's table 1e-5 and its parameter gradients 1e-4
of their largest element (the same sums in another order; the count and
centroid segment-sums reordered); the eval step's flow 2e-4 m (the bound of
``test_torch_slice.py``).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu_torch.convert import state_dict_from_flax
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.ops import voxel as tv
from deflow_tpu_torch.trainer import make_eval_step

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import VOXEL, _sub, make_pair
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tied_feats(rng, pid, valid, c):
    """Features [B, N, C] with ties inside pillars: every third valid point
    copies the row of an earlier point of its pillar, and a quarter of the
    entries are 0 (the ReLU's floor)."""
    b, n = pid.shape
    f = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    f[rng.random((b, n, c)) < 0.25] = 0.0
    for s in range(b):
        first = {}
        for i in range(n):
            if not valid[s, i]:
                continue
            j = first.setdefault(pid[s, i], i)
            if j != i and i % 3 == 0:
                f[s, i] = f[s, j]
    return f


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("route", ["device", "presorted"])
def test_pillar_max_scatter_matches_jax(dtype, route):
    from deflow_tpu.ops import voxel as jv

    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(7)
    voxel = (6.4, 6.4, 6.0)                     # 16 x 16: many points a pillar
    hb = make_host_batch(5, 2, 600, voxel)
    tb = attach_host_prep(copy.deepcopy(hb), list(voxel), RANGE)
    jcfg = jv.VoxelConfig(voxel, tuple(RANGE))
    tcfg = tv.VoxelConfig(voxel, tuple(RANGE))
    p, seg = tcfg.num_pillars, tcfg.num_pillars + tv.TRASH_PAD
    if route == "device":
        pts, mask = hb["pc1"], hb["pc1_mask"]
        info = tv.compute_pillar_info(torch.from_numpy(pts), torch.from_numpy(mask), tcfg)
        plan = tv.make_batched_scatter_plan(info.pillar_id, seg)
    else:
        pts, mask = tb["pc1"], tb["pc1_mask"]
        ids = torch.from_numpy(tb["pc1_ids"])
        info = tv.pillar_info_from_ids(torch.from_numpy(pts), torch.from_numpy(mask),
                                       ids, tcfg)
        plan = tv.make_presorted_scatter_plan(ids, seg)
    pid, valid = info.pillar_id.numpy(), info.valid.numpy()
    feats = _tied_feats(rng, pid, valid, 16)
    w = rng.normal(0, 1, (2, p, 16)).astype(np.float32)
    jinfo = jv.PillarInfo(jnp.asarray(pid), jnp.asarray(valid), None, None, None)

    def jfun(f):
        img = jax.vmap(lambda ff, i, v: jv.pillar_max_scatter(
            ff, jv.PillarInfo(i, v, None, None, None), jcfg))(f, jinfo.pillar_id,
                                                              jinfo.valid)
        return img.reshape(2, p, 16)

    jf = jnp.asarray(feats).astype(jdt)
    want, vjp = jax.vjp(jfun, jf)
    (jgrad,) = vjp(jnp.asarray(w).astype(jdt))
    tf = torch.from_numpy(feats).to(tdt).requires_grad_()
    got = tv.pillar_max_scatter_batched(tf, info, tcfg, plan)
    got.backward(torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (2, p, 16)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    empty = np.stack([~np.isin(np.arange(p), pid[s_][valid[s_]]) for s_ in range(2)])
    assert empty.any() and (got.detach()[torch.from_numpy(empty)] == 0).all()
    g = tf.grad.float().numpy()
    jg = np.asarray(jgrad.astype(jnp.float32))
    np.testing.assert_allclose(g, jg, rtol=2 ** -22 if dtype == "f32" else 2 ** -7, atol=0)
    # ties split the cotangent: some point gets a share strictly between 0
    # and its pillar's whole cotangent
    whole = np.abs(np.take_along_axis(w, np.where(valid, pid, 0)[..., None], 1))
    assert ((g != 0) & (np.abs(g) < 0.99 * whole))[valid].any()
    assert (g[~valid] == 0).all()


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=3)


@pytest.mark.parametrize("route", ["hosted", "device"])
def test_max_embedder_train_matches_jax(pair, route):
    """The embedder with ``scatter_mode="max"`` in train mode: the pillar
    table, the BN running statistics and the gradients of its parameters
    against the JAX embedder's, with the host's ids (the JAX package skips
    the sorted record under max) and with device binning."""
    from deflow_tpu.models.embedder import DynamicEmbedder as JEmb
    from deflow_tpu.ops.voxel import VoxelConfig, image_to_table

    _, variables, port, jb, tb = pair
    jcfg = VoxelConfig(VOXEL, tuple(RANGE))
    hosted = route == "hosted"
    host = ({"ids": jnp.asarray(jb["pc0_ids"]), "sorted_id": jnp.asarray(jb["pc0_sorted"]),
             "sorted_rec": jnp.asarray(jb["pc0_sorted_rec"])} if hosted else None)
    pts, mask = (jb["pc0_transformed"], jb["pc0_mask"])
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1, (2, 32 * 32, 32)).astype(np.float32)
    sub = _sub(variables, "embedder")

    def jloss(params):
        (img, _, _), upd = JEmb(voxel_cfg=jcfg, feat_channels=32, scatter_mode="max").apply(
            {"params": params, "batch_stats": sub["batch_stats"]}, jnp.asarray(pts),
            jnp.asarray(mask), True, host=host, mutable=["batch_stats"])
        table = image_to_table(img, jcfg)
        return jnp.sum(table * w), (table, upd["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(jloss, has_aux=True)(sub["params"])
    emb = copy.deepcopy(port.embedder).train().requires_grad_(True)
    emb.scatter_mode = "max"
    tpts = tb["pc0_transformed"] if hosted else pts
    tmask = tb["pc0_mask"] if hosted else mask
    got, info, _ = emb.embed_points(torch.from_numpy(tpts), torch.from_numpy(tmask),
                                    torch.float32,
                                    ids=torch.from_numpy(tb["pc0_ids"]) if hosted else None)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (np.asarray(want) == 0).all(axis=-1).any()       # empty pillars
    sd = emb.state_dict()
    for key, v in state_dict_from_flax({"batch_stats": {"embedder": stats}}).items():
        if "num_batches" not in key:
            np.testing.assert_allclose(sd[key[len("embedder."):]].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    named = dict(emb.named_parameters())
    gsd = state_dict_from_flax({"params": {"embedder": jax.tree.map(np.asarray, grads)}})
    for key, g in gsd.items():
        a = named[key[len("embedder."):]].grad.numpy()
        np.testing.assert_allclose(a, g.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(g.numpy()).max(), err_msg=key)


@pytest.mark.parametrize("route", ["hosted", "device"])
def test_max_eval_step_matches_jax(pair, monkeypatch, route):
    """The eval step of a DeFlow whose embedder takes the max, on the
    host-sorted batch (no sorted-record shortcut: the centroids on the
    device over the host's ids) and on the raw batch."""
    import deflow_tpu.models.deflow as JD
    from deflow_tpu import trainer as JT

    orig = JD.DynamicEmbedder
    monkeypatch.setattr(JD, "DynamicEmbedder",
                        lambda *a, **kw: orig(*a, scatter_mode="max", **kw))
    jm, variables, port, jb, tb = pair
    jm = jm.clone()
    if route == "device":
        raw = make_host_batch(3, 2, 512, VOXEL)
        jb, tb = raw, copy.deepcopy(raw)
    want = JT.make_eval_step(jm)(variables["params"], variables["batch_stats"],
                                 {k: jnp.asarray(v) for k, v in jb.items()})
    model = copy.deepcopy(port)
    model.embedder.scatter_mode = "max"
    got = make_eval_step(model, device="cpu")(tb)
    base = make_eval_step(port, device="cpu")(tb)
    valid = got["pc0_valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["pc0_valid"]))
    for k in ("pred_flow", "net_flow"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.isfinite(g).all() and np.abs(g - w).max() < 2e-4, k
    # the max and the mean embed differently
    assert np.abs(got["net_flow"].numpy() - base["net_flow"].numpy())[valid].max() > 1e-3
