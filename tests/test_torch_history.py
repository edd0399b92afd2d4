"""The port's device binning path (no host prep) and its multi-frame
history (``num_frames > 2``) against the JAX package, on the CPU in f32.

Where the JAX function reaches a Pallas kernel (its planned scatter over a
device sort), it runs in interpret mode, as ``tests/test_pallas_scatter.py``
runs it.

Tolerances, each with its reason:
- the planned segment-sum, its backward, the planned gather and its
  backward: 1e-5 (f32 sums in another order); the plan's sorted ids and
  order exactly (one stable sort on each side);
- the centroid offsets and the embedder's pillar table: 1e-5 and rtol
  1e-4 / atol 1e-5 (``tests/test_torch_modules.py``'s embedder bound);
- the eval step without host prep: ``pred_flow`` 2e-4, as the host-sorted
  eval step (``tests/test_torch_slice.py``);
- the ``num_frames=3`` train step: ``tests/test_torch_train_step.py``'s f32
  tolerances (loss and aux 1e-5 relative, BN statistics 1e-5, gradients
  1e-4 of each parameter's largest element, parameters after one Adam
  step 1e-6 + lr·1e-2), ``history_fuse`` included; the eval step with a
  history frame 2e-4.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu import trainer as JT
from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu.models import DeFlow as JaxDeFlow
from deflow_tpu_torch import trainer as TT
from deflow_tpu_torch.config import compose
from deflow_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.data.synthetic import make_split
from deflow_tpu_torch.entry import evaluate
from deflow_tpu_torch.entry import train as TE
from deflow_tpu_torch.models.deflow import DeFlow
from deflow_tpu_torch.ops import scatter
from deflow_tpu_torch.ops import voxel as tv

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import GRID, VOXEL, randomize_variables
from test_torch_train_kernels import interpret_pallas  # noqa: F401 (a fixture)
from test_torch_train_step import LR, assert_step_matches_jax
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _t(a):
    return torch.from_numpy(np.array(a))


def history_batch(seed, b=2, n=512, frames=1, voxel=VOXEL):
    """``make_host_batch`` plus ``frames`` history clouds (``pch{h}``,
    their masks and poses), as the loader emits them."""
    hb = make_host_batch(seed, b, n, voxel)
    rng = np.random.default_rng(seed + 1000)
    for h in range(1, frames + 1):
        hb[f"pch{h}"] = np.stack([rng.uniform(-56, 56, (b, n)), rng.uniform(-56, 56, (b, n)),
                                  rng.uniform(-3.5, 3.5, (b, n))], -1).astype(np.float32)
        hb[f"pch{h}_mask"] = rng.random((b, n)) < 0.85
        pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        pose[:, :3, 3] = rng.uniform(-2, 2, (b, 3))
        hb[f"pose_pch{h}"] = pose
    return hb


def model_pair(hb, seed, num_frames=2, voxel=VOXEL, grid=GRID):
    jm = JaxDeFlow(voxel_size=voxel, point_cloud_range=tuple(RANGE),
                   grid_feature_size=grid, num_iters=4, num_frames=num_frames)
    args = [jnp.asarray(hb[k]) for k in
            ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask")]
    hist = JT.history_from_batch({k: jnp.asarray(v) for k, v in hb.items()
                                  if k.startswith(("pch", "pose_pch"))})
    variables = randomize_variables(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), *args, history=hist)), seed)
    port = DeFlow(voxel_size=voxel, point_cloud_range=RANGE, grid_feature_size=grid,
                  num_iters=4, num_frames=num_frames).eval()
    load_reference_state_dict(port, state_dict_from_flax(variables))
    return jm, variables, port


def _ids(rng, b, n, p):
    """Pillar ids in the points' own order, trash (``p``) among them."""
    ids = rng.integers(0, p, (b, n))
    ids[rng.random((b, n)) < 0.2] = p
    return ids.astype(np.int32)


# ------------------------------------------------------------- voxel ops
def test_plan_is_one_stable_sort():
    rng = np.random.default_rng(0)
    b, n, p = 3, 700, 256
    s = p + tv.TRASH_PAD
    ids = _ids(rng, b, n, p)
    plan = tv.make_batched_scatter_plan(_t(ids), s)
    flat = (ids + np.arange(b)[:, None] * s).reshape(-1)
    order = np.argsort(flat, kind="stable")
    np.testing.assert_array_equal(plan.order.numpy(), order)
    sentinel = scatter.sentinel_for(b * s)
    want_sorted = np.where(flat[order] % s < p, flat[order], sentinel)
    np.testing.assert_array_equal(plan.sorted_ids.numpy(), want_sorted)
    np.testing.assert_array_equal(plan.flat_ids.numpy(),
                                  np.where(flat % s < p, flat, sentinel))
    assert scatter.plan_is_sorted(plan.sorted_ids, b * s, b)
    assert not scatter.plan_is_sorted(plan.flat_ids, b * s, b)
    assert (plan.num_rows, plan.samples) == (b * s, b)


def test_planned_segment_sum_matches_jax(interpret_pallas):
    """The scatter through a device plan and its backward (a gather at each
    point's own flat id, trash reading zeros) against the JAX package's
    planned Pallas scatter (``make_batched_scatter_plan``)."""
    from deflow_tpu.ops import voxel as jv

    rng = np.random.default_rng(1)
    b, n, p, c = 2, 700, 4096, 33          # B·(P + 8) ≥ 8192: the Pallas plan
    s = p + tv.TRASH_PAD
    ids = _ids(rng, b, n, p)
    data = rng.normal(size=(b, n, c)).astype(np.float32)
    wout = rng.normal(size=(b, s, c)).astype(np.float32)
    jids = jnp.asarray(ids)
    jplan = jv.make_batched_scatter_plan(jids, s)
    assert jplan is not None and jplan.order is not None

    def jloss(d):
        out = jv.segment_sum_batched(d, jids, s, jplan)
        return jnp.sum(out[:, :p] * wout[:, :p]), out

    (_, jout), want = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(data))
    td = _t(data).requires_grad_()
    plan = tv.make_batched_scatter_plan(_t(ids), s)
    out = tv.segment_sum_planned(td, plan)
    (out[:, :p] * _t(wout)[:, :p]).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[:, :p], np.asarray(jout)[:, :p],
                               rtol=1e-5, atol=1e-5)
    assert (out.detach().numpy()[:, p:] == 0).all()       # trash adds nowhere
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (td.grad.numpy()[ids >= p] == 0).all()


def test_planned_gather_matches_jax(interpret_pallas):
    """The unpillar gather of points in their own order and its backward
    (the planned segment-sum) against ``pseudoimage_gather_batched`` with
    the JAX package's device plan."""
    from deflow_tpu.ops import voxel as jv

    rng = np.random.default_rng(2)
    b, n, p, c = 2, 700, 4096, 128         # B·(P + 8) ≥ 8192: the Pallas plan
    ids = _ids(rng, b, n, p)
    valid = ids < p
    table = rng.normal(size=(b, p, c)).astype(np.float32)
    wout = rng.normal(size=(b, n, c)).astype(np.float32)
    zeros = jnp.zeros((b, n, 3))
    jinfo = jv.PillarInfo(jnp.asarray(ids), jnp.asarray(valid),
                          jnp.zeros((b, n, 2), jnp.int32), zeros, zeros)
    jplan = jv.make_batched_scatter_plan(jnp.asarray(ids), p + jv.TRASH_PAD)
    assert jplan is not None and jplan.order is not None

    def jloss(t):
        out = jv.pseudoimage_gather_batched(t, jinfo, jplan)
        return jnp.sum(out * wout), out

    (_, jout), want = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(table))
    tt = _t(table).requires_grad_()
    tinfo = tv.PillarInfo(_t(ids), _t(valid), None, None, None)
    plan = tv.make_batched_scatter_plan(_t(ids), p + tv.TRASH_PAD)
    out = tv.pseudoimage_gather_batched(tt, tinfo, plan)
    (out * _t(wout)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (np.asarray(want) != 0).any() and (np.asarray(want) == 0).any()


@pytest.mark.parametrize("voxel", [VOXEL, (3.3, 3.2, 6.0)], ids=["s2d", "row_major"])
def test_centroids_and_embedder_match_jax(voxel):
    """The device path of the embedder: the centroid offsets and the pillar
    table against the JAX embedder called without host prep."""
    from deflow_tpu.models.embedder import DynamicEmbedder as JEmb
    from deflow_tpu.ops import voxel as jv

    hb = make_host_batch(3, 2, 600, voxel)
    jcfg = jv.VoxelConfig(voxel, tuple(RANGE))
    tcfg = tv.VoxelConfig(voxel, tuple(RANGE))
    pts, mask = hb["pc1"], hb["pc1_mask"]
    jinfo = jax.vmap(lambda q, m: jv.compute_pillar_info(q, m, jcfg))(
        jnp.asarray(pts), jnp.asarray(mask))
    _, want_cluster = jv.pillar_centroids_batched(jinfo, jcfg, None)
    info = tv.compute_pillar_info(_t(pts), _t(mask), tcfg)
    plan = tv.make_batched_scatter_plan(info.pillar_id, tcfg.num_pillars + tv.TRASH_PAD)
    cluster = tv.pillar_centroids_batched(info, plan, torch.float32)
    np.testing.assert_allclose(cluster.numpy(), np.asarray(want_cluster),
                               rtol=0, atol=1e-5)
    assert (cluster.numpy()[~info.valid.numpy()] == 0).all()

    emb = JEmb(voxel_cfg=jcfg, feat_channels=32)
    variables = randomize_variables(jax.eval_shape(lambda: emb.init(
        jax.random.key(0), jnp.asarray(pts), jnp.asarray(mask))), 4)
    img, _, _ = emb.apply(variables, jnp.asarray(pts), jnp.asarray(mask), False)
    want = np.asarray(jv.image_to_table(img, jcfg))
    port = DeFlow(voxel_size=voxel, point_cloud_range=RANGE,
                  grid_feature_size=tcfg.grid_size[:2]).eval()
    load_reference_state_dict(port.embedder, state_dict_from_flax(variables), prefix="")
    got, ginfo, _ = port.embedder.embed_points(_t(pts), _t(mask), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ginfo.valid.numpy(), np.asarray(jinfo.valid))
    assert (want == 0).any(axis=-1).any()


# ------------------------------------------------------------ eval steps
@pytest.mark.parametrize("seed", [5, 6])
def test_eval_without_host_prep_matches_jax(seed):
    """(iv) the eval step of a batch with no host prep (points in their own
    order) against the JAX eval step called without host prep."""
    voxel = VOXEL
    hb = make_host_batch(seed, 2, 512, voxel)
    jm, variables, port = model_pair(hb, seed + 1)
    want = JT.make_eval_step(jm)(variables["params"], variables["batch_stats"],
                                 {k: jnp.asarray(v) for k, v in hb.items()})
    got = TT.make_eval_step(port, device="cpu")(copy.deepcopy(hb))
    np.testing.assert_array_equal(got["pc0_valid"].numpy(), np.asarray(want["pc0_valid"]))
    for k in ("pred_flow", "net_flow", "pose_flow"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == (2, 512, 3) and np.isfinite(g).all()
        assert np.abs(g - w).max() < 2e-4, (k, np.abs(g - w).max())
    # the same model on the host-sorted batch: the same flow per point
    tb = attach_host_prep(copy.deepcopy(hb), list(voxel), RANGE)
    hosted = TT.make_eval_step(port, device="cpu")(tb)["pred_flow"].numpy()
    unsort = tb["pc0_unsort"]
    back = np.stack([hosted[i][unsort[i]] for i in range(2)])
    assert np.abs(back - got["pred_flow"].numpy()).max() < 2e-4


def test_history_eval_matches_jax():
    hb = history_batch(7)
    jm, variables, port = model_pair(hb, 8, num_frames=3)
    jb = jax_attach(copy.deepcopy(hb), list(VOXEL), RANGE, sort=True)
    tb = attach_host_prep(copy.deepcopy(hb), list(VOXEL), RANGE)
    want = JT.make_eval_step(jm)(variables["params"], variables["batch_stats"],
                                 {k: jnp.asarray(v) for k, v in jb.items()})
    got = TT.make_eval_step(port, device="cpu")(tb)
    err = np.abs(got["pred_flow"].numpy() - np.asarray(want["pred_flow"])).max()
    assert err < 2e-4, err
    # the history frame moves the flow
    tb2 = copy.deepcopy(tb)
    tb2["pch1"] = tb2["pch1"] + np.float32(0.7)
    moved = TT.make_eval_step(port, device="cpu")(tb2)["pred_flow"].numpy()
    assert np.abs(moved - got["pred_flow"].numpy()).max() > 1e-4


# ------------------------------------------------------------ train step
def test_history_train_step_matches_jax():
    """(v) the num_frames=3 deflowLoss step: loss, aux, every gradient
    (``history_fuse`` included), the parameters and the BN running
    statistics after the step (the embedder's moved three times: pc0, pc1,
    pch1)."""
    import optax

    hb = history_batch(9)
    jm, variables, port = model_pair(hb, 21, num_frames=3)
    jb = jax_attach(copy.deepcopy(hb), list(VOXEL), RANGE, sort=True)
    tb = attach_host_prep(copy.deepcopy(hb), list(VOXEL), RANGE)
    cfg = {"lr": LR, "optimizer": "adam"}
    seen = {}

    def keep(updates, state, params=None):
        seen["grads"] = updates
        return updates, state

    tx = optax.chain(optax.GradientTransformation(lambda p: optax.EmptyState(), keep),
                     JT.make_optimizer(type("C", (), {"lr": LR, "get": cfg.get})()))
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstate, jaux = JT.make_train_step(jm, "deflowLoss")(jstate, JT.device_batch(jb, None))
    state = TT.init_train_state(port, cfg, device="cpu")
    state, aux = TT.make_train_step(port, "deflowLoss", device="cpu")(state, tb)
    assert_step_matches_jax(jstate, jaux, seen["grads"], state, aux)
    assert state.model.history_fuse.weight.grad.abs().max() > 0
    # the history's BN update is the third: without the frame, the
    # statistics land elsewhere
    key = "embedder.feature_net.pfn_layers.0.1.running_mean"
    before = state_dict_from_flax(variables)[key]
    assert not torch.allclose(state.model.state_dict()[key], before)


def test_history_plumbing():
    """``history_from_batch`` collects pch1, pch2, ...; the host prep
    leaves the history keys as they are; ``device_prefetch`` and
    ``device_batch`` carry them; a num_frames=3 model without its frame
    raises."""
    hb = history_batch(11, frames=2)
    raw = copy.deepcopy(hb)
    tb = attach_host_prep(hb, list(VOXEL), RANGE)
    for k in ("pch1", "pch1_mask", "pose_pch1", "pch2", "pch2_mask", "pose_pch2"):
        assert k in TT.MODEL_KEYS and k in TT.TRAIN_KEYS and k in TT.SSL_TRAIN_KEYS
        np.testing.assert_array_equal(tb[k], raw[k])
    hist = TT.history_from_batch(tb)
    assert [sorted(h) for h in hist] == [["mask", "pc", "pose"]] * 2
    assert hist[1]["pc"] is tb["pch2"]
    assert TT.history_from_batch({"pc0": 0}) is None
    db = TT.device_batch(tb, "cpu", TT.TRAIN_KEYS)
    assert torch.equal(db["pose_pch2"], _t(raw["pose_pch2"]))
    (_, pdb), = list(TT.device_prefetch([tb], "cpu", keys=TT.TRAIN_KEYS))
    assert torch.equal(pdb["pch1"], _t(raw["pch1"]))
    model = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE, grid_feature_size=GRID,
                   num_frames=3).eval()
    with pytest.raises(ValueError, match="history"):
        model(*(_t(tb[k]) for k in ("pc0", "pc1", "pose0", "pose1", "pc0_mask",
                                    "pc1_mask")))


# ------------------------------------------------------------- entries
def test_entries_run_num_frames_3(tmp_path):
    """(vi) ``num_frames=3`` through the train entry (its loader emits
    pch1; remat; validation; checkpoints) and the eval entry reading the
    checkpoint."""
    root = str(tmp_path / "data")
    make_split(root, "train", num_scenes=1, num_frames=5, points_per_frame=900,
               labeled=True)
    make_split(root, "val", num_scenes=1, num_frames=4, points_per_frame=900,
               labeled=True, seed=7)
    over = ["dataset_path=" + root, "batch_size=2", "epochs=1", "num_workers=0",
            "max_points=1024", "voxel_size=[3.2, 3.2, 6]",
            "model.target.grid_feature_size=[32, 32]", "model.target.num_iters=2",
            "precision=fp32", "num_frames=3", "device=cpu",
            f"output_dir={tmp_path / 'run'}"]
    seen = []
    orig = TT.history_from_batch

    def spy(batch):
        hist = orig(batch)
        seen.append(None if hist is None else len(hist))
        return hist

    TT.history_from_batch = spy
    try:
        metrics = TE.main(compose("config", over))
    finally:
        TT.history_from_batch = orig
    assert np.isfinite(metrics["EPE_3way_mean"])
    assert seen and set(seen) == {1}
    ckpt = str(tmp_path / "run" / "wandb" / "deflow-local" / "checkpoints" / "epoch_0.ckpt")
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    assert sd["model.history_fuse.weight"].shape == (32, 64)
    ev = evaluate.main(compose("config", over + [f"checkpoint={ckpt}"]))
    assert ev["EPE_3way_mean"] == pytest.approx(metrics["EPE_3way_mean"], rel=1e-6)
