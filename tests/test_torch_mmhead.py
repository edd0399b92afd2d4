"""The port's MMHead transformer decoder (``decoder_option=mmhead``) against
the JAX package's ``MMHeadDecoder`` and the torch twin's ``_MMHead``, on the
CPU in f32.

Clouds are ragged: out-of-range and padding points sit between the valid
ones, the valid count of every sample is not a multiple of the 512-point
chunk, and every sample ends in at least one chunk whose keys are all
masked (the chunks past its valid count).

Tolerances, each with its reason:
- the whole eval step against ``DeFlow(decoder_option="mmhead")``:
  ``pred_flow`` within 2e-4 (the bound ``tests/test_parity.py`` holds the
  twin to, and ``tests/test_torch_slice.py`` the GRU model).  The port's
  LayerNorms take the reference's eps 1e-5, the JAX package flax's 1e-6;
  the test also measures that difference alone (the port at 1e-6 against
  the port at 1e-5) and holds it below 2e-4;
- the device path against the twin (``tests/torch_twin.py``, the reference
  layout, eps 1e-5): flow within 1e-4 (the centroids are summed in another
  order);
- the head alone in train mode with dropout 0 and eps 1e-6 against JAX's
  deterministic head, both in float64: output 1e-9, every gradient within
  1e-6 of its largest element (the JAX gradients reach the port's names
  through the converter in f32).  In f32 the gradients of four post-norm
  layers with ReLU are poorly conditioned: each side's f32 gradients are
  2–4e-4 of their largest element from a float64 run in the first layers,
  and a ReLU input that rounds to the other side of 0 moves single
  elements by percent (measured);
- dropout: the share of zeros within 0.01 of the rate at 10^6 draws (five
  standard deviations are 0.0015), the same masks for the same (seed,
  step), different ones for another step, none in eval;
- the remat step against the plain step, and the converter's round
  trips: bit for bit.
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
from deflow_tpu_torch.models import decoder as TD
from deflow_tpu_torch.models.deflow import DeFlow, build_model
from deflow_tpu_torch.ops import voxel as tv

from test_torch_host_prep import RANGE
from test_torch_modules import GRID, VOXEL, randomize_variables
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

N = 1536
CHUNK = 512


def ragged_batch(seed, b=2, n=N, keep=0.55):
    """Host batch whose valid points are interleaved with out-of-range and
    padding slots; about ``keep`` of the slots are valid."""
    rng = np.random.default_rng(seed)

    def cloud():
        pts = np.stack([rng.uniform(-50, 50, (b, n)), rng.uniform(-50, 50, (b, n)),
                        rng.uniform(-2.5, 2.5, (b, n))], -1).astype(np.float32)
        far = rng.random((b, n)) < 0.3
        pts[far, 0] += 500.0
        return pts

    pose0 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose1 = pose0.copy()
    pose1[:, :3, 3] = rng.uniform(-1, 1, (b, 3))
    return {"pc0": cloud(), "pc1": cloud(), "pose0": pose0, "pose1": pose1,
            "pc0_mask": rng.random((b, n)) < keep / 0.7,
            "pc1_mask": rng.random((b, n)) < keep / 0.7,
            "flow": rng.normal(0, 0.5, (b, n, 3)).astype(np.float32),
            "flow_is_valid": rng.random((b, n)) < 0.95,
            "flow_category_indices": rng.integers(0, 30, (b, n)).astype(np.int32)}


def assert_ragged(valid):
    """Every sample: a valid count that is not a multiple of the chunk, and
    a last chunk with no valid key."""
    counts = np.asarray(valid).sum(axis=1)
    assert (counts % CHUNK != 0).all() and (counts > CHUNK).all(), counts
    assert (counts <= valid.shape[1] - CHUNK).all(), counts


def mmhead_pair(hb, seed=3, num_frames=2):
    jm = JaxDeFlow(voxel_size=VOXEL, point_cloud_range=tuple(RANGE),
                   grid_feature_size=GRID, decoder_option="mmhead",
                   num_frames=num_frames)
    args = [jnp.asarray(hb[k]) for k in
            ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask")]
    hist = JT.history_from_batch({k: jnp.asarray(v) for k, v in hb.items()
                                  if k.startswith(("pch", "pose_pch"))})
    variables = randomize_variables(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), *args, history=hist)), seed)
    port = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE, grid_feature_size=GRID,
                  decoder_option="mmhead", num_frames=num_frames).eval()
    load_reference_state_dict(port, state_dict_from_flax(variables))
    return jm, variables, port


def _jax_eval(jm, variables, batch):
    return JT.make_eval_step(jm)(variables["params"], variables["batch_stats"],
                                 {k: jnp.asarray(v) for k, v in batch.items()})


def test_mmhead_eval_matches_jax():
    """(i) the host-sorted eval step, both sides on the same sorted batch
    (so the same chunks), and the LayerNorm eps alone."""
    hb = ragged_batch(1)
    jm, variables, port = mmhead_pair(hb)
    jb = jax_attach(copy.deepcopy(hb), list(VOXEL), RANGE, sort=True)
    tb = attach_host_prep(copy.deepcopy(hb), list(VOXEL), RANGE)
    want = _jax_eval(jm, variables, jb)
    got = TT.make_eval_step(port, device="cpu")(tb)
    valid = got["pc0_valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["pc0_valid"]))
    assert_ragged(valid)
    g, w = got["pred_flow"].numpy(), np.asarray(want["pred_flow"])
    assert g.shape == (2, N, 3) and np.isfinite(g).all()
    assert np.abs(g - w).max() < 2e-4, np.abs(g - w).max()
    assert np.abs(got["net_flow"].numpy()[valid]).max() > 1e-2   # not a zero head

    # the eps alone: the port with flax's 1e-6
    for layer in port.head.pts_off_transformer.layers:
        for norm in (layer.norm1, layer.norm2, layer.norm3):
            norm.eps = 1e-6
    got6 = TT.make_eval_step(port, device="cpu")(tb)["pred_flow"].numpy()
    assert np.abs(got6 - w).max() < 2e-5, np.abs(got6 - w).max()
    assert np.abs(got6 - g).max() < 2e-4


def test_mmhead_device_path_matches_jax_and_twin():
    """(i) the eval step without host prep: the points keep their own
    order, so the port, the JAX package (no host prep either) and the
    torch twin (one compacted sample) chunk the same points together."""
    from torch_twin import TorchDeFlow, randomize_

    hb = ragged_batch(2, b=1, n=2048)
    hb["pc0_mask"][:] = True          # the twin takes whole clouds
    hb["pc1_mask"][:] = True
    hb["pose1"] = hb["pose0"].copy()  # and bins the same compensated points
    twin = TorchDeFlow(decoder_option="mmhead", voxel_size=VOXEL,
                       point_cloud_range=tuple(RANGE))
    randomize_(twin, 9)
    port = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE, grid_feature_size=GRID,
                  decoder_option="mmhead").eval()
    load_reference_state_dict(port, twin.state_dict(), prefix="")
    got = TT.make_eval_step(port, device="cpu")(hb)
    t = lambda k: torch.from_numpy(hb[k][0])
    ref = twin(t("pc0"), t("pc1"), t("pose0"), t("pose1"))
    valid = got["pc0_valid"].numpy()[0]
    np.testing.assert_array_equal(valid, ref["valid0"].numpy())
    assert_ragged(valid[None])
    err = np.abs(got["net_flow"].numpy()[0][valid] - ref["flow"].numpy()).max()
    assert err < 1e-4, err

    jm, variables, port = mmhead_pair(ragged_batch(2))
    hb = ragged_batch(2)
    want = _jax_eval(jm, variables, hb)
    got = TT.make_eval_step(port, device="cpu")(hb)
    assert_ragged(got["pc0_valid"].numpy())
    err = np.abs(got["pred_flow"].numpy() - np.asarray(want["pred_flow"])).max()
    assert err < 2e-4, err


def _head_inputs(seed, b=2, n=N):
    """Random [before | after] tables and a ragged cloud's PillarInfo and
    plan (the points in their own order)."""
    hb = ragged_batch(seed, b, n)
    cfg = tv.VoxelConfig(VOXEL, tuple(RANGE))
    info = tv.compute_pillar_info(torch.from_numpy(hb["pc0"]),
                                  torch.from_numpy(hb["pc0_mask"]), cfg)
    plan = tv.make_batched_scatter_plan(info.pillar_id, cfg.num_pillars + tv.TRASH_PAD)
    rng = np.random.default_rng(seed)
    tabs = [rng.normal(size=(b, cfg.num_pillars, 64)).astype(np.float32)
            for _ in range(2)]
    return info, plan, tabs


def test_mmhead_train_gradients_match_jax():
    """(ii) the head alone in train mode with dropout 0 (and flax's eps)
    against JAX's deterministic head, both in float64: output and every
    gradient (the parameters', and the tables' through the planned
    gather's backward); no NaN from the all-masked chunks."""
    from deflow_tpu.models.decoder import MMHeadDecoder as JHead
    from deflow_tpu.ops import voxel as jv

    f64 = torch.float64
    info, plan, tabs = _head_inputs(4, b=1)
    assert_ragged(info.valid.numpy())
    wout = np.random.default_rng(7).normal(size=(1, N, 3))
    with jax.enable_x64(True):
        jinfo = jv.PillarInfo(*(jnp.asarray(x.numpy()) for x in info))
        jinfo = jinfo._replace(offsets=jinfo.offsets.astype(jnp.float64),
                               points=jinfo.points.astype(jnp.float64))
        head = JHead(dtype=jnp.float64)
        variables = randomize_variables(jax.eval_shape(lambda: head.init(
            jax.random.key(0), *(jnp.asarray(t) for t in tabs), jinfo)), 6)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables["params"])

        def jloss(params, t0, t1):
            out = head.apply({"params": params}, t0, t1, jinfo, train=False)
            return jnp.sum(out * wout), out

        (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            params, *(jnp.asarray(t, jnp.float64) for t in tabs))
        jout = np.asarray(jout)
        jgrads = jax.tree.map(lambda a: np.asarray(a, np.float64), jgrads)

    port = TD.MMHeadDecoder(dropout=0.0).train()
    for layer in port.pts_off_transformer.layers:
        for norm in (layer.norm1, layer.norm2, layer.norm3):
            norm.eps = 1e-6
    load_reference_state_dict(port, state_dict_from_flax(variables), prefix="")
    port.to(f64)
    # the gather runs in f32 (its tables' dtype), exactly; the head in f64
    t0, t1 = (torch.from_numpy(t).requires_grad_() for t in tabs)
    info64 = info._replace(offsets=info.offsets.to(f64), points=info.points.to(f64))
    out = port(t0, t1, info64, f64, plan=plan)
    (out * torch.from_numpy(wout)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0, atol=1e-9)
    # the JAX gradients pass the converter in f32: 1e-6 of their largest
    want = state_dict_from_flax({"params": jgrads[0]})
    named = dict(port.named_parameters())
    assert set(want) == set(named)
    for key, w in list(want.items()) + [("t0", jgrads[1]), ("t1", jgrads[2])]:
        g = (named[key].grad if key in named else {"t0": t0, "t1": t1}[key].grad).numpy()
        w = np.asarray(w)
        assert np.isfinite(g).all(), key
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=key)
    assert np.abs(want["pts_off_transformer.layers.0.self_attn.in_proj_weight"]
                  .numpy()).max() > 0


def test_dropout_masks():
    """(iii) about 10% zeros, the kept values scaled by 1/0.9; the same
    masks for the same (seed, step), other ones for another step; the
    train-mode head draws from the generator, the eval-mode head ignores
    it."""
    x = torch.ones(1000, 1000)
    a = TD._dropout(x, 0.1, TD.dropout_generator(3, "cpu"))
    assert abs((a == 0).float().mean().item() - 0.1) < 0.01
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))
    assert torch.equal(a, TD._dropout(x, 0.1, TD.dropout_generator(3, "cpu")))
    assert not torch.equal(a, TD._dropout(x, 0.1, TD.dropout_generator(4, "cpu")))
    assert TD._dropout(x, 0.1, None) is x
    # the attention weights' mask is one [L, L] for every chunk and head
    w = TD._dropout(torch.ones(3, 4, 8, 8), 0.5, TD.dropout_generator(0, "cpu"),
                    shape=(8, 8))
    assert (w == w[:1, :1]).all() and (w == 0).any()

    info, plan, tabs = _head_inputs(5, b=1, n=1024)
    head = TD.MMHeadDecoder()
    t0, t1 = (torch.from_numpy(t) for t in tabs)
    run = lambda step: head(t0, t1, info, torch.float32, plan=plan,
                            dropout=None if step is None
                            else TD.dropout_generator(step, "cpu"))
    head.eval()
    ev = run(None)
    assert torch.equal(ev, run(1))                     # none in eval
    head.train()
    tr = run(1)
    assert torch.equal(tr, run(1)) and not torch.equal(tr, run(2))
    assert not torch.allclose(tr, ev) and torch.isfinite(tr).all()
    with pytest.raises(ValueError, match="generator"):
        run(None)


def test_mmhead_remat_step_equals_plain_with_dropout():
    """The MMHead train step with remat draws the same dropout masks in
    its recompute: the plain step bit for bit (loss, gradients,
    parameters)."""
    hb = attach_host_prep(ragged_batch(6, n=1024), list(VOXEL), RANGE)
    model_cfg = {"voxel_size": list(VOXEL), "point_cloud_range": RANGE,
                 "decoder_option": "mmhead"}
    results = []
    for remat in (False, True):
        model = build_model(model_cfg, precision="fp32", device="cpu", seed=8)
        state = TT.init_train_state(model, {"lr": 2e-4}, device="cpu")
        step = TT.make_train_step(model, "deflowLoss", device="cpu", remat=remat)
        state, aux = step(state, hb)
        results.append((aux, {k: p.grad.clone() for k, p in model.named_parameters()},
                        {k: v.clone() for k, v in model.state_dict().items()}))
    (a0, g0, s0), (a1, g1, s1) = results
    assert torch.equal(a0["loss"], a1["loss"]) and torch.isfinite(a0["loss"])
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
        assert torch.isfinite(g0[k]).all(), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def _entry_overrides(root, out, **kw):
    over = {"dataset_path": root, "batch_size": 2, "epochs": 1, "num_workers": 0,
            "max_points": 1024, "voxel_size": "[3.2, 3.2, 6]",
            "model.target.grid_feature_size": "[32, 32]",
            "model.target.decoder_option": "mmhead", "precision": "fp32",
            "output_dir": out, "device": "cpu"}
    over.update(kw)
    return [f"{k}={v}" for k, v in over.items()]


def test_entries_run_the_mmhead(tmp_path):
    """(vi) ``decoder_option=mmhead`` through the train entry (one epoch,
    remat, validation, checkpoints) and the eval entry reading its
    checkpoint."""
    root = str(tmp_path / "data")
    make_split(root, "train", num_scenes=1, num_frames=4, points_per_frame=900,
               labeled=True)
    make_split(root, "val", num_scenes=1, num_frames=3, points_per_frame=900,
               labeled=True, seed=7)
    out = str(tmp_path / "run")
    cfg = compose("config", _entry_overrides(root, out))
    metrics = TE.main(cfg)
    assert np.isfinite(metrics["EPE_3way_mean"])
    ckpt = f"{out}/wandb/deflow-local/checkpoints/epoch_0.ckpt"
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    assert "model.head.pts_off_transformer.layers.3.multihead_attn.in_proj_weight" in sd
    ev = evaluate.main(compose("config", _entry_overrides(root, out, checkpoint=ckpt)))
    assert ev["EPE_3way_mean"] == pytest.approx(metrics["EPE_3way_mean"], rel=1e-6)


@pytest.mark.parametrize("num_frames", [2, 3])
def test_converter_round_trips(num_frames):
    """(vii) JAX variables of the MMHead model (and of a num_frames=3 one:
    ``history_fuse``) → ``deflow_tpu.convert.export_state_dict`` → the
    port (strict) equals ``state_dict_from_flax`` of the same variables bit
    for bit, and the port's state dict → ``convert_state_dict`` → the JAX
    variables again, bit for bit."""
    from deflow_tpu.convert import (convert_state_dict, export_state_dict,
                                    merge_into_variables)

    hb = ragged_batch(11, n=600)
    if num_frames == 3:
        hb.update(pch1=hb["pc1"].copy(), pch1_mask=hb["pc1_mask"].copy(),
                  pose_pch1=hb["pose0"].copy())
    jm, variables, port = mmhead_pair(hb, seed=13, num_frames=num_frames)
    direct = state_dict_from_flax(variables)
    exported = export_state_dict(variables)
    fresh = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE, grid_feature_size=GRID,
                   decoder_option="mmhead", num_frames=num_frames)
    load_reference_state_dict(fresh, exported)
    got = fresh.state_dict()
    assert set(got) == set(direct) == {k[len("model."):] for k in exported}
    for k, v in direct.items():
        assert torch.equal(got[k], v), k
    assert ("history_fuse.weight" in got) == (num_frames == 3)
    params, stats = convert_state_dict({f"model.{k}": v for k, v in got.items()})
    back = merge_into_variables(jax.tree.map(np.asarray, variables),
                                {"params": params, "batch_stats": stats})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(variables),
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
