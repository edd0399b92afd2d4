"""The port's data parallelism (``deflow_tpu_torch/dist.py``) on two gloo
CPU ranks, against the single-process port at the same global batch and
against the JAX package's step on a 2-device ``data`` mesh.

The model is the f32 DeFlow at a 32² grid (``tests/torch_dist_ranks.py``:
2 GRU iterations, 1,024 slots a sample), with random weights carried from
the JAX package through ``convert.py``.  The two ranks' shards differ in
their valid counts (95% against 40%), their deflow speed buckets (slow
points on rank 0 only, fast on rank 1 only, mid in unlike counts on
both) and their DUFO-dynamic shares, so every global denominator (the
bucket means, the BN statistics, the SeFlow sample mean) differs from a
per-rank one.  Two rows a rank run the U-Net's fused chains (2B = 4),
three rows its plain path (2B = 6); the one process runs the plain path
at 2B = 8, so the chain's global BN is held to the plain path's.

Tolerances against the single-process port, each with its reason (the two
runs differ only in the order of their sums):
- loss and grad_norm: 1e-6 relative;
- each parameter's gradient after the first step: 2e-5 of its largest
  element.  The encoder's gradients (1e-7 to 1e-5 here) come out of the BN
  backward's cancellations: the two runs, which differ only in the order
  of their sums, differed by up to 0.97e-5 of their largest (an 8-core
  Intel Xeon); a missing all-reduce moves them by percent.  The conv
  biases before a train-mode BN, whose gradient is zero in exact
  arithmetic: both sides below 2e-5 of the largest gradient of the same
  conv's weight;
- the BN running statistics after three steps: 1e-6 of each buffer's
  largest element, or 1e-6 where that is below 1;
- the parameters after three Adam steps: 1e-5, those biases 2·lr (Adam
  maps their rounding noise anywhere in [−lr, lr] a step);
- the two ranks' parameters and buffers: bit for bit after every step.
Against the JAX mesh step (one step): loss 1e-5 relative, gradients 1e-4
of each parameter's largest element (the biases as above, at 1e-4), as
``test_torch_train_step.py`` holds the single-device steps; the DP eval's
``pred_flow`` within 2e-4 m of JAX's ``jit_eval_step`` on the mesh.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from deflow_tpu import trainer as JT
from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu.models import DeFlow as JaxDeFlow
from deflow_tpu_torch import dist
from deflow_tpu_torch.convert import state_dict_from_flax

import torch_dist_ranks as R
from test_torch_modules import randomize_variables
from test_torch_ssl_kernels import interpret_pallas  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

STEPS = 3
# name: (loss, rows a rank, keyword arguments of train_steps)
CASES = {
    "deflow_chain": ("deflowLoss", 2, {}),
    "deflow_chain_remat": ("deflowLoss", 2, {"remat": True}),
    "deflow_plain": ("deflowLoss", 3, {}),
    "ff3d_chain": ("ff3dLoss", 2, {}),
    "seflow_grid": ("seflowLoss", 2, {"grid_pairs": 0}),
    "seflow_brute": ("seflowLoss", 2, {}),
}


# the MMHead with its dropout on (rate 0.1): two steps
MMHEAD = {"decoder_option": "mmhead"}


def _zero_grad_bias(key):
    return key.startswith("backbone.encoder_step_") and key.endswith("conv.bias")


@pytest.fixture(scope="module")
def weights():
    """Random JAX variables of the f32 DeFlow at the tests' grid, and the
    same weights in the port's (the reference) layout."""
    hb = R.shard_batch(0, 2)
    jm = JaxDeFlow(voxel_size=R.VOXEL, point_cloud_range=tuple(R.RANGE),
                   grid_feature_size=R.GRID, num_iters=2, dtype=jnp.float32)
    args = [jnp.asarray(hb[k]) for k in
            ("pc0", "pc1", "pose0", "pose1", "pc0_mask", "pc1_mask")]
    variables = randomize_variables(
        jax.eval_shape(lambda: jm.init(jax.random.key(0), *args)), 5)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
    return jm, variables, sd


def _batches(loss, rows):
    ssl = loss == "seflowLoss"
    return [R.shard_batch(100 * rows + 10 * ssl + i, rows, ssl=ssl)
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def mmhead_weights():
    """Seeded weights of the f32 MMHead DeFlow at the tests' grid."""
    from deflow_tpu_torch.models import build_model

    model = build_model({"voxel_size": R.VOXEL, "point_cloud_range": R.RANGE,
                         "grid_feature_size": R.GRID, "num_iters": 2, **MMHEAD},
                        device="cpu", seed=3)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _mmhead_case(sd):
    return {"sd": sd, "batches": _batches("deflowLoss", 2)[:2],
            "loss_name": "deflowLoss", "model_kw": MMHEAD}


@pytest.fixture(scope="module")
def two_ranks(weights, mmhead_weights):
    """Every case on two gloo CPU ranks, in one spawn."""
    cases = [(name, {"batches": _batches(loss, rows), "loss_name": loss, **kw})
             for name, (loss, rows, kw) in CASES.items()]
    cases.append(("mmhead", _mmhead_case(mmhead_weights)))
    return dist.run_ranks(R.train_cases, 2, "gloo", "cpu",
                          args=(weights[2], cases), timeout=900)


def test_shards_differ_in_counts_and_buckets():
    hb = R.shard_batch(200, 2)
    target = np.linalg.norm(hb["flow"] - (hb["pose0"][:, None, :3, 3]
                                          - hb["pose1"][:, None, :3, 3]), axis=-1)
    speed = target / 0.1
    valid = hb["pc0_mask"] & hb["flow_is_valid"]
    counts = valid.sum(1)
    assert counts[:2].min() > 2 * counts[2:].max()
    slow, fast = valid & (speed < 0.4), valid & (speed > 1.0)
    mid = valid & ~slow & ~fast
    assert slow[:2].any(1).all() and not slow[2:].any()
    assert not fast[:2].any() and fast[2:].any(1).all()
    assert mid[:2].sum() > 1.3 * mid[2:].sum() > 0


def test_num_devices_must_equal_the_ranks():
    from deflow_tpu_torch.config import check_num_devices

    for n, world in ((-1, 1), (-1, 8), (0, 2), (2, 2), (1, 1)):
        check_num_devices({"num_devices": n}, world)
    with pytest.raises(ValueError, match="num_devices=2, but the launcher started 1"):
        check_num_devices({"num_devices": 2}, 1)


def test_loader_ranks_hold_the_single_process_rows():
    """Every rank draws the same shuffle and takes its rows of each global
    batch; a ragged last eval batch is padded to a multiple of the ranks
    with its last sample, and each rank's batch carries the true size."""
    from deflow_tpu_torch.data.h5dataset import DataLoader

    ds = [{"pc0": np.full((3, 3), i, np.float32), "scene_id": f"s{i}",
           "timestamp": str(i)} for i in range(11)]
    for kw, sizes in (({"shuffle": True, "seed": 3}, [4, 4]),
                      ({"shuffle": False, "drop_last": False}, [4, 4, 3])):
        one = list(DataLoader(ds, 4, prefetch=0, **kw))
        ranks = [list(DataLoader(ds, 4, prefetch=0, rank=r, world=2, **kw))
                 for r in range(2)]
        assert [len(b["scene_id"]) for b in one] == sizes
        for k, want in enumerate(one):
            got = [ranks[r][k] for r in range(2)]
            rows = want["scene_id"] + want["scene_id"][-1:] * (len(want["scene_id"]) % 2)
            assert got[0]["scene_id"] + got[1]["scene_id"] == rows
            assert all(g["global_size"] == len(want["scene_id"]) for g in got)
            np.testing.assert_array_equal(
                np.concatenate([g["pc0"] for g in got])[:len(want["pc0"])], want["pc0"])
    with pytest.raises(ValueError, match="must divide evenly over 2 ranks"):
        DataLoader(ds, 3, shuffle=True, rank=0, world=2)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_process(weights, two_ranks, case):
    loss, rows, kw = CASES[case]
    want = R.train_steps(weights[2], _batches(loss, rows), loss, **kw)
    got = two_ranks[0][case]
    # the ranks took the same steps, bit for bit
    assert got["digests"] == two_ranks[1][case]["digests"]
    assert len(set(got["digests"])) == STEPS
    for a, w in zip(got["aux"], want["aux"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], w[k], rtol=1e-6, err_msg=k)
        assert a["valid_points"] == w["valid_points"]
        np.testing.assert_allclose(a["epe"], w["epe"], rtol=1e-6)
    for key, w in want["grads"].items():
        g = got["grads"][key]
        if _zero_grad_bias(key):
            scale = np.abs(want["grads"][key[:-4] + "weight"]).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= 2e-5 * scale, key
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                       err_msg=key)
    for key, w in want["state"].items():
        g = got["state"][key]
        if "num_batches" in key:
            assert g == w, key
        elif "running" in key:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * max(1, np.abs(w).max()),
                                       err_msg=key)
        else:
            tol = 2 * R.LR if _zero_grad_bias(key) else 1e-5
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=key)


def test_two_ranks_draw_the_single_process_dropout(mmhead_weights, two_ranks):
    """The MMHead's dropout over two ranks: each rank draws the global
    batch's masks and keeps its rows, so the steps are the single-process
    steps: loss, grad_norm and epe within 1e-4 relative (measured 1e-7 at
    the first step, 1.5e-6 at the second, after Adam carried the MMHead's
    poorly conditioned f32 gradients; a rank drawing masks of its own shape
    differed by 2e-3 to 1.6e-2).  Its gradients are not held element by
    element: in f32 its four post-norm layers with ReLU move single
    elements by percent between two summation orders."""
    want = R.train_steps(**_mmhead_case(mmhead_weights))
    got = two_ranks[0]["mmhead"]
    assert got["digests"] == two_ranks[1]["mmhead"]["digests"]
    for a, w in zip(got["aux"], want["aux"]):
        for k in ("loss", "grad_norm", "epe"):
            np.testing.assert_allclose(a[k], w[k], rtol=1e-4, err_msg=k)


# ------------------------------------------------- against the JAX mesh
def _grads_kept():
    """An optax transform whose state is the last gradients it saw."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


@pytest.mark.parametrize("case", ["deflow_chain", "seflow_grid"])
def test_two_ranks_equal_jax_mesh_step(weights, two_ranks, request, case):
    jm, variables, _ = weights
    loss, rows, kw = CASES[case]
    if "grid_pairs" in kw:
        # the JAX chamfer's Pallas sweep (interpret mode) inside its shard_map
        JC = request.getfixturevalue("interpret_pallas")
        request.getfixturevalue("monkeypatch").setattr(
            JC, "_AUTO_GRID_PAIRS", kw["grid_pairs"])
    mesh = JT.create_mesh(2)
    tx = optax.chain(_grads_kept(), optax.adam(R.LR))
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstate = jax.device_put(jstate, JT.replicated(mesh))
    step = JT.jit_train_step(JT.make_train_step(jm, loss, mesh=mesh), mesh)
    jb = jax_attach(copy.deepcopy(_batches(loss, rows)[0]), list(R.VOXEL), R.RANGE,
                    sort=True)
    jstate, jaux = step(jstate, JT.device_batch(jb, mesh))

    got = two_ranks[0][case]
    np.testing.assert_allclose(got["aux"][0]["loss"], float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["aux"][0]["grad_norm"], float(jaux["grad_norm"]),
                               rtol=1e-5)
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])}).items()}
    assert set(want) == set(got["grads"])
    for key, w in want.items():
        g = got["grads"][key]
        if _zero_grad_bias(key):
            scale = np.abs(want[key[:-4] + "weight"]).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-4 * scale, key
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=key)


def test_two_rank_eval_equals_jax_mesh_eval(weights):
    jm, variables, sd = weights
    hb = R.shard_batch(7, 2)
    got = dist.run_ranks(R.eval_rows, 2, "gloo", "cpu", args=(sd, hb))
    np.testing.assert_array_equal(got[0], got[1])
    mesh = JT.create_mesh(2)
    params, stats = jax.device_put((variables["params"], variables["batch_stats"]),
                                   JT.replicated(mesh))
    jb = jax_attach(copy.deepcopy(hb), list(R.VOXEL), R.RANGE, sort=True)
    want = JT.jit_eval_step(JT.make_eval_step(jm), mesh)(
        params, stats, JT.device_batch(jb, mesh))["pred_flow"]
    assert got[0].shape == (4, 1024, 3)
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=0, atol=2e-4)
