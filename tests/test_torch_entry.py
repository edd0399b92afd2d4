"""The port's eval entry against the JAX package's, on the CPU in f32.

A synthetic val split (1 scene, 4 frames, 2,048 points; eval masks) and a
test split, a 32² grid (voxel 3.2 m), ``num_iters=2``, random weights in the
JAX variable tree carried to the port through the reference state dict.

- ``BucketedEPE`` matches the JAX one at 1e-6 relative.
- ``run_validation`` (the reference's form: ``DataLoader`` with the C++
  host prep, ``device_prefetch``, both metrics) against the JAX
  ``run_validation``: every ``pred_flow`` and ``pose_flow`` within 2e-4 (the
  eval path's bound, ``test_torch_slice.py``), and that bound carried to
  the metrics: a mean of per-point EPEs within √3·2e-4, a normalized one
  within √3·2e-4 / (0.4 m/s · 0.1 s) (the slowest dynamic bucket), the
  angle within √3·2e-4 rad, the accuracies equal (the outputs here differ
  by ~1e-6, and no point lies that close to a threshold); the JAX outputs
  through the port's loader and accumulators within 1e-6 relative.
- ``write_submission`` (v1 and v2): the JAX writer's entry names; each
  frame within 2e-4 plus one float16 ulp, its schema and row selection
  from ``tests/golden/submission_schema.json``.
- ``load_weights`` of a ``.pth`` written by the JAX package's
  ``save_torch_checkpoint`` reproduces the JAX ``pred_flow`` (2e-4).
- ``save.main`` writes ``res_name`` into the scenes, in dataset order.
"""

import json
import os
import re
import shutil
import zipfile
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu import trainer as T
from deflow_tpu.config import compose as jax_compose
from deflow_tpu.convert import save_torch_checkpoint
from deflow_tpu.data import HDF5Dataset as JaxHDF5Dataset
from deflow_tpu.entry.evaluate import run_validation as jax_run_validation
from deflow_tpu.entry.evaluate import write_submission as jax_write_submission
from deflow_tpu.metrics import BucketedEPE as JaxBucketedEPE
from deflow_tpu.metrics import ThreewayEPE as JaxThreewayEPE
from deflow_tpu.models import build_model as jax_build_model
from deflow_tpu_torch.config import compose
from deflow_tpu_torch.convert import (load_reference_state_dict, load_weights,
                                      state_dict_from_flax)
from deflow_tpu_torch.data.h5dataset import DataLoader, HDF5Dataset
from deflow_tpu_torch.data.synthetic import make_split
from deflow_tpu_torch.entry import evaluate, save
from deflow_tpu_torch.metrics import BucketedEPE, ThreewayEPE
from deflow_tpu_torch.models import build_model
from deflow_tpu_torch.trainer import make_eval_step

from test_torch_modules import randomize_variables
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

TOL = 2e-4
GOLDEN = json.loads((Path(__file__).parent / "golden" /
                     "submission_schema.json").read_text())


def _overrides(root):
    return [f"dataset_path={root}", "batch_size=2", "num_workers=2",
            "max_points=2048", "voxel_size=[3.2, 3.2, 6]",
            "model.target.grid_feature_size=[32, 32]",
            "model.target.num_iters=2", "precision=fp32"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("av2")
    make_split(str(root), "val", num_scenes=1, num_frames=4, points_per_frame=2048,
               labeled=True, with_eval_mask=True, seed=11)
    make_split(str(root), "test", num_scenes=1, num_frames=3, points_per_frame=1500,
               labeled=False, with_eval_mask=True, seed=12)
    jcfg = jax_compose("config", _overrides(root))
    cfg = compose("config", _overrides(root) + ["device=cpu"])
    jm = jax_build_model(jcfg.model, precision="fp32")
    z = jnp.zeros((1, 64, 3))
    m = jnp.ones((1, 64), bool)
    eye = jnp.eye(4)[None]
    variables = randomize_variables(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), z, z, eye, eye, m, m)), seed=5)
    port = build_model(cfg["model"], precision="fp32", device="cpu")
    load_reference_state_dict(port, state_dict_from_flax(variables))
    state = SimpleNamespace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    return SimpleNamespace(root=root, jcfg=jcfg, cfg=cfg, jm=jm,
                           variables=variables, state=state, port=port,
                           jax_step=jax.jit(T.make_eval_step(jm)),
                           step=make_eval_step(port, device="cpu"))


def _recording(step, outs):
    def run(*args):
        out = step(*args)
        outs.append({k: np.asarray(out[k]) for k in ("pred_flow", "pose_flow")})
        return out
    return run


def test_bucketed_epe_matches_jax():
    rng = np.random.default_rng(0)
    got, want = BucketedEPE(), JaxBucketedEPE()
    for _ in range(3):
        n = 3000
        ego = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
        moving = rng.normal(0, np.where(rng.random((n, 1)) < 0.5, 0.01, 0.6),
                            (n, 3))                  # static and dynamic points
        gt = (ego + moving).astype(np.float32)
        pred = gt + rng.normal(0, 0.1, (n, 3)).astype(np.float32)
        cls = rng.integers(0, 30, n)
        mask = rng.random(n) < 0.9
        for acc in (got, want):
            acc.update(pred, gt, cls, ego, mask)
    g, w = got.compute(), want.compute()
    assert g.keys() == w.keys() and len(g) == 12
    np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=1e-6)
    np.testing.assert_array_equal(got.count, want.count)
    assert got.table() == want.table()


def _metric_tol(key):
    """The pred_flow bound carried to a metric (see the module docstring)."""
    if key.startswith("Dynamic_NormEPE"):
        return np.sqrt(3) * TOL / (0.4 * 0.1)
    if key.startswith("Acc"):
        return 0.0
    return np.sqrt(3) * TOL


def test_run_validation_matches_jax(env):
    jouts, outs = [], []
    ds = HDF5Dataset(str(env.cfg["val_data"]), max_points=2048)
    jds = JaxHDF5Dataset(str(env.jcfg.val_data), max_points=2048)
    want = jax_run_validation(_recording(env.jax_step, jouts), env.state, jds,
                              env.jcfg, None)
    three, bucketed = ThreewayEPE(), BucketedEPE()
    got = evaluate.run_validation(_recording(env.step, outs), ds, env.cfg, "cpu",
                                  three=three, bucketed=bucketed)
    assert len(outs) == len(jouts) == 2                  # 3 pairs, batches of 2
    for o, j in zip(outs, jouts):
        for k in o:
            assert o[k].shape == j[k].shape and np.isfinite(o[k]).all()
            err = np.abs(o[k] - j[k]).max()
            assert err < TOL, f"{k}: max |Δ| = {err}"
    assert got.keys() == want.keys()
    assert {"EPE_3way_mean", "Static_EPE_mean", "Dynamic_NormEPE_mean"} <= set(got)
    for k in want:
        if np.isnan(want[k]):                        # an empty bucket
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= _metric_tol(k), (k, got[k], want[k])
    # the JAX outputs through the port's loader and accumulators
    loader = DataLoader(ds, 2, post_collate=evaluate._sorted_prep(env.cfg))
    replay = iter(jouts)
    same = evaluate.run_validation(
        lambda b: {k: torch.tensor(v) for k, v in next(replay).items()}, loader)
    np.testing.assert_allclose([same[k] for k in want], [want[k] for k in want],
                               rtol=1e-6, equal_nan=True)
    ds.close()
    jds.close()


@pytest.mark.parametrize("version", [1, 2])
def test_write_submission_matches_jax(env, tmp_path, version):
    test_dir = os.path.join(env.root, "test")
    ds = HDF5Dataset(test_dir, max_points=1024, with_labels=False,
                     submission_meta=True)
    jds = JaxHDF5Dataset(test_dir, max_points=1024, with_labels=False,
                         submission_meta=True)
    cfg = env.cfg.copy()
    cfg["max_points"] = 1024               # a crop: unseen points take pose flow
    got = evaluate.write_submission(env.step, ds, cfg, str(tmp_path / "port"),
                                    version=version, device="cpu")
    want = jax_write_submission(env.jax_step, env.state, jds, env.jcfg, None,
                                str(tmp_path / "jax"), version=version)
    spec = GOLDEN[f"v{version}"]
    with zipfile.ZipFile(got) as zg, zipfile.ZipFile(want) as zw:
        names = sorted(zg.namelist())
        assert names == sorted(zw.namelist()) and len(names) == 2
        for name in names:
            assert re.match(GOLDEN["entry_name_pattern"], name), name
            g = pa.ipc.open_file(zg.read(name)).read_all()
            w = pa.ipc.open_file(zw.read(name)).read_all()
            assert g.column_names == [c["name"] for c in spec["columns"]]
            assert [str(t) for t in g.schema.types] == [
                c["pyarrow_type"] for c in spec["columns"]]
            assert g.schema == w.schema and g.num_rows == w.num_rows
            for c in g.column_names:
                a, b = g[c].to_numpy(), w[c].to_numpy()
                if a.dtype == np.float16:
                    ulp = np.spacing(np.abs(b)).astype(np.float32)
                    assert (np.abs(a.astype(np.float32) - b.astype(np.float32))
                            <= TOL + ulp).all(), (name, c)
                elif c == "is_dynamic":      # a 0.05 m threshold on the flow
                    assert (a != b).mean() < 0.01, (name, c)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{name} {c}")
            ts = name.split("/")[1][:-len(".feather")]
            with h5py.File(os.path.join(test_dir, os.listdir(test_dir)[0])) as f:
                n_raw, em = len(f[ts]["lidar"]), f[ts]["eval_mask"][:].astype(bool)
            assert g.num_rows == {"eval_mask_points": int(em.sum()),
                                  "all_raw_sweep_points": n_raw}[spec["row_selection"]]
    ds.close()
    jds.close()


def test_load_weights_reproduces_jax(env, tmp_path):
    path = save_torch_checkpoint(env.variables, str(tmp_path / "jax.pth"))
    model = build_model(env.cfg["model"], precision="fp32", device="cpu", seed=9)
    load_weights(model, path)
    ds = HDF5Dataset(str(env.cfg["val_data"]), max_points=2048)
    hb = next(iter(DataLoader(ds, 2, post_collate=evaluate._sorted_prep(env.cfg))))
    want = env.jax_step(env.state.params, env.state.batch_stats,
                        T.device_batch(hb, None))
    got = make_eval_step(model, device="cpu")(hb)
    err = np.abs(got["pred_flow"].numpy() - np.asarray(want["pred_flow"])).max()
    assert err < TOL
    ds.close()
    os.mkdir(tmp_path / "orbax")
    with pytest.raises(ValueError, match="directory"):
        load_weights(model, str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="unsupported checkpoint"):
        load_weights(model, str(tmp_path / "weights.npz"))


def test_save_main_writes_res_name(env, tmp_path):
    split = tmp_path / "val"
    shutil.copytree(env.cfg["val_data"], split)
    path = save_torch_checkpoint(env.variables, str(tmp_path / "jax.pth"))
    cfg = env.cfg.copy()
    cfg["dataset_path"] = str(split)
    cfg["checkpoint"] = path
    assert save.main(cfg) == "jax"                # the checkpoint's stem
    ds = HDF5Dataset(str(split), max_points=2048, with_labels=False)
    hb = next(iter(evaluate._loader(ds, cfg)))          # the batches save runs
    pred = env.step(hb)["pred_flow"][0].numpy()[hb["pc0_unsort"][0]]
    n = int(hb["pc0_mask"][0].sum())
    ds.close()
    scene = next(split.iterdir())
    with h5py.File(scene) as f:
        keys = sorted(f.keys(), key=int)
        assert ["jax" in f[k] for k in keys] == [True, True, True, False]
        np.testing.assert_array_equal(f[hb["timestamp"][0]]["jax"][:], pred[:n])


def test_evaluate_main_val_and_test(env, tmp_path):
    cfg = env.cfg.copy()
    cfg["checkpoint"] = save_torch_checkpoint(env.variables, str(tmp_path / "w.pth"))
    metrics = evaluate.main(cfg)
    ds = HDF5Dataset(str(env.cfg["val_data"]), max_points=2048)
    want = evaluate.run_validation(env.step, ds, env.cfg, "cpu")
    ds.close()
    assert metrics.keys() == want.keys()
    np.testing.assert_allclose([metrics[k] for k in want], [want[k] for k in want],
                               rtol=1e-12, equal_nan=True)
    cfg["av2_mode"] = "test"
    cfg["output_zip_dir"] = str(tmp_path)
    out = evaluate.main(cfg)
    with zipfile.ZipFile(out["submission"]) as zf:
        assert len(zf.namelist()) == 2


def test_metric_workers_give_the_serial_result(env):
    """Frame terms computed in worker processes and added in frame order
    give the serial accumulation, bit for bit."""
    ds = HDF5Dataset(str(env.cfg["val_data"]), max_points=2048)
    batches = list(DataLoader(ds, 2, post_collate=evaluate._sorted_prep(env.cfg)))
    ds.close()
    results = []
    for workers in (0, 3):
        three, bucketed = ThreewayEPE(), BucketedEPE()
        metrics = evaluate.run_validation(env.step, batches, three=three,
                                          bucketed=bucketed, num_workers=workers)
        results.append((metrics, three, bucketed))
    (m0, t0, b0), (m1, t1, b1) = results
    assert m0.keys() == m1.keys()
    for k in m0:
        assert m0[k] == m1[k] or (np.isnan(m0[k]) and np.isnan(m1[k])), k
    assert t0.sums == t1.sums and t0.point_counts == t1.point_counts
    for a, b in ((b0.epe_sum, b1.epe_sum), (b0.speed_sum, b1.speed_sum),
                 (b0.count, b1.count)):
        assert a.tobytes() == b.tobytes()
    # and the accumulators' own update gives the same sums
    serial_three, serial_bucketed = ThreewayEPE(), BucketedEPE()
    for hb in batches:
        out = env.step(hb)
        for b in range(len(hb["pc0"])):
            args = (out["pred_flow"][b].numpy(), hb["flow"][b],
                    hb["flow_category_indices"][b], out["pose_flow"][b].numpy(),
                    hb["pc0_mask"][b] & hb["flow_is_valid"][b] & hb["eval_mask"][b])
            serial_three.update(*args)
            serial_bucketed.update(*args)
    assert serial_three.sums == t1.sums
    assert serial_bucketed.epe_sum.tobytes() == b1.epe_sum.tobytes()
