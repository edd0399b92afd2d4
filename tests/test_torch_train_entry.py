"""The port's train entry (``deflow_tpu_torch/entry/train.py``) and its
helpers against the JAX package's, on the CPU in f32: ``device_prefetch``,
the stage timer and the metric logger, the CLI, ``main`` against JAX's
``main``, ``fit`` over in-memory samples, the dyn_cap monitor and the
refusals.  The remat steps are in ``test_torch_train_entry_remat.py``, the
checkpoints and resume in ``test_torch_train_entry_resume.py``; both import
this file's helpers.

Shapes are those of ``tests/test_train_e2e.py`` (synthetic splits of
900-point frames, max_points 1,024, 64² grid, 2 GRU iterations) and
``tests/test_torch_train_step.py`` (B = 2, N = 512, 32² grid).  Torch runs
on one thread (``torch_threads.one_torch_thread``).

Tolerances, each with its reason:
- ``device_prefetch``: bit for bit (a copy);
- ``StageTimer`` and ``MetricLogger`` against the JAX classes: the same
  text and records (under one fake clock; apart from ``_ts``);
- the port's ``main`` against JAX's ``main`` after one epoch from the same
  weights: every validation metric within 1e-4 relative (EPEs and angles;
  the accuracies, shares of points under a threshold, within 1e-4
  absolute).  The two steps agree to the train step's f32 tolerances, but
  Adam maps the rounding noise of the conv biases in front of a
  train-mode BN (zero gradient in exact arithmetic) to steps of up to lr
  on each side, and in eval those biases move the flow.  The two sides
  measured 1.1e-5 at most (lr = 1e-3, one step of batch 8), the
  accuracies equal.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from deflow_tpu_torch import trainer as TT
from deflow_tpu_torch.config import compose
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.data.synthetic import make_split
from deflow_tpu_torch.entry import train as TE
from deflow_tpu_torch.models import build_model
from deflow_tpu_torch.utils.logger import MetricLogger
from deflow_tpu_torch.utils.timer import StageTimer

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import VOXEL
from test_torch_ssl_step import ssl_batch
from test_torch_train_step import LR
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
SMALL_MODEL = {"voxel_size": list(VOXEL), "point_cloud_range": RANGE, "num_iters": 4}
MAIN_TOL = 1e-4


def _overrides(root, out, **kw):
    over = {"dataset_path": root, "batch_size": 2, "lr": 1e-3, "epochs": 1,
            "num_workers": 0, "max_points": 1024, "voxel_size": "[1.6, 1.6, 6]",
            "model.target.grid_feature_size": "[64, 64]",
            "model.target.num_iters": 2, "precision": "fp32", "output_dir": out}
    over.update(kw)
    return [f"{k}={v}" for k, v in over.items()]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """``test_train_e2e.py``'s splits: 9 train pairs, 2 val pairs."""
    root = str(tmp_path_factory.mktemp("av2train"))
    make_split(root, "train", num_scenes=3, num_frames=4, points_per_frame=900,
               labeled=True)
    make_split(root, "val", num_scenes=1, num_frames=3, points_per_frame=900,
               labeled=True, seed=7)
    return root


def _small_state(seed):
    model = build_model(SMALL_MODEL, precision="fp32", device="cpu", seed=seed)
    return TT.init_train_state(model, {"lr": LR}, device="cpu")


def _prepped(seed, b=2, n=512):
    return attach_host_prep(make_host_batch(seed, b, n, VOXEL), list(VOXEL), RANGE)


def _same_state(a, b):
    """Every tensor of two models' state dicts and optimizer states, and
    the step, identical bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    _same_tree(a.optimizer.state_dict(), b.optimizer.state_dict())
    assert a.step == b.step


def _same_tree(x, y, path="") -> None:
    if isinstance(x, torch.Tensor):
        assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, path
        assert x.device == y.device and torch.equal(x, y), path
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), path
        for k in x:
            _same_tree(x[k], y[k], f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), path
        for i, (u, v) in enumerate(zip(x, y)):
            _same_tree(u, v, f"{path}/{i}")
    else:
        assert x == y, path


# --------------------------------------------------------------- prefetch
@pytest.mark.parametrize("keys", ["TRAIN_KEYS", "SSL_TRAIN_KEYS"])
def test_device_prefetch_delivers_the_train_keys(keys):
    keys = getattr(TT, keys)
    batches = []
    for s in range(3):
        hb = ssl_batch(50 + s)
        hb["ego_motion"] = np.linalg.inv(hb["pose1"]) @ hb["pose0"]
        # one history frame, as the loader emits it for num_frames=3
        hb.update(pch1=hb["pc0"] + 0.5, pch1_mask=hb["pc0_mask"].copy(),
                  pose_pch1=hb["pose0"].copy())
        batches.append(attach_host_prep(hb, list(VOXEL), RANGE))
    # every key but the deeper history frames' is in the batch
    present = [k for k in keys if k in batches[0]]
    assert set(keys) - set(present) == set(TT.HISTORY_KEYS[3:])
    got = list(TT.device_prefetch(batches, "cpu", keys=keys))
    assert len(got) == 3
    for hb, (host, dev) in zip(batches, got):
        assert host is hb and set(dev) == set(present)
        for k in present:
            assert torch.equal(dev[k], torch.from_numpy(np.ascontiguousarray(hb[k]))), k
    # the eval entry's calls keep the model keys
    _, dev = next(iter(TT.device_prefetch(batches[:1], "cpu")))
    assert set(dev) == set(TT.MODEL_KEYS) & set(batches[0])


# ------------------------------------------------------- timer and logger
def _fake_clock(monkeypatch):
    """``time.perf_counter`` steps by 0.125 s more at each call (exact in
    binary), from 0 at the first call."""
    import time

    ticks = iter(np.cumsum(np.arange(200) * 0.125).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def test_stage_timer_matches_jax(monkeypatch):
    from deflow_tpu.utils.timer import StageTimer as JaxStageTimer

    out = []
    for cls in (StageTimer, JaxStageTimer):
        _fake_clock(monkeypatch)
        syncs = []
        timer = cls("Total", sync_fn=lambda: syncs.append(1))
        timer.start()
        for _ in range(3):
            with timer.stage("step"):
                pass
        with timer.stage("data", "decode"):
            pass
        with timer.stage("data"):
            pass
        timer.stop()
        timer.stop()                 # not started: no sample
        out.append((timer.report(), timer.as_dict(), len(syncs),
                    timer.child("step").mean))
    assert out[0] == out[1]
    assert out[0][0].splitlines()[1].strip().startswith("step")


def _jsonl(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "_ts"} for line in f]


def test_metric_logger_matches_jax(tmp_path, monkeypatch):
    from deflow_tpu.utils.logger import MetricLogger as JaxMetricLogger

    monkeypatch.setitem(sys.modules, "wandb", None)      # the JSONL fallback
    cfg = {"lr": 2e-4, "model": {"name": "deflow", "voxel": [0.2, 0.2, 6.0]},
           "resume": None}
    records = []
    for cls, out in ((MetricLogger, tmp_path / "port"), (JaxMetricLogger, tmp_path / "jax")):
        log = cls(project="p", run_name="deflow-7", mode="offline",
                  output_dir=str(out), config=cfg)
        assert Path(log.run_dir) == out / "wandb" / "deflow-7"
        assert Path(log.ckpt_dir) == out / "wandb" / "deflow-7" / "checkpoints"
        assert os.path.isdir(log.ckpt_dir)
        log.log({"train/loss": 0.5, "epoch": 0}, step=1)
        log.log({"val/EPE": np.float32(0.25), "val/n": np.int64(3)}, step=2)
        log.log({"x": 1.0})
        log.finish()
        records.append(_jsonl(os.path.join(log.run_dir, "metrics.jsonl")))
        off = cls(project="p", run_name="off", mode="disabled", output_dir=str(out))
        off.log({"x": 1.0}, step=0)
        off.finish()
        assert not os.path.exists(os.path.join(off.run_dir, "metrics.jsonl"))
    assert records[0] == records[1]
    assert records[0][0] == {"_config": cfg} and len(records[0]) == 4


def test_train_cli_writes_checkpoints_and_needs_a_card(data_root, tmp_path):
    out = str(tmp_path / "cli")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    args = [sys.executable, "-m", "deflow_tpu_torch.entry.train"] + _overrides(
        data_root, out, epochs=2, batch_size=4)
    proc = subprocess.run(args + ["device=cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run_dir = os.path.join(out, "wandb", "deflow-local")
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "best.ckpt", "epoch_0.ckpt", "epoch_1.ckpt"]
    recs = _jsonl(os.path.join(run_dir, "metrics.jsonl"))
    assert recs[0]["_config"]["device"] == "cpu"
    train = [r for r in recs if "train/loss" in r]
    assert [r["epoch"] for r in train] == [0, 1]
    assert {"train/loss", "train/epe", "train/grad_norm", "train/frames_per_sec",
            "epoch", "_step"} == set(train[0])
    assert sum("val/EPE_3way_mean" in r for r in recs) == 2
    assert "step" in proc.stdout and "saved checkpoint" in proc.stdout
    proc = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# ------------------------------------------------------- entry: vs JAX main
def test_main_matches_jax_main(data_root, tmp_path):
    """Both ``main``s, one epoch (one step of batch 8 on JAX's 8-device CPU
    mesh) from one ``.ckpt`` written from the JAX init, then validation."""
    import jax

    from deflow_tpu import trainer as JT
    from deflow_tpu.config import compose as jax_compose
    from deflow_tpu.convert import save_torch_checkpoint
    from deflow_tpu.data import DataLoader as JaxDataLoader
    from deflow_tpu.data import HDF5Dataset as JaxHDF5Dataset
    from deflow_tpu.entry.train import main as jax_main
    from deflow_tpu.models import build_model as jax_build_model

    over = _overrides(data_root, str(tmp_path / "port"), batch_size=8)
    jcfg = jax_compose("config", [o.replace(str(tmp_path / "port"), str(tmp_path / "jax"))
                                  for o in over])
    ds = JaxHDF5Dataset(str(jcfg.train_data), max_points=1024)
    jstate = JT.init_state(jax_build_model(jcfg.model, precision="fp32"), jcfg,
                           next(iter(JaxDataLoader(ds, 8))), seed=0)
    ds.close()
    ckpt = save_torch_checkpoint({"params": jax.device_get(jstate.params),
                                  "batch_stats": jax.device_get(jstate.batch_stats)},
                                 str(tmp_path / "init.ckpt"))
    jcfg.checkpoint = ckpt
    want = jax_main(jcfg)
    got = TE.main(compose("config", over + [f"checkpoint={ckpt}"]), device="cpu")
    assert got.keys() == want.keys() and "EPE_3way_mean" in got
    for k, w in want.items():
        g = got[k]
        if np.isnan(w):
            assert np.isnan(g), k
        elif "Acc" in k:
            assert abs(g - w) <= MAIN_TOL, (k, g, w)
        else:
            assert abs(g - w) <= MAIN_TOL * abs(w), (k, g, w)


# -------------------------------------------------------- entry: SSL, fit
def _memory_split(n_samples, b_seed=70):
    """Samples shaped like ``HDF5Dataset`` items, with DUFO labels."""
    hb = ssl_batch(b_seed, b=n_samples)
    samples = []
    for i in range(n_samples):
        s = {k: v[i] for k, v in hb.items()}
        s.update(scene_id=f"s{i}", timestamp=str(i), num_points0=np.int32(s["pc0_mask"].sum()))
        samples.append(s)
    return samples


def test_fit_seflow_over_in_memory_samples(tmp_path, monkeypatch):
    """``fit`` of ``seflowLoss`` (remat, the config's default) over a list
    of samples: the DUFO labels reach the loss through ``device_prefetch``,
    the monitor sees every batch, and the run writes its checkpoint."""
    cfg = compose("config", [
        "loss_fn=seflowLoss", "batch_size=2", "epochs=1", "num_workers=0",
        "max_points=512", "voxel_size=[3.2, 3.2, 6]", "model.target.num_iters=2",
        "model.target.grid_feature_size=[32, 32]", "precision=fp32", "log_every=1",
        f"output_dir={tmp_path}", "device=cpu"])
    assert cfg["remat"] is True
    checked = []
    orig = TE.DynCapMonitor.check
    monkeypatch.setattr(TE.DynCapMonitor, "check",
                        lambda self, hb: (checked.append(hb["scene_id"]), orig(self, hb)))
    res = TE.fit(cfg, _memory_split(6))
    assert res.state.step == 3 and len(checked) == 3
    assert sorted(sum(checked, [])) == [f"s{i}" for i in range(6)]
    assert np.isfinite(res.last_aux["loss"]) and res.last_aux["loss"] > 0
    assert res.metrics == {}
    assert os.listdir(os.path.join(res.run_dir, "checkpoints")) == ["epoch_0.ckpt"]
    assert res.timer.child("step").samples and len(res.timer.child("step").samples) == 3


# ------------------------------------------------------------ refusals
def _small_samples(n, seed=80):
    hb = make_host_batch(seed, n, 512, VOXEL)
    return [dict({k: v[i] for k, v in hb.items()}, scene_id=f"s{i}", timestamp="0")
            for i in range(n)]


@pytest.mark.parametrize("dyn_cap", [None, 150, 100, 0])
def test_dyn_cap_monitor_matches_jax(monkeypatch, dyn_cap):
    from deflow_tpu.entry.train import DynCapMonitor as JaxDynCapMonitor

    monkeypatch.delenv("DEFLOW_SSL_DYNCAP", raising=False)
    rng = np.random.default_rng(3)
    batches = []
    for dens in (0.1, 0.3, 0.25, 0.45, 0.2, 0.5):
        hb = {"pc0_mask": rng.random((2, 400)) < 0.9, "pc1_mask": rng.random((2, 400)) < 0.9,
              "dufo_label0": (rng.random((2, 400)) < dens).astype(np.int32),
              "dufo_label1": (rng.random((2, 400)) < dens * 0.8).astype(np.int32)}
        batches.append(hb)
    batches.append({"pc0_mask": batches[0]["pc0_mask"]})       # no labels: skipped
    seen = []
    for cls in (TE.DynCapMonitor, JaxDynCapMonitor):
        mon = cls(dyn_cap)
        warned = []
        for hb in batches:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                mon.check(hb)
            warned.append(len(rec))
        seen.append((warned, mon.seen_max))
    assert seen[0] == seen[1]
    assert sum(seen[0][0]) == {None: 0, 150: 2, 100: 3, 0: 4}[dyn_cap]


def test_dyncap_env_override_raises(data_root, tmp_path, monkeypatch):
    """``DEFLOW_SSL_DYNCAP`` as the JAX package's monitor reads it: 0 is no
    override, a number is the budget, an explicit argument wins; the
    monitors then warn alike, and ``check_supported`` accepts the
    override."""
    from deflow_tpu.entry.train import DynCapMonitor as JaxDynCapMonitor

    rng = np.random.default_rng(5)
    hb = {"pc0_mask": np.ones((2, 400), bool), "pc1_mask": np.ones((2, 400), bool),
          "dufo_label0": (rng.random((2, 400)) < 0.3).astype(np.int32),
          "dufo_label1": (rng.random((2, 400)) < 0.1).astype(np.int32)}
    for env, arg in ((None, None), ("0", None), ("64", None), ("64", 500), ("0", 64)):
        if env is None:
            monkeypatch.delenv("DEFLOW_SSL_DYNCAP", raising=False)
        else:
            monkeypatch.setenv("DEFLOW_SSL_DYNCAP", env)
        warned = []
        for mon in (TE.DynCapMonitor(arg), JaxDynCapMonitor(arg)):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                mon.check(hb)
            warned.append((mon.dyn_cap, len(rec), mon.seen_max))
        assert warned[0] == warned[1], (env, arg)
        assert warned[0][1] == (1 if (env, arg) in (("64", None), ("0", 64)) else 0)
    monkeypatch.setenv("DEFLOW_SSL_DYNCAP", "64")
    TE.check_supported(compose("config", _overrides(data_root, str(tmp_path))))


@pytest.mark.parametrize("override", ["num_devices=2"])
def test_main_refuses_what_is_not_ported(data_root, tmp_path, override):
    """``num_devices`` other than the ranks the launcher started (one
    process here) raises before anything is written."""
    cfg = compose("config", _overrides(data_root, str(tmp_path)) + [override])
    with pytest.raises(ValueError, match="num_devices=2, but the launcher started 1"):
        TE.main(cfg, device="cpu")
    with pytest.raises(ValueError, match="num_devices=2, but the launcher started 1"):
        TE.fit(cfg, _small_samples(2), device="cpu")
    assert not os.path.exists(tmp_path / "wandb")


def test_main_raises_without_a_card(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = compose("config", _overrides(data_root, str(tmp_path)))
    assert cfg.get("device") is None
    for call in (lambda: TE.main(cfg), lambda: TE.fit(cfg, _small_samples(2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(tmp_path / "wandb")
