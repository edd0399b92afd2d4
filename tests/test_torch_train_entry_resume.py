"""Checkpoints and resume of the port's train entry on the CPU in f32: the
best-checkpoint keeper, a checkpoint's round trip, a resumed run's best,
and ``main`` resumed against ``main`` uninterrupted.

Shapes are those of ``tests/test_torch_train_step.py`` (B = 2, N = 512,
32² grid, 4 GRU iterations) and ``tests/test_train_e2e.py`` (synthetic
splits of 900-point frames, max_points 1,024, 64² grid, 2 GRU
iterations).  Torch runs on one thread (``torch_threads.one_torch_thread``).

Tolerances: a checkpoint's round trip and the resumed run against the
uninterrupted one bit for bit (the same operations in the same order on
the CPU).
"""

import os

import numpy as np
import pytest
import torch

from deflow_tpu_torch import trainer as TT
from deflow_tpu_torch.config import compose
from deflow_tpu_torch.convert import load_weights as load_weights_file
from deflow_tpu_torch.entry import evaluate
from deflow_tpu_torch.entry import train as TE
from deflow_tpu_torch.models import build_model

from test_torch_train_entry import (SMALL_MODEL, _overrides, _prepped, _same_state,
                                    _same_tree, _small_samples, _small_state,
                                    data_root)  # noqa: F401 (data_root: a fixture)
from test_torch_train_step import LR
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_best_checkpoint_keeper(tmp_path, mode):
    """``test_train_e2e.py``'s replay of the JAX keeper: no save on a worse
    value, an overwrite on a better one, a missing key ignored."""
    sign = 1.0 if mode == "min" else -1.0
    state = _small_state(0)
    keeper = TT.BestCheckpointKeeper(str(tmp_path), "val/EPE_3way_mean", mode=mode)
    assert keeper.key == "EPE_3way_mean"
    p1 = keeper.update({"EPE_3way_mean": 0.5 * sign}, state, epoch=0)
    assert p1 == str(tmp_path / "best.ckpt") and os.path.isfile(p1)
    state2 = TT.TrainState(state.model, state.optimizer, state.clip, state.step + 1)
    assert keeper.update({"EPE_3way_mean": 0.7 * sign}, state2, epoch=1) is None
    restored, nxt = TT.load_checkpoint(p1, _small_state(1))
    assert restored.step == state.step and nxt == 1
    p2 = keeper.update({"EPE_3way_mean": 0.3 * sign}, state2, epoch=2)
    assert p2 == p1
    restored, nxt = TT.load_checkpoint(p1, _small_state(1))
    assert restored.step == state2.step and nxt == 3
    assert keeper.update({"other": 1.0}, state, epoch=3) is None
    assert keeper.best == 0.3 * sign
    assert sorted(os.listdir(tmp_path)) == ["best.ckpt"]
    with pytest.raises(ValueError, match="min|max"):
        TT.BestCheckpointKeeper(str(tmp_path), "val/x", mode="mean")


def test_checkpoint_round_trip(tmp_path):
    """Save after a step, load into a state from another seed: identical,
    and one more step from each identical; the file is a reference-layout
    checkpoint that ``convert.load_weights`` and the eval entry read."""
    state = _small_state(1)
    step = TT.make_train_step(state.model, "deflowLoss", device="cpu")
    state, _ = step(state, _prepped(60))
    path = TT.save_checkpoint(str(tmp_path / "ckpt"), state, epoch=4)
    assert path == str(tmp_path / "ckpt" / "epoch_4.ckpt")
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["epoch_4.ckpt"]
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert set(raw) == {"state_dict", "optimizer_states", "global_step", "epoch"}
    assert raw["global_step"] == 1 and raw["epoch"] == 4
    assert set(raw["state_dict"]) == {f"model.{k}" for k in state.model.state_dict()}

    other = _small_state(2)
    assert not torch.equal(other.model.head.gru.convz.weight,
                           state.model.head.gru.convz.weight)
    other, nxt = TT.load_checkpoint(path, other)
    assert nxt == 5
    _same_state(state, other)
    hb = _prepped(61)
    state, aux = step(state, hb)
    other, aux_o = TT.make_train_step(other.model, "deflowLoss", device="cpu")(other, hb)
    assert torch.equal(aux["loss"], aux_o["loss"])
    _same_state(state, other)

    # the weights alone, by convert.load_weights, trainer.load_weights and
    # the eval entry
    for load in (lambda m: load_weights_file(m, path),
                 lambda m: TT.load_weights(path, TT.init_train_state(
                     m, {"lr": LR}, device="cpu")).model):
        fresh = build_model(SMALL_MODEL, precision="fp32", device="cpu", seed=3)
        want = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
        got = load(fresh).state_dict()
        assert all(torch.equal(got[k], want[f"model.{k}"]) for k in got)
    eval_cfg = {"model": {"target": SMALL_MODEL}, "precision": "fp32",
                "checkpoint": path}
    out = evaluate.load_eval_step(eval_cfg, "cpu")(_prepped(62))
    assert torch.isfinite(out["pred_flow"]).all()


def test_resumed_run_keeps_its_best(tmp_path, monkeypatch):
    """A run resumed from ``epoch_0.ckpt`` knows the best value so far, as
    Lightning restores ``best_model_score``: a worse validation does not
    overwrite ``best.ckpt``, a better one does.  (The JAX package's keeper
    starts empty, so its resumed run wrote the worse epoch as the best.)"""
    scores = iter([0.5, 0.9, 0.4])
    monkeypatch.setattr(TE, "run_validation",
                        lambda *a, **k: {"EPE_3way_mean": next(scores)})
    out = str(tmp_path / "run")
    over = ["batch_size=2", "num_workers=0", "max_points=512", "voxel_size=[3.2, 3.2, 6]",
            "model.target.grid_feature_size=[32, 32]", "model.target.num_iters=1",
            "precision=fp32", f"output_dir={out}", "device=cpu"]
    fit = lambda *extra: TE.fit(compose("config", over + list(extra)), _small_samples(2),
                                _small_samples(2))
    best = os.path.join(os.path.dirname(_epoch_ckpt(out, 0)), "best.ckpt")
    fit("epochs=1")
    first = torch.load(best, weights_only=True)
    assert first["epoch"] == 0
    assert first["callbacks"]["BestCheckpointKeeper"]["best_model_score"] == 0.5
    fit("epochs=2", f"resume={_epoch_ckpt(out, 0)}")
    _same_tree(torch.load(best, weights_only=True), first)
    saved = torch.load(_epoch_ckpt(out, 1), weights_only=True)
    assert saved["callbacks"]["BestCheckpointKeeper"]["best_model_score"] == 0.5
    fit("epochs=3", f"resume={_epoch_ckpt(out, 1)}")
    last = torch.load(best, weights_only=True)
    assert last["epoch"] == 2
    assert last["callbacks"]["BestCheckpointKeeper"]["best_model_score"] == 0.4


def _epoch_ckpt(out, epoch):
    return os.path.join(out, "wandb", "deflow-local", "checkpoints", f"epoch_{epoch}.ckpt")


def test_resume_equals_uninterrupted_run(data_root, tmp_path):
    """``main`` for 2 epochs against ``main`` for 1 epoch and a resume for
    the second: the same final checkpoint bit for bit (parameters, BN
    buffers, Adam state, step) and the same metrics.  A resume that ran the
    saved epoch again, or shuffled its epoch as epoch 0, would differ."""
    runs = {}
    for name, extra in (("full", {"epochs": 2}), ("first", {"epochs": 1})):
        out = str(tmp_path / name)
        runs[name] = (out, TE.main(compose("config", _overrides(data_root, out, **extra)),
                                   device="cpu"))
    out = str(tmp_path / "resumed")
    metrics = TE.main(compose("config", _overrides(
        data_root, out, epochs=2, resume=_epoch_ckpt(runs["first"][0], 0))), device="cpu")
    full_out, full_metrics = runs["full"]
    assert sorted(os.listdir(os.path.dirname(_epoch_ckpt(full_out, 0)))) == [
        "best.ckpt", "epoch_0.ckpt", "epoch_1.ckpt"]
    assert not os.path.exists(_epoch_ckpt(out, 0))     # epoch 0 did not run again
    want = torch.load(_epoch_ckpt(full_out, 1), weights_only=True)
    got = torch.load(_epoch_ckpt(out, 1), weights_only=True)
    assert want["global_step"] == 8 and want["epoch"] == 1
    _same_tree(got, want)
    _same_tree(torch.load(_epoch_ckpt(runs["first"][0], 0), weights_only=True),
               torch.load(_epoch_ckpt(full_out, 0), weights_only=True))
    assert metrics.keys() == full_metrics.keys()
    for k in metrics:
        assert metrics[k] == full_metrics[k] or (np.isnan(metrics[k])
                                                 and np.isnan(full_metrics[k])), k
