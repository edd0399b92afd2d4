"""The port's entry points over two gloo CPU ranks (``torchrun``'s
semantics, spawned by ``deflow_tpu_torch.dist.run_ranks``) against the
same entries in one process, on synthetic splits (``tests/
test_train_e2e.py``'s: 900-point frames, ``max_points`` 1,024, a 64² grid,
2 GRU iterations, f32; ``batch_size`` 4, the global batch: 2 rows a rank,
so the U-Net runs its fused chains; remat on, the config's default).

- ``main`` for 2 epochs: the final checkpoint's parameters within 1e-5
  (the conv biases before a train-mode BN, zero gradient in exact
  arithmetic, within 2·lr a step: Adam maps their rounding noise anywhere
  in [−lr, lr]), its BN running statistics within 1e-6 of each buffer's
  largest element, or 1e-6 where that is below 1 (the running
  means of the BNs after those biases within 1e-6 + 0.1·2·lr a step, as
  their batch means move with the bias), its Adam step equal; the validation metrics within 1e-4 relative, since in eval those
  biases move the flow (the accuracies, shares of points, within 1e-4
  absolute), as ``tests/test_torch_train_entry.py`` holds the port's
  ``main`` to JAX's;
- rank 0 alone writes the checkpoints and ``metrics.jsonl`` (as many
  records as one process writes);
- a resume from ``epoch_0.ckpt`` over two ranks ends on the uninterrupted
  two-rank run's ``epoch_1.ckpt``, bit for bit;
- ``run_validation`` of one seeded model over 5 pairs in batches of 4 (the
  last, ragged, padded to 2 rows): the single-process metrics within
  1e-5 relative, the accuracies (shares of a frame's points under a
  threshold) within 2e-3, about one point of a frame flipped: the ranks
  run torch on one thread at 2 rows a batch, the one process on its
  worker's threads at 4, and CPU convolutions then round in another
  order (the flows differ in their last bits; one EPE mean by 7e-8);
- a ``batch_size`` that does not divide over the ranks raises.
"""

import json
import os

import numpy as np
import pytest
import torch

from deflow_tpu_torch import dist
from deflow_tpu_torch.data.synthetic import make_split

import torch_dist_ranks as R
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

LR = 2e-4
OVERRIDES = {"batch_size": 4, "lr": LR, "epochs": 2, "num_workers": 0,
             "max_points": 1024, "voxel_size": "[1.6,1.6,6]",
             "model.target.grid_feature_size": "[64,64]",
             "model.target.num_iters": 2, "precision": "fp32"}
CKPTS = os.path.join("wandb", "deflow-local", "checkpoints")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The entries over two ranks (one spawn) and in one process."""
    root = str(tmp_path_factory.mktemp("av2"))
    make_split(root, "train", num_scenes=3, num_frames=4, points_per_frame=900,
               labeled=True)
    make_split(root, "val", num_scenes=1, num_frames=3, points_per_frame=900,
               labeled=True, seed=7)
    make_split(root, "val5", num_scenes=1, num_frames=6, points_per_frame=900,
               labeled=True, seed=8)
    two, one = (str(tmp_path_factory.mktemp(n)) for n in ("two", "one"))
    ranks = dist.run_ranks(R.entry_runs, 2, "gloo", "cpu",
                           args=(root, two, OVERRIDES), timeout=900)
    return {"two": (two, ranks), "one": (one, R.entry_runs(root, one, OVERRIDES))}


def _ckpt(out, run, epoch):
    return torch.load(os.path.join(out, run, CKPTS, f"epoch_{epoch}.ckpt"),
                      weights_only=True)


def _same_metrics(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k] == w or (np.isnan(w) and np.isnan(got[k])), k


def _close_metrics(got, want, rtol=1e-4, acc_atol=1e-4):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if "Acc" in k:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=acc_atol, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=rtol, err_msg=k)


def test_two_rank_fit_equals_one_process_fit(runs):
    (two, ranks), (one, single) = runs["two"], runs["one"]
    got, want = _ckpt(two, "full", 1), _ckpt(one, "full", 1)
    assert got["global_step"] == want["global_step"] == 4
    steps = 4
    for key, w in want["state_dict"].items():
        g = got["state_dict"][key]
        unet = key.startswith("model.backbone.encoder_step_")
        if "num_batches" in key:
            assert torch.equal(g, w), key
        elif "running" in key:
            # a batch mean moves with its conv's bias (momentum 0.1)
            tol = 1e-6 * max(1, w.abs().max().item()) + (
                0.1 * steps * 2 * LR if unet and "mean" in key else 0.0)
            torch.testing.assert_close(g, w, rtol=0, atol=tol,
                                       msg=lambda m: f"{key}: {m}")
        else:
            bias = unet and key.endswith("conv.bias")
            torch.testing.assert_close(g, w, rtol=0, atol=steps * 2 * LR if bias else 1e-5,
                                       msg=lambda m: f"{key}: {m}")
    for r in ranks:
        _close_metrics(r["metrics"], single["metrics"])
    _same_metrics(ranks[1]["metrics"], ranks[0]["metrics"])


def test_rank0_alone_writes(runs):
    (two, ranks), (one, single) = runs["two"], runs["one"]
    assert ranks[1]["writes"] == []
    assert ranks[0]["writes"] == single["writes"]
    assert sorted(os.listdir(os.path.join(two, "full", CKPTS))) == [
        "best.ckpt", "epoch_0.ckpt", "epoch_1.ckpt"]
    logs = [os.path.join(out, "full", "wandb", "deflow-local", "metrics.jsonl")
            for out in (two, one)]
    lines = [open(p).read().splitlines() for p in logs]
    assert len(lines[0]) == len(lines[1]) > 2
    steps = lambda ls: [json.loads(x).get("_step") for x in ls]
    assert steps(lines[0]) == steps(lines[1])


def test_two_rank_resume_equals_uninterrupted_run(runs):
    two, ranks = runs["two"]
    got, want = _ckpt(two, "resumed", 1), _ckpt(two, "full", 1)
    assert not os.path.exists(os.path.join(two, "resumed", CKPTS, "epoch_0.ckpt"))
    assert got["global_step"] == want["global_step"]
    for key, w in want["state_dict"].items():
        assert torch.equal(got["state_dict"][key], w), key
    for a, b in zip(got["optimizer_states"][0]["state"].values(),
                    want["optimizer_states"][0]["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in b)
    _same_metrics(ranks[0]["resumed"], ranks[0]["metrics"])


def test_two_rank_validation_with_a_ragged_batch(runs):
    ranks, single = runs["two"][1], runs["one"][1]
    assert single["val5"]["EPE_3way_mean"] > 0
    for r in ranks:
        _close_metrics(r["val5"], single["val5"], rtol=1e-5, acc_atol=2e-3)
    _same_metrics(ranks[1]["val5"], ranks[0]["val5"])


def test_batch_size_must_divide_over_ranks(runs):
    for r in runs["two"][1]:
        assert "batch_size=3 must divide evenly over 2 devices" in r["odd_batch"]
