"""Rank functions and batches of the data-parallel tests
(``tests/test_torch_dist.py``, ``tests/test_torch_dist_entry.py``).

``deflow_tpu_torch.dist.run_ranks`` spawns the ranks, which import this
module: it imports only numpy, torch and the port, so a rank starts without
JAX.  Every function here also runs without a process group, where it is
the single-process reference at the same global batch.
"""

import hashlib

import numpy as np
import torch

from deflow_tpu_torch import dist
from deflow_tpu_torch.convert import load_reference_state_dict
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.models.deflow import DeFlow
from deflow_tpu_torch.trainer import init_train_state, make_eval_step, make_train_step

VOXEL = (3.2, 3.2, 6.0)
GRID = (32, 32)
RANGE = [-51.2, -51.2, -3.0, 51.2, 51.2, 3.0]
LR = 2e-4


def shard_batch(seed, rows_per_rank, n=1024, ssl=False):
    """A global batch of two ranks' rows whose shards differ: rank 0's
    samples have ~95% valid points, 60% of them with slow network flow
    (< 0.4 m/s) and 40% mid (0.5–0.9 m/s), rank 1's ~40% valid, half mid
    and half fast (1.5–10 m/s), so the deflow loss's slow bucket is empty
    on rank 1, its fast bucket on rank 0, and its mid bucket holds unlike
    counts on both; the poses translate the ego, so the gt flow is the pose
    flow plus that network flow.  With ``ssl``, pc1 lies near pc0 (the
    truncated chamfer has matches) and the DUFO-dynamic share is 10% on
    rank 0 and 45% on rank 1."""
    rng = np.random.default_rng(seed)
    b = 2 * rows_per_rank
    rank1 = np.arange(b) >= rows_per_rank
    cloud = lambda: np.concatenate([rng.uniform(-48, 48, (b, n, 2)),
                                    rng.uniform(-2.5, 2.5, (b, n, 1))], -1)
    pc0 = cloud().astype(np.float32)
    pose0 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose1 = pose0.copy()
    pose0[:, :3, 3] = rng.uniform(-1, 1, (b, 3))
    pose1[:, :3, 3] = rng.uniform(-1, 1, (b, 3))
    direction = rng.normal(size=(b, n, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    mid = rng.random((b, n)) < np.where(rank1, 0.5, 0.4)[:, None]
    speed = np.where(mid, rng.uniform(0.05, 0.09, (b, n)),
                     np.where(rank1[:, None], rng.uniform(0.15, 1.0, (b, n)),
                              rng.uniform(0.0, 0.035, (b, n))))
    net = direction * speed[..., None]
    valid = np.where(rank1, 0.4, 0.95)[:, None]
    hb = {"pc0": pc0, "pose0": pose0, "pose1": pose1,
          "pc0_mask": rng.random((b, n)) < valid,
          "pc1_mask": rng.random((b, n)) < valid,
          "flow": (pose0[:, None, :3, 3] - pose1[:, None, :3, 3] + net).astype(np.float32),
          "flow_is_valid": rng.random((b, n)) < 0.97,
          "flow_category_indices": rng.integers(0, 30, (b, n)).astype(np.int32)}
    if ssl:
        hb["pc1"] = (pc0 + rng.normal(0, 0.7, (b, n, 3))).astype(np.float32)
        dyn = np.where(rank1, 0.45, 0.1)[:, None]
        hb["dufo_label0"] = (rng.random((b, n)) < dyn).astype(np.int32)
        hb["dufo_label1"] = (rng.random((b, n)) < dyn).astype(np.int32)
    else:
        hb["pc1"] = cloud().astype(np.float32)
    return hb


def own_rows(hb):
    """This rank's rows of a global host batch."""
    b = len(hb["pc0"]) // dist.world()
    lo = dist.rank() * b
    return {k: v[lo:lo + b] for k, v in hb.items()}


def model_from(sd, decoder_option="gru", num_iters=2):
    """The f32 port DeFlow at the tests' grid with the reference-layout
    weights ``sd``."""
    model = DeFlow(voxel_size=VOXEL, point_cloud_range=RANGE, grid_feature_size=GRID,
                   decoder_option=decoder_option, num_iters=num_iters,
                   dtype=torch.float32)
    load_reference_state_dict(model, {k: torch.as_tensor(v) for k, v in sd.items()})
    return model


def digest(model) -> str:
    """One hash of every parameter and buffer, bit for bit."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_steps(sd, batches, loss_name, remat=False, grid_pairs=None, model_kw=None):
    """Adam steps (lr ``LR``) of ``loss_name`` on this rank's rows of each
    global host batch (prepped on this rank, as the loader preps them).
    ``grid_pairs`` lowers the SeFlow chamfer's grid threshold.  Returns
    each step's aux, the first step's gradients, the state after the last
    step and a digest of the parameters and buffers after each step."""
    from deflow_tpu_torch.ops import chamfer

    model = model_from(sd, **(model_kw or {}))
    state = init_train_state(model, {"lr": LR}, device="cpu")
    step = make_train_step(model, loss_name, device="cpu", remat=remat)
    out = {"aux": [], "digests": []}
    threshold = chamfer._AUTO_GRID_PAIRS
    if grid_pairs is not None:
        chamfer._AUTO_GRID_PAIRS = grid_pairs
    try:
        for i, hb in enumerate(batches):
            state, aux = step(state, attach_host_prep(own_rows(hb), list(VOXEL), RANGE))
            out["aux"].append({k: float(v) for k, v in aux.items()})
            if i == 0:
                out["grads"] = {k: p.grad.numpy().copy()
                                for k, p in model.named_parameters()}
            out["digests"].append(digest(model))
    finally:
        chamfer._AUTO_GRID_PAIRS = threshold
    out["state"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return out


def train_cases(sd, cases):
    """``train_steps`` for each ``(name, kwargs)`` of ``cases`` (the
    weights ``sd`` unless the kwargs hold their own): one spawn of the
    ranks serves every case."""
    return {name: train_steps(**{"sd": sd, **kw}) for name, kw in cases}


def eval_rows(sd, hb):
    """The eval step on this rank's rows of ``hb``; every rank's
    ``pred_flow`` gathered in rank order (``dist.gather_rows``)."""
    model = model_from(sd)
    out = make_eval_step(model, "cpu")(attach_host_prep(own_rows(hb), list(VOXEL), RANGE))
    return dist.gather_rows(out["pred_flow"]).numpy()


def entry_runs(root, out, overrides):
    """The train entry (``main``, 2 epochs; then a resume from its
    ``epoch_0.ckpt`` for epoch 1) on the synthetic splits under ``root``,
    writing under ``out``, and ``run_validation`` of a seeded model over
    the 5-pair ``val5`` split; under a process group also ``main`` at a
    ``batch_size`` that does not divide over the ranks.  ``overrides``: the
    config keys of every run.  Returns the metrics, the checkpoint files
    this rank wrote (relative to ``out``) and the error message."""
    import os

    from deflow_tpu_torch import trainer
    from deflow_tpu_torch.config import compose
    from deflow_tpu_torch.data.h5dataset import HDF5Dataset
    from deflow_tpu_torch.entry import evaluate
    from deflow_tpu_torch.entry import train as TE
    from deflow_tpu_torch.models import build_model

    def cfg(**kw):
        return compose("config", [f"{k}={v}" for k, v in
                                  {"dataset_path": root, **overrides, **kw}.items()])

    res = {}
    if dist.world() > 1:
        try:
            TE.main(cfg(batch_size=3, output_dir=os.path.join(out, "odd")), device="cpu")
        except ValueError as e:
            res["odd_batch"] = str(e)
    writes = []
    write = trainer._write_checkpoint

    def counted(ckpt_dir, path, *a, **k):
        writes.append(os.path.relpath(path, out))
        return write(ckpt_dir, path, *a, **k)

    trainer._write_checkpoint = counted
    try:
        full = os.path.join(out, "full")
        res["metrics"] = TE.main(cfg(output_dir=full), device="cpu")
        first = os.path.join(full, "wandb", "deflow-local", "checkpoints", "epoch_0.ckpt")
        res["resumed"] = TE.main(cfg(output_dir=os.path.join(out, "resumed"),
                                     resume=first), device="cpu")
    finally:
        trainer._write_checkpoint = write
    res["writes"] = writes
    c = cfg()
    model = build_model(c["model"], precision="fp32", device="cpu", seed=3)
    ds = HDF5Dataset(os.path.join(root, "val5"), max_points=int(c["max_points"]))
    try:
        res["val5"] = evaluate.run_validation(make_eval_step(model, "cpu"), ds, c, "cpu")
    finally:
        ds.close()
    return res
