"""The eval entry point (counterpart of ``deflow_tpu/entry/evaluate.py``).

    python -m deflow_tpu_torch.entry.evaluate checkpoint=<.ckpt|.pth|.pt> \\
        av2_mode=val|test [device=cpu] [key=value ...]

``av2_mode=val`` prints the official 3-way table and the bucketed
(leaderboard v2) table; ``av2_mode=test`` writes the leaderboard submission
zip.  Runs on the card unless ``device=cpu`` is given in the config or the
call; without a card it raises.

The path: ``HDF5Dataset`` → ``DataLoader`` (samples decoded on the shared
thread pool; the C++ host prep as ``post_collate``, in the loader's prefetch
thread) → ``trainer.device_prefetch`` (the copy to the card, ahead of the
step) → the eval step → the metrics or the frame encodes.  The outputs of
batch k are read only after batch k+1 is dispatched, so the host's work on
them overlaps the device's next step.  Labels and masks were co-permuted
with the points by the host prep, so the metrics need no unsort; outputs
destined for the original point order are restored with ``pc0_unsort``.

Data parallel (under ``torchrun --nproc_per_node=W``, or any process
group): the batch size is rounded down to a multiple of W (at least W) and
the last batch padded to one, as the JAX package's mesh requires; each rank
loads, preps and evaluates its rows; the outputs (``dist.gather_rows``) and
the host keys the metrics or writers read (``dist.gather_host``) come
together on rank 0, which alone computes the metrics, on the global batch's
real rows, and writes; every rank returns the metrics.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import zipfile
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from deflow_tpu_torch import dist
from deflow_tpu_torch.config import Config, check_num_devices, from_cli
from deflow_tpu_torch.convert import load_weights
from deflow_tpu_torch.data.h5dataset import DataLoader, HDF5Dataset
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.device import resolve_device
from deflow_tpu_torch.metrics import BucketedEPE, ThreewayEPE, frame_metrics
from deflow_tpu_torch.models import build_model
from deflow_tpu_torch.trainer import device_prefetch, make_eval_step
from deflow_tpu_torch.utils.native import shared_pool


def _pose_flow_np(sample_pc0, sample_mask, ego_motion):
    moved = sample_pc0 @ ego_motion[:3, :3].T + ego_motion[:3, 3]
    return np.where(sample_mask[:, None], moved - sample_pc0, 0.0)


def _sorted_prep(cfg) -> Callable[[Dict], Dict]:
    """``post_collate`` of the eval and save loaders: the sorted C++ host
    prep over ``cfg["num_workers"]`` threads."""
    workers = int(cfg.get("num_workers", 0))
    voxel, pc_range = list(cfg["voxel_size"]), list(cfg["point_cloud_range"])
    return lambda b: attach_host_prep(b, voxel, pc_range, num_workers=workers)


def _loader(ds, cfg) -> DataLoader:
    """This rank's loader of the eval splits: global batches of
    ``batch_size`` rounded down to a multiple of the ranks (at least one a
    rank; ``deflow_tpu/entry/evaluate.py``)."""
    w, bs = dist.world(), int(cfg["batch_size"])
    return DataLoader(ds, max(w, bs - bs % w), shuffle=False,
                      drop_last=False, post_collate=_sorted_prep(cfg),
                      num_workers=int(cfg.get("num_workers", 0)),
                      rank=dist.rank(), world=w)


def _outputs(eval_step: Callable, batches: Iterable, keys: Sequence[str],
             host_keys: Sequence[str] = ()
             ) -> Iterator[Tuple[Dict, Dict[str, np.ndarray]]]:
    """``(host_batch, {key: numpy output})`` for each item of ``batches``
    (a host batch, or a ``(host_batch, device_batch)`` pair).  Batch k's
    outputs are copied to the host asynchronously and read only after batch
    k+1 has been dispatched.

    Under a process group every rank evaluates its rows, and rank 0 alone
    yields: the outputs of every rank's rows, and ``host_keys`` of every
    rank's host batch, rows in rank order (padding rows included: the
    global batch's real rows come first)."""
    pending = None
    for item in batches:
        host_batch, batch = item if isinstance(item, tuple) else (item, item)
        out = eval_step(batch)
        if dist.is_initialized():
            out = {k: dist.gather_rows(out[k].float()) for k in keys}
            size = host_batch.get("global_size")
            host_batch = dist.gather_host(host_batch, host_keys)
            if host_batch is None:
                continue
            host_batch["global_size"] = size
        host_out = {k: out[k].float().to("cpu", non_blocking=True) for k in keys}
        ready = None
        if out[keys[0]].is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        if pending is not None:
            yield _host_outputs(*pending)
        pending = (host_batch, host_out, ready)
    if pending is not None:
        yield _host_outputs(*pending)


def _host_outputs(host_batch, host_out, ready):
    if ready is not None:
        ready.synchronize()
    return host_batch, {k: v.numpy() for k, v in host_out.items()}


def _metric_pool(workers: int):
    """Worker processes for the frames' metric terms (``spawn``; the numpy
    work holds the GIL, so threads would not run it in parallel), or none
    for ``workers <= 1``."""
    if workers <= 1:
        return contextlib.nullcontext(None)
    return ProcessPoolExecutor(min(workers, os.cpu_count() or 1),
                               mp_context=multiprocessing.get_context("spawn"))


def run_validation(eval_step: Callable, data, cfg=None, device=None,
                   three: Optional[ThreewayEPE] = None,
                   bucketed: Optional[BucketedEPE] = None,
                   num_workers: int = 0) -> Dict[str, float]:
    """The validation sweep: the 3-way and the bucketed (leaderboard v2)
    metrics, in one dict.

    ``run_validation(eval_step, val_ds, cfg)``, the reference's form:
    ``val_ds`` (an ``HDF5Dataset``, or a list of samples shaped like its
    items) is loaded in batches of ``cfg["batch_size"]`` by a ``DataLoader``
    with the C++ host prep as ``post_collate`` on ``cfg["num_workers"]``
    threads, and moved to ``device`` by ``device_prefetch``.  Without
    ``cfg``, ``data`` is an iterable of host batches already prepped by
    ``attach_host_prep``, or of ``(host_batch, device_batch)`` pairs.

    With more than one worker (``cfg["num_workers"]``, else
    ``num_workers``) each frame's metric terms are computed in a worker
    process while the consumer moves on to the next batch; the terms are
    added in frame order, so the result is the serial one, bit for bit.
    Pass ``three`` and ``bucketed`` to keep the accumulators (for their
    tables).

    Under a process group (every rank calls this with its own ``eval_step``
    and the same arguments) rank 0 computes the metrics of the global
    batches' real rows and every rank returns them; only rank 0's
    accumulators are filled."""
    three = ThreewayEPE() if three is None else three
    bucketed = BucketedEPE() if bucketed is None else bucketed
    if cfg is not None:
        num_workers = int(cfg.get("num_workers", 0))
        data = device_prefetch(_loader(data, cfg), device)
    if not dist.is_main():
        num_workers = 0

    def add(terms):
        for t3, tb in terms:
            three.add(t3)
            bucketed.add(tb)

    with _metric_pool(num_workers) as pool:
        pending = ()
        for host_batch, out in _outputs(eval_step, data, ("pred_flow", "pose_flow"),
                                        _METRIC_KEYS):
            if "flow" not in host_batch or "flow_is_valid" not in host_batch:
                raise ValueError(
                    "run_validation needs ground-truth flow labels (keys 'flow' "
                    "and 'flow_is_valid'); this split has none — it looks like "
                    "a test split. Use av2_mode=test to write a submission "
                    "instead.")
            frames = []
            for b in range(host_batch.get("global_size") or len(out["pred_flow"])):
                mask = host_batch["pc0_mask"][b] & host_batch["flow_is_valid"][b]
                if "eval_mask" in host_batch:
                    mask &= host_batch["eval_mask"][b]
                frames.append((out["pred_flow"][b], host_batch["flow"][b],
                               host_batch["flow_category_indices"][b],
                               out["pose_flow"][b], mask))
            # this batch's terms start in the workers, then the previous
            # batch's are added
            started = (pool.map(frame_metrics, frames) if pool is not None
                       else map(frame_metrics, frames))
            add(pending)
            pending = started
        add(pending)
    metrics: Dict[str, float] = {}
    if dist.is_main():
        metrics.update(three.compute())
        metrics.update(bucketed.compute())
    return dist.broadcast_object(metrics)


# the host keys the metric terms read
_METRIC_KEYS = ("pc0_mask", "flow", "flow_is_valid", "flow_category_indices",
                "eval_mask")
# and those the submission writer and the save entry read
_WRITER_KEYS = ("scene_id", "timestamp", "pc0_mask", "pc0_unsort", "raw_lidar",
                "raw_ego_motion", "raw_ground_mask", "raw_eval_mask")


def _frame_full_flow(host_batch, out, b):
    """Predicted total flow and rigid ego flow for EVERY raw sweep point of
    frame ``b`` (original point order, before ground removal and crop).

    The model only sees the ground-removed, ``max_points``-cropped cloud;
    points it never saw get the rigid ego (pose) flow."""
    raw_pts = host_batch["raw_lidar"][b]
    pose_flow = _pose_flow_np(raw_pts, np.ones(len(raw_pts), bool),
                              host_batch["raw_ego_motion"][b])
    full = pose_flow.copy()
    pred = out["pred_flow"][b][host_batch["pc0_unsort"][b]]  # dataset order
    # the dataset's selection: stable ground filter, then crop
    kept = np.flatnonzero(~host_batch["raw_ground_mask"][b])
    kept = kept[: int(host_batch["pc0_mask"][b].sum())]
    full[kept] = pred[: len(kept)]
    return full, pose_flow


def encode_submission_frame(full: np.ndarray, pose_flow: np.ndarray,
                            eval_m: np.ndarray, version: int) -> bytes:
    """Feather-encode one frame's predicted flow (the leaderboard's
    per-frame payload): an lz4-compressed Arrow IPC file (Feather V2) of
    numpy columns."""
    import pyarrow as pa

    if version >= 2:
        flow = np.ascontiguousarray(full.astype(np.float16).T)
        cols = {"is_valid": eval_m.astype(bool),
                "flow_tx_m": flow[0], "flow_ty_m": flow[1],
                "flow_tz_m": flow[2]}
    else:
        flow = np.ascontiguousarray(full[eval_m].astype(np.float16).T)
        dyn = np.linalg.norm((full - pose_flow)[eval_m], axis=-1) > 0.05
        cols = {"flow_tx_m": flow[0], "flow_ty_m": flow[1],
                "flow_tz_m": flow[2], "is_dynamic": dyn}
    table = pa.table({k: pa.array(v) for k, v in cols.items()})
    sink = pa.BufferOutputStream()
    with pa.ipc.new_file(sink, table.schema, options=pa.ipc.IpcWriteOptions(
            compression="lz4")) as writer:
        writer.write_table(table)
    return sink.getvalue().to_pybytes()


def write_submission(eval_step: Callable, test_ds, cfg, out_dir: str,
                     version: int = 2, device=None) -> str:
    """Leaderboard submission writer: one ``<log_id>/<timestamp>.feather``
    per frame, zipped ready for upload.

    * ``version=1``: the av2-api ``make_submission_archive`` schema; rows
      are exactly the eval-mask points, columns ``flow_tx_m/ty/tz_m``
      float16 + ``is_dynamic`` bool (||flow − rigid ego flow|| > 0.05 m).
    * ``version=2``: the 2024 bucketed leaderboard; rows are ALL raw sweep
      points, columns ``is_valid`` bool (the scored points) +
      ``flow_tx_m/ty/tz_m`` float16.

    Zip entries are STORED (the feather bodies are already lz4-framed);
    ``submission_deflate: true`` in ``cfg`` asks for DEFLATE.  A batch's
    frames are encoded while the device runs the next batch, on the shared
    pool when ``cfg["num_workers"] > 1``; only the zip appends are serial.
    Under a process group every rank evaluates its rows and rank 0 writes
    the zip (the path is returned on every rank)."""
    if not getattr(test_ds, "submission_meta", False):
        raise ValueError("write_submission needs HDF5Dataset(submission_meta="
                         "True) to recover the raw per-sweep point sets")
    os.makedirs(out_dir, exist_ok=True)
    workers = int(cfg.get("num_workers", 0))
    comp = (zipfile.ZIP_DEFLATED if bool(cfg.get("submission_deflate", False))
            else zipfile.ZIP_STORED)
    batches = device_prefetch(_loader(test_ds, cfg), device)
    zip_path = os.path.join(out_dir, f"submission_v{version}.zip")
    with (zipfile.ZipFile(zip_path, "w", comp) if dist.is_main()
          else contextlib.nullcontext()) as zf:
        for host_batch, out in _outputs(eval_step, batches, ("pred_flow",),
                                        _WRITER_KEYS):
            def encode(b):
                full, pose_flow = _frame_full_flow(host_batch, out, b)
                return encode_submission_frame(
                    full, pose_flow, host_batch["raw_eval_mask"][b], version)

            bsz = host_batch.get("global_size") or len(host_batch["scene_id"])
            if workers > 1 and bsz > 1:
                payloads = list(shared_pool(workers).map(encode, range(bsz)))
            else:
                payloads = [encode(b) for b in range(bsz)]
            for b, payload in enumerate(payloads):
                zf.writestr(f"{host_batch['scene_id'][b]}/"
                            f"{host_batch['timestamp'][b]}.feather", payload)
    return zip_path


def load_eval_step(cfg, device) -> Callable:
    """The eval step of ``cfg``'s model (``cfg["num_frames"]`` frames) on
    ``device``: weights from ``cfg["checkpoint"]`` when given, else random
    from seed 0."""
    model = build_model(cfg["model"], precision=str(cfg.get("precision", "fp32")),
                        device=device, seed=0, num_frames=int(cfg.get("num_frames", 2)))
    if cfg.get("checkpoint"):
        load_weights(model, str(cfg["checkpoint"]))
        print(f"loaded checkpoint: {cfg['checkpoint']}")
    return make_eval_step(model, device)


def main(cfg: Optional[Config] = None, device=None) -> Dict[str, float]:
    """Evaluate (``av2_mode=val``) or write the submission (``test``); under
    torchrun, over its ranks."""
    if cfg is None:
        cfg = from_cli(config_name="config")
    with dist.launched(device if device is not None else cfg.get("device")):
        return _main(cfg, device)


def _main(cfg, device) -> Dict[str, float]:
    dev = resolve_device(device if device is not None else cfg.get("device"))
    check_num_devices(cfg, dist.world())
    eval_step = load_eval_step(cfg, dev)
    mode = str(cfg.get("av2_mode", "val"))
    split_dir = str(cfg["val_data"]) if mode == "val" else os.path.join(
        str(cfg["dataset_path"]), "test")
    ds = HDF5Dataset(split_dir, max_points=int(cfg["max_points"]),
                     remove_ground=bool(cfg["remove_ground"]),
                     with_labels=(mode == "val"),
                     submission_meta=(mode == "test"),
                     num_frames=int(cfg.get("num_frames", 2)))
    try:
        if mode == "val":
            three, bucketed = ThreewayEPE(), BucketedEPE()
            metrics = run_validation(eval_step, ds, cfg, dev, three, bucketed)
        else:
            zip_path = write_submission(
                eval_step, ds, cfg,
                out_dir=str(cfg.get("output_zip_dir", "logs/submissions")),
                version=int(cfg.get("leaderboard_version", 2)), device=dev)
    finally:
        ds.close()

    if mode != "val":
        if dist.is_main():
            print(f"submission written: {zip_path}")
            print("upload with: evalai challenge ... submit --file", zip_path)
        return {"submission": zip_path}
    if dist.is_main():
        print("\n== AV2 val, official 3-way metrics ==")
        print(three.table())
        print("== bucketed (leaderboard v2) ==")
        print(bucketed.table())
    if cfg.get("save_res"):
        # the reference's save_res flag: write the predictions into the scenes
        from deflow_tpu_torch.entry.save import main as save_main

        save_cfg = cfg.copy()
        save_cfg["dataset_path"] = split_dir
        save_main(save_cfg, device=dev)
    return metrics


if __name__ == "__main__":
    main()
