"""The save entry point (counterpart of ``deflow_tpu/entry/save.py``).

    python -m deflow_tpu_torch.entry.save dataset_path=<split dir> \\
        checkpoint=<.ckpt|.pth|.pt> [res_name=...] [device=cpu]

Runs inference over every frame pair of the split and writes the predicted
total flow back into the ``.h5`` scene files, in the dataset's point order,
under ``res_name`` (default: the checkpoint's stem), so a visualizer can
overlay it.  ``h5py`` is imported by ``main`` only.  Under torchrun every
rank evaluates its rows and rank 0 writes (``entry/evaluate.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deflow_tpu_torch import dist
from deflow_tpu_torch.config import Config, check_num_devices, from_cli
from deflow_tpu_torch.data.h5dataset import HDF5Dataset
from deflow_tpu_torch.device import resolve_device
from deflow_tpu_torch.entry.evaluate import (_WRITER_KEYS, _loader, _outputs,
                                             load_eval_step)
from deflow_tpu_torch.trainer import device_prefetch


def main(cfg: Optional[Config] = None, device=None) -> str:
    if cfg is None:
        cfg = from_cli()
    with dist.launched(device if device is not None else cfg.get("device")):
        return _main(cfg, device)


def _main(cfg, device) -> str:
    import h5py

    dev = resolve_device(device if device is not None else cfg.get("device"))
    check_num_devices(cfg, dist.world())
    ckpt = str(cfg.get("checkpoint") or "")
    res_name = str(cfg.get("res_name") or "") or (
        os.path.splitext(os.path.basename(ckpt))[0] if ckpt else "deflow_tpu_torch")

    data_dir = str(cfg["dataset_path"])
    eval_step = load_eval_step(cfg, dev)
    ds = HDF5Dataset(data_dir, max_points=int(cfg["max_points"]),
                     remove_ground=bool(cfg["remove_ground"]), with_labels=False,
                     num_frames=int(cfg.get("num_frames", 2)))
    # predictions per (scene, timestamp), then one write per scene file
    results = {}
    try:
        batches = device_prefetch(_loader(ds, cfg), dev)
        for host_batch, out in _outputs(eval_step, batches, ("pred_flow",),
                                        _WRITER_KEYS):
            for b in range(host_batch.get("global_size") or len(host_batch["scene_id"])):
                n = int(host_batch["pc0_mask"][b].sum())
                pred = out["pred_flow"][b][host_batch["pc0_unsort"][b]]
                results.setdefault(host_batch["scene_id"][b], {})[
                    host_batch["timestamp"][b]] = pred[:n].astype(np.float32)
    finally:
        ds.close()

    dist.barrier()          # every rank has closed the scene files
    if not dist.is_main():
        return res_name
    for scene_id, frames in results.items():
        with h5py.File(os.path.join(data_dir, scene_id + ".h5"), "a") as f:
            for ts, flow in frames.items():
                g = f[ts]
                if res_name in g:
                    del g[res_name]
                g.create_dataset(res_name, data=flow)
    print(f"saved flow under key {res_name!r} in {len(results)} scene files")
    return res_name


if __name__ == "__main__":
    main()
