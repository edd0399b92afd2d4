"""SeFlow DUFO dynamic-point labels, on the card (``process.py``).

Counterpart of ``deflow_tpu/dataprocess/process.py`` (the reference's
``python process.py --scene_range a,b --interval k`` label jobs, reference
assets/slurm/dufolabel_sbatch.py:43-46,12), the same voxel-hash algorithm in
torch tensors (SeFlow, arXiv:2407.01702 §III, the DUFOMap stage): a lidar
point is *dynamic* if, in other ego-compensated frames of the same scene,
its location is observed as free space (a ray passed through it).

1. every frame's non-ground points in the city frame → the sorted unique
   voxel keys they occupy;
2. free space: samples every ``RAY_STEP`` metres along each ray from the
   frame's ego origin to its non-ground points (the last ``margin`` metres
   before the hit excluded), in chunks of 4M samples, → sorted unique keys;
3. a voxel occupied in a frame and free in another frame of the window
   around it is dynamic; a point's label is its voxel's verdict;
4. :func:`label_scene` writes the labels into the ``.h5`` under
   ``dufo_label`` (uint8), where SeFlow training reads them.

    python -m deflow_tpu_torch.dataprocess.process --data_dir <train split>
        [--scene_range a,b] [--interval k] [--window 10] [--device cpu]

:func:`label_frames` runs on the card unless ``device="cpu"``; with no card
it raises.  The JAX package's labeller is numpy with no kernel, and so is
this one's arithmetic: sorts, ``unique``, ``searchsorted`` and elementwise
passes.  The keys are ``floor(x / 0.2)`` of f32 coordinates, so the
labels stay the numpy labeller's only if every rounding does: the pose
transform in f64, then one cast to f32; the ray length as numpy's
``np.linalg.norm`` sums it, ``(x² + y²) + z²`` in f32; every constant an
f32 scalar on the device (NEP 50 makes numpy's python floats f32, and a
CUDA division by a host scalar becomes a multiplication by its
reciprocal); a sample ``origin + u·t`` as two roundings, never one FMA.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deflow_tpu_torch.device import resolve_device

VOXEL = 0.2
RAY_STEP = 0.4
MARGIN = 0.4
CHUNK = 4_000_000            # ray samples a chunk (bounds peak memory)


def _f32(v: float, dev: torch.device) -> torch.Tensor:
    """A python float as an f32 scalar on ``dev``, as NEP 50 rounds it."""
    return torch.full((), v, dtype=torch.float32, device=dev)


def _voxel_keys(pts: torch.Tensor, voxel: torch.Tensor) -> torch.Tensor:
    """[K, 3] f32 → int64 keys, 3 x 21-bit signed cell coordinates packed."""
    c = torch.floor(pts / voxel).to(torch.int64) + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _ray_free_keys(origin: torch.Tensor, pts: torch.Tensor, voxel: float,
                   step: float, margin: float = MARGIN,
                   chunk: int = CHUNK) -> torch.Tensor:
    """Sorted unique voxel keys of the free-space samples along the rays
    ``origin`` (f64 [3]) → ``pts`` (f32 [K, 3]), samples at t = k·step for
    k = 1 .. ⌈(|d| − margin)/step⌉ − 1 on rays longer than margin + step."""
    dev = pts.device
    d = (pts.double() - origin).float()
    dist = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
    keep = dist > _f32(margin + step, dev)
    d, dist = d[keep], dist[keep]
    if not len(dist):
        return torch.empty(0, dtype=torch.int64, device=dev)
    u = d / dist[:, None]
    n_per = (torch.ceil((dist - _f32(margin, dev)) / _f32(step, dev)).to(torch.int64)
             - 1).clamp(min=0)
    starts = torch.cat([n_per.new_zeros(1), torch.cumsum(n_per, 0)])
    total = int(starts[-1])
    origin32 = origin.float()
    vox, st = _f32(voxel, dev), _f32(step, dev)
    out = []
    for lo in range(0, total, chunk):
        flat = torch.arange(lo, min(lo + chunk, total), device=dev)
        ray = torch.searchsorted(starts, flat, right=True) - 1
        t = (flat - starts[ray] + 1).float() * st
        ut = u[ray] * t[:, None]                 # rounded, then the add: no FMA
        out.append(torch.unique(_voxel_keys(origin32 + ut, vox)))
    return torch.unique(torch.cat(out)) if out else torch.empty(
        0, dtype=torch.int64, device=dev)


def label_frames(frames: Sequence[Dict[str, np.ndarray]], window: int = 10,
                 voxel: float = VOXEL,
                 device: Optional[Union[str, torch.device]] = None) -> List[np.ndarray]:
    """DUFO labels (uint8, 1 = dynamic) of one scene's frames, in order.

    ``frames``: dicts with ``lidar`` [N, ≥3], ``pose`` [4, 4] (ego → city)
    and optionally ``ground_mask`` [N] bool (ground points neither occupy
    nor cast rays).  A frame's window is the ``window // 2`` frames on
    either side.  Runs on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    vox = _f32(voxel, dev)
    city, occupied, free = [], [], []
    for fr in frames:
        pc = torch.as_tensor(np.asarray(fr["lidar"])[:, :3], device=dev).double()
        pose = torch.as_tensor(np.asarray(fr["pose"]), device=dev).double()
        ground = fr.get("ground_mask")
        nonground = (torch.ones(len(pc), dtype=torch.bool, device=dev) if ground is None
                     else ~torch.as_tensor(np.asarray(ground), device=dev).bool())
        # the pose in f64, then one cast: the keys of every pass come from
        # the same f32 points
        pts = (pc @ pose[:3, :3].T + pose[:3, 3]).float()
        city.append(pts)
        occupied.append(torch.unique(_voxel_keys(pts[nonground], vox)))
        free.append(_ray_free_keys(pose[:3, 3], pts[nonground], voxel, RAY_STEP))

    labels = []
    for i, occ in enumerate(occupied):
        lo, hi = max(0, i - window // 2), min(len(frames), i + window // 2 + 1)
        dyn = torch.zeros(len(occ), dtype=torch.bool, device=dev)
        for j in range(lo, hi):
            if j != i and len(free[j]):
                fj = free[j]
                pos = torch.searchsorted(fj, occ).clamp(max=len(fj) - 1)
                dyn |= fj[pos] == occ
        label = torch.isin(_voxel_keys(city[i], vox), occ[dyn])
        labels.append(label.to(torch.uint8).cpu().numpy())
    return labels


def label_scene(path: str, window: int = 10, voxel: float = VOXEL,
                device: Optional[Union[str, torch.device]] = None) -> Tuple[int, float]:
    """Write ``dufo_label`` for every frame of one ``.h5`` scene (frames in
    timestamp order).  Returns ``(num_frames, dynamic_fraction)``: roughly
    3-15% of non-ground AV2 points move (SeFlow §V reports ~10% at 0.5 m/s);
    near 0 or above ~30% the labels, or the data, are off."""
    import h5py

    with h5py.File(path, "a") as f:
        ts = sorted(f.keys(), key=int)
        frames = []
        for t in ts:
            g = f[t]
            fr = {"lidar": g["lidar"][:], "pose": g["pose"][:]}
            if "ground_mask" in g:
                fr["ground_mask"] = g["ground_mask"][:].astype(bool)
            frames.append(fr)
        labels = label_frames(frames, window, voxel, device)
        for t, label in zip(ts, labels):
            g = f[t]
            if "dufo_label" in g:
                del g["dufo_label"]
            g.create_dataset("dufo_label", data=label, compression="lzf")
    dyn = sum(int(lab.sum()) for lab in labels)
    pts = sum(len(lab) for lab in labels)
    return len(ts), dyn / max(pts, 1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True,
                   help="preprocessed split dir of .h5 scenes (train)")
    p.add_argument("--scene_range", default="0,-1",
                   help="a,b slice over the sorted scene list (sharding)")
    p.add_argument("--interval", type=int, default=1,
                   help="process every k-th scene (sharding stride)")
    p.add_argument("--window", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="cpu for the CPU; the card by default")
    args = p.parse_args(argv)

    scenes = sorted(fn for fn in os.listdir(args.data_dir) if fn.endswith(".h5"))
    a, b = (int(x) for x in args.scene_range.split(","))
    if b < 0:
        b = len(scenes)
    shard = scenes[a:b:args.interval]
    dev = resolve_device(args.device)
    print(f"DUFO labeling {len(shard)} scenes [{a}:{b}:{args.interval}] on {dev}")
    fracs = []
    for fn in shard:
        n, frac = label_scene(os.path.join(args.data_dir, fn), window=args.window,
                              device=dev)
        fracs.append(frac)
        print(f"done: {fn} ({n} frames, {frac:.1%} dynamic)", flush=True)
    if fracs:
        mean_frac = float(np.mean(fracs))
        print(f"dynamic fraction over shard: {mean_frac:.1%} "
              f"(sanity band ~3-15%; SeFlow reports ~10%)")
        if not 0.01 <= mean_frac <= 0.3:
            print("WARNING: dynamic fraction outside the sanity band — "
                  "check ground masks / poses / window before SSL training")


if __name__ == "__main__":
    main()
