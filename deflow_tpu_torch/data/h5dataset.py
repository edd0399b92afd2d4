"""Argoverse 2 preprocessed ``.h5`` scene dataset → static-shape frame pairs.

The port's own copy of ``deflow_tpu/data/h5dataset.py``.  Schema (one file
per scene, one group per lidar timestamp):

    <log_id>.h5
      └── <timestamp>/            (string keys, time-ordered)
            lidar                  [N, 3] f32   ego-frame points
            pose                   [4, 4] f64   ego→city
            ground_mask            [N]    bool  ground points (removable)
            flow                   [N, 3] f32   total gt flow  (labeled splits)
            flow_is_valid          [N]    bool
            flow_category_indices  [N]    uint8 AV2 category (0 = background)
            ego_motion             [4, 4] f64   pose_0to1 (precomputed)
            eval_mask              [N]    bool  official eval mask (val/test)
            dufo_label             [N]    uint8 SeFlow dynamic labels

A sample is a consecutive frame pair (t, t+1) within one scene; every
variable-length array is padded to ``max_points`` with a validity mask.

``h5py`` is imported only where a file is opened (``build_index`` and
``HDF5Dataset``), so the loader and ``collate`` run where it is absent, on
any list of sample dicts shaped like ``HDF5Dataset.__getitem__``'s.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deflow_tpu_torch.utils import native
from deflow_tpu_torch.utils.timer import span


@dataclass(frozen=True)
class FramePairIndex:
    scene_path: str
    scene_id: str
    timestamp0: str
    timestamp1: str


def build_index(data_dir: str) -> List[FramePairIndex]:
    """Scan a split directory of per-scene .h5 files into frame-pair indices."""
    import h5py

    pairs: List[FramePairIndex] = []
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(f"dataset split dir not found: {data_dir}")
    for fname in sorted(os.listdir(data_dir)):
        if not fname.endswith(".h5"):
            continue
        path = os.path.join(data_dir, fname)
        with h5py.File(path, "r") as f:
            # numeric sort: timestamps may not be zero-padded
            keys = sorted(f.keys(), key=int)
        for t0, t1 in zip(keys[:-1], keys[1:]):
            pairs.append(FramePairIndex(path, fname[:-len(".h5")], t0, t1))
    return pairs


def _read_frame(group) -> Dict[str, np.ndarray]:
    out = {"lidar": group["lidar"][:].astype(np.float32)[:, :3],
           "pose": group["pose"][:].astype(np.float32)}
    for key in ("ground_mask", "flow", "flow_is_valid",
                "flow_category_indices", "ego_motion", "eval_mask",
                "dufo_label"):
        if key in group:
            out[key] = group[key][:]
    return out


def pad_points(arr: np.ndarray, n: int,
               fill: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/crop the leading axis to n; returns (padded, mask)."""
    k = min(len(arr), n)
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:k] = arr[:k]
    mask = np.zeros(n, bool)
    mask[:k] = True
    return out, mask


class HDF5Dataset:
    """Frame-pair dataset with the reference's semantics.

    ``remove_ground`` drops ground points *before* padding.  Labeled splits
    carry per-point gt for pc0; val/test splits may carry the official
    ``eval_mask``.  ``submission_meta`` also carries the raw
    (pre-ground-removal, pre-crop) per-frame arrays the leaderboard writer
    needs (ragged, list-collated, host only).  ``num_frames > 2`` adds the
    preceding frames as ``pch{h}`` history.  The per-point selection runs in
    the C++ host ops (``utils.native.select_pad``).
    """

    def __init__(self, data_dir: str, max_points: int = 131072,
                 remove_ground: bool = True, with_labels: bool = True,
                 limit: int = 0, num_frames: int = 2,
                 submission_meta: bool = False):
        self.data_dir = data_dir
        self.max_points = max_points
        self.remove_ground = remove_ground
        self.with_labels = with_labels
        self.num_frames = num_frames
        self.submission_meta = submission_meta
        self.index = build_index(data_dir)
        if num_frames > 2:
            # keep only pairs with num_frames-2 preceding frames in the scene
            need = num_frames - 2
            by_scene: Dict[str, list] = {}
            for fp in self.index:
                by_scene.setdefault(fp.scene_path, []).append(fp)
            self.index = [fp for lst in by_scene.values() for fp in lst[need:]]
        if limit:
            self.index = self.index[:limit]
        self._files: Dict[str, object] = {}
        # threaded decode (DataLoader num_workers) shares this cache: the
        # lock prevents a duplicated open whose handle would leak past close()
        self._files_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.index)

    def _file(self, path: str):
        import h5py

        with self._files_lock:
            f = self._files.get(path)
            if f is None:
                f = h5py.File(path, "r")
                self._files[path] = f
            return f

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        idx = self.index[i]
        f = self._file(idx.scene_path)
        fr0 = _read_frame(f[idx.timestamp0])
        fr1 = _read_frame(f[idx.timestamp1])
        n = self.max_points

        def ground(fr):
            if self.remove_ground and "ground_mask" in fr:
                return fr["ground_mask"][:].astype(np.uint8)
            return None

        want_labels = self.with_labels and "flow" in fr0
        n0_raw = len(fr0["lidar"])
        flow0 = fr0["flow"].astype(np.float32) if want_labels else None
        cats0 = (fr0.get("flow_category_indices",
                         np.zeros(n0_raw, np.uint8)).astype(np.int32)
                 if want_labels else None)
        valid0 = (fr0.get("flow_is_valid", np.ones(n0_raw, bool)).astype(bool)
                  if want_labels else None)
        em0 = fr0["eval_mask"].astype(bool) if "eval_mask" in fr0 else None

        pc0, m0, flow_p, cats_p, valid_p, kept0 = native.select_pad(
            fr0["lidar"], ground(fr0), n, flow=flow0, labels=cats0, valid=valid0)
        pc1, m1, _, _, _, _ = native.select_pad(fr1["lidar"], ground(fr1), n)

        sample: Dict[str, np.ndarray] = {
            "pc0": pc0, "pc1": pc1,
            "pc0_mask": m0, "pc1_mask": m1,
            "pose0": fr0["pose"], "pose1": fr1["pose"],
            "scene_id": idx.scene_id, "timestamp": idx.timestamp0,
            "num_points0": np.int32(kept0),
        }
        if "ego_motion" in fr0:
            sample["ego_motion"] = fr0["ego_motion"][:].astype(np.float32)
        if want_labels:
            sample.update(flow=flow_p, flow_is_valid=valid_p & m0,
                          flow_category_indices=cats_p)
        if em0 is not None:
            _, _, _, _, em_p, _ = native.select_pad(
                fr0["lidar"], ground(fr0), n, valid=em0)
            sample["eval_mask"] = em_p & m0
        if self.submission_meta:
            g0 = ground(fr0)
            sample["raw_lidar"] = fr0["lidar"]
            sample["raw_ground_mask"] = (
                np.zeros(n0_raw, bool) if g0 is None else g0.astype(bool))
            sample["raw_eval_mask"] = (
                np.ones(n0_raw, bool) if em0 is None else em0)
            if "ego_motion" in fr0:
                em = fr0["ego_motion"][:]
            else:  # pose_0to1 from the two city poses (av2 convention)
                em = np.linalg.inv(fr1["pose"].astype(np.float64)) @ fr0[
                    "pose"].astype(np.float64)
            sample["raw_ego_motion"] = em.astype(np.float32)
        if self.num_frames > 2:
            # pch1 is the frame before pc0, pch2 the one before that, ...
            keys = sorted(f.keys(), key=int)
            pos = keys.index(idx.timestamp0)
            for hist in range(1, self.num_frames - 1):
                frh = _read_frame(f[keys[pos - hist]])
                pch, mh, *_ = native.select_pad(frh["lidar"], ground(frh), n)
                sample[f"pch{hist}"] = pch
                sample[f"pch{hist}_mask"] = mh
                sample[f"pose_pch{hist}"] = frh["pose"]
        for tag, fr in (("dufo_label0", fr0), ("dufo_label1", fr1)):
            if "dufo_label" in fr:
                _, _, _, lab, _, _ = native.select_pad(
                    fr["lidar"], ground(fr), n,
                    labels=fr["dufo_label"][:].astype(np.int32))
                sample[tag] = lab
        return sample

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


_STACK_KEYS = (
    "pc0", "pc1", "pc0_mask", "pc1_mask", "pose0", "pose1", "ego_motion",
    "flow", "flow_is_valid", "flow_category_indices", "eval_mask",
    "dufo_label0", "dufo_label1",
) + tuple(k for h in range(1, 17)
          for k in (f"pch{h}", f"pch{h}_mask", f"pose_pch{h}"))


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of padded samples into batch arrays (+ host-side meta)."""
    batch: Dict[str, np.ndarray] = {}
    for key in _STACK_KEYS:
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples])
    batch["scene_id"] = [s["scene_id"] for s in samples]
    batch["timestamp"] = [s["timestamp"] for s in samples]
    for key in samples[0]:
        if key.startswith("raw_"):  # ragged per-frame meta: list-collated
            batch[key] = [s[key] for s in samples]
    return batch


def pad_ragged_batch(host_batch: Dict[str, np.ndarray], n_dev: int) -> int:
    """Pad the final ragged batch to a multiple of ``n_dev`` by repeating the
    last row (array keys only; list-collated meta stays ragged — consumers
    iterate the true ``bsz``).  Returns the true (pre-pad) batch size."""
    bsz = len(host_batch["scene_id"])
    pad = (-bsz) % n_dev
    if pad:
        for k, v in list(host_batch.items()):
            if isinstance(v, np.ndarray):
                host_batch[k] = np.concatenate([v, v[-1:].repeat(pad, 0)])
    return bsz


def _bounded_put(q: "queue.Queue", item, abandoned: threading.Event) -> bool:
    """Put ``item`` unless the consumer has abandoned the iteration (then
    the producer thread can exit); True if it was put."""
    while not abandoned.is_set():
        try:
            q.put(item, timeout=0.25)
            return True
        except queue.Full:
            continue
    return False


def background(gen, depth: int):
    """Iterate ``gen`` (an iterator) in a background thread, ``depth`` items
    ahead.  An exception of ``gen`` reaches the consumer; a consumer that
    abandons the iteration stops the thread at its next put."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    abandoned = threading.Event()

    def worker():
        try:
            for item in gen:
                if not _bounded_put(q, (item, None), abandoned):
                    return
        except BaseException as e:      # handed to the consumer, re-raised there
            _bounded_put(q, (done, e), abandoned)
            return
        # the queue is typically full here (consumer slower than worker):
        # the end marker must still reach the consumer, or it blocks forever
        _bounded_put(q, (done, None), abandoned)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item, err = q.get()
            if err is not None:
                raise err
            if item is done:
                return
            yield item
    finally:
        abandoned.set()


class DataLoader:
    """Epoch iterator: shuffling, batching, ``drop_last``, a prefetch thread.

    The shuffle order of an epoch comes from ``default_rng(seed + epoch)``.
    ``post_collate`` (the host prep) runs in the prefetch thread, off the
    consumer's path; ``num_workers > 1`` decodes a batch's samples on
    ``utils.native.shared_pool`` (threads: the h5 reads and the C++
    ``select_pad`` release the GIL).  ``prefetch=0`` runs everything inline.
    An error in decode or ``post_collate`` reaches the consumer.  Each
    batch's decode and collate is the span ``deflow/loader/collate``, its
    ``post_collate`` the span ``deflow/loader/prep``.

    Data parallel (``world`` > 1): ``batch_size`` is the global batch.
    Every rank draws the same order and decodes (and preps) only its rows
    ``[rank·b, (rank + 1)·b)`` of each global batch, b = batch_size /
    world, so the ranks' rows together are the single-process batch, row
    for row.  A ragged last batch (``drop_last=False``) is first padded to
    a multiple of ``world`` by repeating its last sample, as
    :func:`pad_ragged_batch` pads it; each rank's batch then carries the
    global batch's true size under ``"global_size"``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 prefetch: int = 2, post_collate=None, num_workers: int = 0,
                 rank: int = 0, world: int = 1):
        if batch_size % world and (drop_last or (drop_last is None and shuffle)):
            raise ValueError(f"batch_size={batch_size} must divide evenly over "
                             f"{world} ranks")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world}")
        self.rank, self.world = rank, world
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        self.post_collate = post_collate
        self.num_workers = int(num_workers)
        self.epoch = 0

    def _decode(self, sel) -> list:
        if self.num_workers > 1 and len(sel) > 1:
            return list(native.shared_pool(self.num_workers).map(
                self.dataset.__getitem__, [int(i) for i in sel]))
        return [self.dataset[int(i)] for i in sel]

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1

        def gen():
            for start in range(0, len(order), self.batch_size):
                sel = order[start:start + self.batch_size]
                if self.drop_last and len(sel) < self.batch_size:
                    return
                size = len(sel)
                if self.world > 1:
                    sel = np.concatenate([sel, sel[-1:].repeat((-size) % self.world)])
                    b = len(sel) // self.world
                    sel = sel[self.rank * b:(self.rank + 1) * b]
                with span("deflow/loader/collate"):
                    batch = collate(self._decode(sel))
                if self.world > 1:
                    batch["global_size"] = size
                if self.post_collate is not None:
                    with span("deflow/loader/prep"):
                        batch = self.post_collate(batch)
                yield batch

        if self.prefetch <= 0:
            yield from gen()
        else:
            yield from background(gen(), self.prefetch)
