"""The port's data pipeline against the JAX package's.

``make_scene`` writes the same arrays for the same seed; ``HDF5Dataset``
samples, ``collate``, ``pad_ragged_batch`` and the ``DataLoader``'s batch
order (shuffled and not, ``drop_last``, threaded decode) equal the JAX
package's bit for bit.  ``trainer.device_prefetch`` on the CPU yields the
loader's batches in order, raises the loader's error and stops its thread
when the consumer abandons it.
"""

import os
import threading
import time

import h5py
import numpy as np
import pytest
import torch

from deflow_tpu.data import DataLoader as JaxDataLoader
from deflow_tpu.data import HDF5Dataset as JaxHDF5Dataset
from deflow_tpu.data import collate as jax_collate
from deflow_tpu.data import make_split as jax_make_split
from deflow_tpu.data.h5dataset import pad_ragged_batch as jax_pad_ragged_batch
from deflow_tpu_torch.data.h5dataset import (DataLoader, HDF5Dataset, build_index,
                                             collate, pad_points, pad_ragged_batch)
from deflow_tpu_torch.data.synthetic import make_split
from deflow_tpu_torch.trainer import MODEL_KEYS, device_batch, device_prefetch
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def assert_same(got, want, what=""):
    """Same keys; arrays of the same dtype, shape and bytes; other values equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert (got.dtype, got.shape) == (want.dtype, want.shape), what
        assert got.tobytes() == want.tobytes(), what
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        assert type(got) is type(want) and got == want, what


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """The same two labeled scenes (4 frames, 2,048 points) written by the
    port and by the JAX package; and an unlabeled test scene."""
    port = tmp_path_factory.mktemp("port")
    ref = tmp_path_factory.mktemp("jax")
    kw = dict(num_scenes=2, num_frames=4, points_per_frame=2048, labeled=True,
              with_eval_mask=True, seed=3)
    return {"port": make_split(str(port), "val", **kw),
            "jax": jax_make_split(str(ref), "val", **kw),
            "test": make_split(str(port), "test", num_scenes=1, num_frames=3,
                               points_per_frame=900, labeled=False,
                               with_eval_mask=True)}


def _read(path):
    with h5py.File(path, "r") as f:
        return {ts: {k: f[ts][k][:] for k in f[ts]} for ts in f}


def test_make_scene_matches_jax(splits):
    pairs = lambda d: [(p.scene_id, p.timestamp0, p.timestamp1)
                       for p in build_index(d)]
    assert pairs(splits["port"]) == pairs(splits["jax"])
    assert len(pairs(splits["port"])) == 6
    for fname in sorted(os.listdir(splits["port"])):
        got = _read(os.path.join(splits["port"], fname))
        want = _read(os.path.join(splits["jax"], fname))
        assert_same(got, want, fname)
        assert "dufo_label" in next(iter(got.values()))


@pytest.mark.parametrize("opts", [
    {},
    {"remove_ground": False},
    {"max_points": 700},                                 # a crop
    {"with_labels": False, "submission_meta": True, "max_points": 700},
    {"num_frames": 3, "limit": 3},
], ids=["labeled", "with_ground", "crop", "submission", "history"])
def test_hdf5_dataset_matches_jax(splits, opts):
    kw = {"max_points": 2048, **opts}
    ds, ref = HDF5Dataset(splits["port"], **kw), JaxHDF5Dataset(splits["port"], **kw)
    assert len(ds) == len(ref) > 0
    for i in range(len(ds)):
        assert_same(ds[i], ref[i], f"sample {i}")
    ds.close()
    ref.close()


def test_test_split_sample_matches_jax(splits):
    ds = HDF5Dataset(splits["test"], max_points=512, with_labels=False,
                     submission_meta=True)
    ref = JaxHDF5Dataset(splits["test"], max_points=512, with_labels=False,
                         submission_meta=True)
    assert_same(ds[1], ref[1])
    assert "flow" not in ds[1] and "raw_lidar" in ds[1]
    ds.close()
    ref.close()


def test_collate_and_pad_ragged_batch_match_jax(splits):
    ds = HDF5Dataset(splits["port"], max_points=1024, submission_meta=True)
    samples = [ds[i] for i in (0, 4, 2)]
    got, want = collate(samples), jax_collate(samples)
    assert_same(got, want)
    assert got["raw_lidar"][1] is samples[1]["raw_lidar"]
    assert pad_ragged_batch(got, 4) == jax_pad_ragged_batch(want, 4) == 3
    assert_same(got, want)
    assert got["pc0"].shape[0] == 4 and len(got["scene_id"]) == 3
    out, mask = pad_points(np.arange(6.0).reshape(3, 2), 5, fill=-1.0)
    assert out[3:].min() == -1.0 and mask.tolist() == [1, 1, 1, 0, 0]
    ds.close()


@pytest.mark.parametrize("shuffle,drop_last,workers,prefetch", [
    (False, False, 0, 2), (True, None, 0, 2), (True, False, 3, 0),
    (False, True, 3, 1)])
def test_loader_order_matches_jax(splits, shuffle, drop_last, workers, prefetch):
    """Two epochs of batches of 4 over 6 pairs: the same samples in the
    same order (default_rng(seed + epoch)), the same ragged or dropped
    tail."""
    ds = HDF5Dataset(splits["port"], max_points=512)
    ref = JaxHDF5Dataset(splits["port"], max_points=512)
    kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last, prefetch=prefetch,
              num_workers=workers)
    loader, ref_loader = DataLoader(ds, 4, **kw), JaxDataLoader(ref, 4, **kw)
    assert len(loader) == len(ref_loader)
    for epoch in range(2):
        got, want = list(loader), list(ref_loader)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            assert_same(g, w, f"epoch {epoch}")
    ds.close()
    ref.close()


def test_loader_raises_post_collate_error(splits):
    ds = HDF5Dataset(splits["port"], max_points=256)

    for prefetch in (0, 2):
        seen = []

        def fail_on_second(batch):
            seen.append(batch)
            if len(seen) == 2:
                raise KeyError("post_collate failed")
            return batch

        it = iter(DataLoader(ds, 2, prefetch=prefetch, post_collate=fail_on_second))
        next(it)
        with pytest.raises(KeyError, match="post_collate failed"):
            next(it)
    ds.close()


def _samples(n=6, points=300, seed=0):
    """In-memory samples shaped like ``HDF5Dataset.__getitem__``'s."""
    rng = np.random.default_rng(seed)
    return [{"pc0": rng.normal(size=(points, 3)).astype(np.float32),
             "pc1": rng.normal(size=(points, 3)).astype(np.float32),
             "pc0_mask": rng.random(points) < 0.9,
             "pc1_mask": rng.random(points) < 0.9,
             "pose0": np.eye(4, dtype=np.float32),
             "pose1": np.eye(4, dtype=np.float32),
             "scene_id": "s", "timestamp": str(i)} for i in range(n)]


def test_device_prefetch_cpu_yields_loader_batches_in_order():
    loader = DataLoader(_samples(), 2, shuffle=True, seed=1)
    serial = [(hb, device_batch(hb, "cpu")) for hb in loader]
    loader.epoch = 0
    got = list(device_prefetch(loader, "cpu", depth=1))
    assert len(got) == len(serial) == 3
    for (hs, ds_), (hp, dp) in zip(serial, got):
        assert hs["timestamp"] == hp["timestamp"]
        assert ds_.keys() == dp.keys() == {k for k in MODEL_KEYS if k in hs}
        for k in ds_:
            assert dp[k].device.type == "cpu"
            assert torch.equal(ds_[k], dp[k])


def test_device_prefetch_raises_loader_error():
    def loader():
        yield from DataLoader(_samples(4), 2, prefetch=0)
        raise OSError("decode failed")

    it = device_prefetch(loader(), "cpu")
    assert len(list(zip(range(2), it))) == 2
    with pytest.raises(OSError, match="decode failed"):
        next(it)


def test_device_prefetch_stops_when_abandoned():
    produced = []

    def loader():
        for hb in DataLoader(_samples(40, points=64), 1, prefetch=0):
            produced.append(hb["timestamp"])
            yield hb

    before = threading.active_count()
    it = device_prefetch(loader(), "cpu", depth=2)
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert len(produced) < 40
