"""The port's C++ host ops (``deflow_tpu_torch/utils/native.py``) against
their numpy versions, bit for bit, and the C++ host prep against the JAX
package's.

Each wrapper is held bit for bit (same dtype, shape and bytes) to the
port's numpy version where the port has one (``data/host_prep.py``), else
to the numpy expression of what it computes.  ``attach_host_prep`` with the
C++ ops (one fused call a sample) is held bit for bit to its numpy backend
on every key, eval and SSL batches alike, over 4 threads and none, at
grids up to 1024², and to the JAX package's
``attach_host_prep(sort=True)`` at ``test_host_prep_matches_jax``'s bounds
(integer and mask keys exact, float keys atol 1e-5).
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu_torch import trainer
from deflow_tpu_torch.data import host_prep as hp
from deflow_tpu_torch.utils import native

from test_torch_host_prep import RANGE, make_host_batch

ROOT = Path(__file__).resolve().parents[1]
VMIN = np.asarray(RANGE[:3], np.float32)
GRIDS = {"s2d": (3.2, 3.2, 6.0), "row_major": (3.3, 3.2, 6.0),
         "z_bins": (0.8, 0.4, 0.7), "fine_1024": (0.1, 0.1, 6.0)}


def assert_bitwise(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        what, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def grid_of(voxel):
    vs = np.asarray(voxel, np.float32)
    return np.round((np.asarray(RANGE[3:], np.float32) - VMIN) / vs).astype(np.int32), vs


def cloud(rng, n, invalid_tail=0):
    """Points over and past the range, NaN padding in an invalid tail."""
    pts = np.stack([rng.uniform(-56, 56, n), rng.uniform(-56, 56, n),
                    rng.uniform(-3.5, 3.5, n)], -1).astype(np.float32)
    mask = rng.random(n) < 0.85
    if invalid_tail:
        pts[-invalid_tail:] = np.nan
        mask[-invalid_tail:] = False
    return pts, mask


def test_select_pad_matches_numpy():
    rng = np.random.default_rng(0)
    n = 5000
    pts = rng.normal(size=(n, 4)).astype(np.float32)    # the 4th lane is dropped
    ground = rng.random(n) < 0.2
    flow = rng.normal(size=(n, 3)).astype(np.float32)
    labels = rng.integers(0, 30, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    keep = np.flatnonzero(~ground)
    for m in (4096, 1000):                               # padded; cropped
        got = native.select_pad(pts, ground, m, flow=flow, labels=labels,
                                valid=valid)
        sel = keep[:m]
        pad = lambda a, dt: np.concatenate(
            [a[sel].astype(dt), np.zeros((m - len(sel),) + a.shape[1:], dt)])
        for g, w in zip(got[:5], (pad(pts[:, :3], np.float32),
                                  np.arange(m) < len(sel),
                                  pad(flow, np.float32), pad(labels, np.int32),
                                  pad(valid, bool))):
            assert_bitwise(g, w)
        assert got[5] == len(keep)
    # no ground mask, no payloads; every point on the ground
    p, msk, f, lab, v, kept = native.select_pad(pts, None, 64)
    assert_bitwise(p, pts[:64, :3])
    assert msk.all() and f is None and lab is None and v is None and kept == n
    p, msk, *_, kept = native.select_pad(pts, np.ones(n, bool), 64)
    assert not msk.any() and not p.any() and kept == 0


def test_se3_transform_matches_numpy():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-60, 60, (4000, 3)).astype(np.float32)
    pose = np.eye(4)
    a = 0.3
    pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    pose[:3, 3] = [1.3, -2.2, 0.7]
    assert_bitwise(native.se3_transform(pts, pose), hp.se3_transform(pts, pose))


def test_collate_points_matches_stack():
    rng = np.random.default_rng(2)
    clouds = [cloud(rng, 777) for _ in range(3)]
    pts, masks = native.collate_points([c[0] for c in clouds],
                                       [c[1] for c in clouds])
    assert_bitwise(pts, np.stack([c[0] for c in clouds]))
    assert_bitwise(masks, np.stack([c[1] for c in clouds]))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_bin_points_matches_numpy(grid):
    rng = np.random.default_rng(3)
    pts, _ = cloud(rng, 4096)
    g, vs = grid_of(GRIDS[grid])
    coords, ok = native.bin_points(pts, VMIN, vs, g)
    rel = np.floor((pts - VMIN) / vs)
    assert_bitwise(coords, rel.astype(np.int32))
    assert_bitwise(ok, ((rel >= 0) & (rel < g)).all(1))
    assert ok.any() and not ok.all()


def test_sort_by_id_matches_stable_argsort():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 65, 3000).astype(np.int32)
    ids[:40] = 64                                        # the trash id
    order, iperm, sid = native.sort_by_id(ids, 64)
    want = np.argsort(ids, kind="stable").astype(np.int32)
    assert_bitwise(order, want)
    assert_bitwise(sid, ids[want])
    assert_bitwise(iperm[want], np.arange(3000, dtype=np.int32))
    with pytest.raises(ValueError, match="out of range"):
        native.sort_by_id(np.array([0, 65], np.int32), 64)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_pillar_prep_and_record_match_numpy(grid):
    """Ragged masks, NaN padding, points past the range (the trash id
    ``W·H``) and an all-invalid cloud."""
    rng = np.random.default_rng(5)
    g, vs = grid_of(GRIDS[grid])
    assert native.use_s2d(g) == (grid != "row_major")
    pts, mask = cloud(rng, 5000, invalid_tail=300)
    for m in (mask, np.zeros_like(mask)):
        got = native.pillar_prep(pts, m, VMIN, vs, g)
        want = hp.pillar_prep(pts, m, VMIN, vs, g)
        for a, b, what in zip(got, want, ("pid", "order", "iperm", "sorted")):
            assert_bitwise(a, b, what)
        trash = int(g[0]) * int(g[1])
        assert (got[0] == trash).any() and (got[0][~m] == trash).all()
        assert_bitwise(native.sorted_record(pts, got[1], got[3], VMIN, vs, g),
                       hp.sorted_record(pts, want[1], want[3], VMIN, vs, g))
    assert (got[0] == trash).all()


@pytest.mark.parametrize("shape,dtype", [((900,), np.int32), ((900,), bool),
                                         ((900, 3), np.float32),
                                         ((900, 5, 2), np.float32)])
def test_permute_rows_matches_numpy(shape, dtype):
    rng = np.random.default_rng(6)
    a = rng.normal(size=shape).astype(dtype)
    order = rng.permutation(900).astype(np.int32)
    assert_bitwise(native.permute_rows(a, order), hp.permute_rows(a, order))
    with pytest.raises(ValueError, match="out of range"):
        native.permute_rows(a, np.array([0, 900], np.int32))


@pytest.mark.parametrize("cell", [2.0, 0.5])
def test_chamfer_cell_prep_matches_numpy(cell):
    """Masked rows take the per-sample sentinel kgap; points past ±51.2 m
    clip into the edge cells."""
    rng = np.random.default_rng(7)
    pts, mask = cloud(rng, 6000)
    flag = rng.random(6000) < 0.3
    got = native.chamfer_cell_prep(pts, mask, flag, cell=cell)
    want = hp.chamfer_cell_prep(pts, mask, flag, cell=cell)
    for k in ("lanes", "sid", "start"):
        assert_bitwise(got[k], want[k], k)
    kgap = len(want["start"]) - 1
    assert (got["sid"] == kgap).sum() == (~mask).sum() > 0


def _batches(voxel):
    eval_batch = make_host_batch(8, 4, 3000, voxel)
    ssl = make_host_batch(9, 4, 3000, voxel)
    rng = np.random.default_rng(10)
    for k in ("dufo_label0", "dufo_label1"):
        ssl[k] = (rng.random((4, 3000)) < 0.2).astype(np.int32)
    ssl["pc0_mask"][1] = False                          # an all-invalid cloud
    return {"eval": eval_batch, "ssl": ssl}


def _variant(hb, case, rng):
    """The batch of a case: ``b1`` its first sample alone, ``ego`` an
    ``ego_motion`` that the poses do not give, ``full`` every slot of both
    clouds valid and inside the range (no trash id)."""
    if case == "b1":
        return {k: v[:1] for k, v in hb.items()}
    if case == "ego":
        ego = np.tile(np.eye(4, dtype=np.float32), (len(hb["pc0"]), 1, 1))
        a = rng.uniform(-0.2, 0.2, len(ego))
        ego[:, 0, 0], ego[:, 0, 1] = np.cos(a), -np.sin(a)
        ego[:, 1, 0], ego[:, 1, 1] = np.sin(a), np.cos(a)
        ego[:, :3, 3] = rng.uniform(-1, 1, (len(ego), 3))
        return {**hb, "ego_motion": ego}
    if case == "full":
        for c in ("pc0", "pc1"):
            hb[c] = np.clip(hb[c], [-50.9, -50.9, -2.9], [50.9, 50.9, 2.9]).astype(np.float32)
            hb[f"{c}_mask"] = np.ones_like(hb[f"{c}_mask"])
        eye = np.tile(np.eye(4, dtype=np.float32), (len(hb["pc0"]), 1, 1))
        return {**hb, "pose0": eye, "pose1": eye.copy()}
    return hb


# (grid, kind, case): every grid of eval and SSL batches of 4 over 4 threads
# with ego motion from the poses, then the 512² and 1024² s2d grids with one
# thing changed: no pool, a batch of 1, a given ego_motion, every slot valid
ATTACH_CASES = ([(g, k, "") for g in sorted(GRIDS) for k in ("eval", "ssl")]
                + [(g, k, c) for g in ("s2d", "fine_1024") for k in ("eval", "ssl")
                   for c in ("workers0", "b1", "ego", "full")])


@pytest.mark.parametrize("grid,kind,case", ATTACH_CASES,
                         ids=["-".join(filter(None, c)) for c in ATTACH_CASES])
def test_attach_host_prep_native_matches_numpy(grid, kind, case):
    hb = _variant(_batches(GRIDS[grid])[kind], case, np.random.default_rng(11))
    want = hp.attach_host_prep(copy.deepcopy(hb), list(GRIDS[grid]), RANGE,
                               backend="numpy")
    got = hp.attach_host_prep(copy.deepcopy(hb), list(GRIDS[grid]), RANGE,
                              num_workers=0 if case == "workers0" else 4)
    assert list(got) == list(want)
    assert ("pc1_cell_lanes" in got) == (kind == "ssl")
    if case == "full":
        trash = np.prod(grid_of(GRIDS[grid])[0][:2])
        assert (got["pc0_sorted"] < trash).all() and (got["pc1_sorted"] < trash).all()
    for k in want:
        assert_bitwise(got[k], want[k], k)
    moved = trainer.SSL_TRAIN_KEYS if kind == "ssl" else trainer.TRAIN_KEYS
    for k in set(moved) & set(got):
        assert got[k].flags.c_contiguous, k


def test_fused_samples_counts_native_calls():
    """One fused call a sample under the C++ backend, none under numpy."""
    hb = _batches(GRIDS["s2d"])["ssl"]
    for backend, workers, grows in (("native", 4, 4), ("native", 0, 4),
                                    ("numpy", 4, 0)):
        before = hp.attach_host_prep.fused_samples
        hp.attach_host_prep(copy.deepcopy(hb), list(GRIDS["s2d"]), RANGE,
                            num_workers=workers, backend=backend)
        assert hp.attach_host_prep.fused_samples - before == grows, backend
    before = hp.attach_host_prep.fused_samples
    hp.attach_host_prep({k: v[:1] for k, v in hb.items()}, list(GRIDS["s2d"]),
                        RANGE)
    assert hp.attach_host_prep.fused_samples - before == 1


def test_native_host_prep_refuses_other_clouds():
    """The fused call reads float32 clouds of at least 3 lanes a row."""
    hb = _batches(GRIDS["s2d"])["eval"]
    for bad in (hb["pc1"].astype(np.float64), hb["pc1"][..., :2]):
        with pytest.raises(ValueError, match="pc1 must be"):
            hp.attach_host_prep({**hb, "pc1": bad}, list(GRIDS["s2d"]), RANGE)


@pytest.mark.parametrize("grid", ["s2d", "row_major"])
def test_attach_host_prep_native_matches_jax(grid):
    voxel = list(GRIDS[grid])
    hb = _batches(GRIDS[grid])["ssl"]
    want = jax_attach(copy.deepcopy(hb), voxel, RANGE, sort=True)
    got = hp.attach_host_prep(copy.deepcopy(hb), voxel, RANGE, num_workers=4)
    assert got.keys() == want.keys()
    for k in got:
        if k in ("pc0_transformed", "pc0_sorted_rec", "pc1_sorted_rec"):
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="backend"):
        hp.attach_host_prep(make_host_batch(0, 1, 10, GRIDS["s2d"]),
                            list(GRIDS["s2d"]), RANGE, backend="cuda")


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        native.se3_transform(np.zeros((4, 3), np.float32), np.eye(4))
    assert not list(tmp_path.glob("libpointops.so*"))


def test_stale_library_is_rebuilt(monkeypatch, tmp_path):
    src = tmp_path / "pointops.cpp"
    src.write_text(native.SOURCE.read_text())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    lib = native.build()
    first = lib.stat().st_mtime_ns
    assert native.build().stat().st_mtime_ns == first          # up to date
    os.utime(src, ns=(first + 10 ** 9, first + 10 ** 9))
    assert native.build().stat().st_mtime_ns != first          # rebuilt


def test_concurrent_builds_share_one_library(tmp_path):
    """Processes that build at the same moment (pytest -n 6) each get a
    whole library: a file lock, a temporary name and a rename."""
    code = ("import sys, numpy as np; from pathlib import Path; "
            "from deflow_tpu_torch.utils import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); "
            "print(native.se3_transform(np.ones((2, 3), np.float32), np.eye(4)).sum())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert [o.strip() for o, _ in outs] == ["6.0"] * 4
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "libpointops.lock", "libpointops.so"]


def test_shared_pool_grows_without_breaking_a_pool_in_use():
    """A thread that took the pool before another asked for a larger one
    can still submit to it."""
    small = native.shared_pool(2)
    large = native.shared_pool(native._POOL_SIZE + 1)
    assert large is not small and native.shared_pool(1) is large
    assert list(small.map(lambda i: i * i, range(4))) == [0, 1, 4, 9]
