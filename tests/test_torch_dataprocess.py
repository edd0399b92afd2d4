"""The port's ``dataprocess`` against the JAX package on the CPU: the DUFO
labeller (``label_frames`` / ``label_scene`` / the CLI) against
``deflow_tpu.dataprocess.process`` on ``make_scene`` scenes, and the AV2
extractor on the raw-log fixture of ``tests/test_extract_av2.py``.

Tolerances: the labels are equal, except where a point's f32 city-frame
coordinate lies within 1e-5 m of a voxel face (the f64 pose transform may
round otherwise in another BLAS), and at most 1e-4 of the points differ; the
extracted ``.h5`` files are equal array for array.
"""

import os
import shutil

import h5py
import numpy as np
import pytest

from deflow_tpu.data import make_scene
from deflow_tpu.dataprocess import process as JP
from deflow_tpu_torch.dataprocess import process as TP

from test_extract_av2 import _write_raw_log
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _frames(path):
    with h5py.File(path, "r") as f:
        out = []
        for t in sorted(f.keys(), key=int):
            g = f[t]
            fr = {"lidar": g["lidar"][:], "pose": g["pose"][:]}
            if "ground_mask" in g:
                fr["ground_mask"] = g["ground_mask"][:].astype(bool)
            out.append(fr)
        return out


def _labels(path):
    with h5py.File(path, "r") as f:
        return [f[t]["dufo_label"][:] for t in sorted(f.keys(), key=int)]


def _hold_labels(got, want, frames, voxel=TP.VOXEL):
    diff, total = 0, 0
    for g, w, fr in zip(got, want, frames):
        assert g.dtype == np.uint8 and g.shape == w.shape
        bad = g != w
        if bad.any():
            pc = fr["lidar"][:, :3].astype(np.float64)
            city = (pc @ fr["pose"][:3, :3].T + fr["pose"][:3, 3]).astype(np.float32)
            q = city[bad] / np.float32(voxel)
            face = np.abs(q - np.round(q)).min(-1) * voxel
            assert (face < 1e-5).all(), face.max()
        diff += int(bad.sum())
        total += len(g)
    assert diff <= 1e-4 * total
    return diff


@pytest.mark.parametrize("window", [4, 10])
def test_label_scene_matches_jax(tmp_path, window):
    """``label_scene`` (and ``label_frames`` on the same frames) against the
    JAX package's numpy labeller; the returned frame count and dynamic
    fraction too."""
    ref = make_scene(str(tmp_path / "ref.h5"), num_frames=8, points_per_frame=4096,
                     labeled=True, seed=3)
    port = str(tmp_path / "port.h5")
    shutil.copy(ref, port)
    want = JP.label_scene(ref, window=window)
    got = TP.label_scene(port, window=window, device="cpu")
    frames = _frames(port)
    assert got[0] == want[0] == 8
    _hold_labels(_labels(port), _labels(ref), frames)
    assert got[1] == pytest.approx(want[1], abs=1e-4)
    assert 0.0 < got[1] < 0.5
    direct = TP.label_frames(frames, window=window, device="cpu")
    for a, b in zip(direct, _labels(port)):
        np.testing.assert_array_equal(a, b)


def test_ray_free_keys_match_jax():
    """The free-space keys of one frame's rays, chunked below the sample
    count, against the numpy labeller's: the same sorted set."""
    import torch

    rng = np.random.default_rng(4)
    pts = rng.uniform(-40, 40, (3000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1, 3, 3000)
    origin = np.array([3.25, -1.7, 1.9])
    want = JP._ray_free_keys(origin, pts, JP.VOXEL, JP.RAY_STEP, chunk=50_000)
    got = TP._ray_free_keys(torch.from_numpy(origin), torch.from_numpy(pts), TP.VOXEL,
                            TP.RAY_STEP, chunk=50_000)
    assert len(want) > 100_000
    np.testing.assert_array_equal(got.numpy(), want)


def test_dufo_labels_moving_actor(tmp_path):
    """``tests/test_dufo.py``'s check on the port: moving actors are
    flagged far more often than the static world."""
    path = make_scene(str(tmp_path / "scene.h5"), num_frames=6,
                      points_per_frame=4096, labeled=True, seed=3)
    TP.label_scene(path, window=6, device="cpu")
    with h5py.File(path, "r") as f:
        hits = []
        for t in sorted(f.keys(), key=int):
            g = f[t]
            lab = g["dufo_label"][:]
            assert lab.shape[0] == g["lidar"].shape[0]
            cats = g["flow_category_indices"][:] if "flow_category_indices" in g else None
            if cats is not None:
                hits.append((lab[cats > 0].mean(), lab[cats == 0].mean()))
    fg, bg = np.mean([h[0] for h in hits]), np.mean([h[1] for h in hits])
    assert fg > 0.3, f"foreground dynamic rate too low: {fg}"
    assert bg < 0.15, f"background false-positive rate too high: {bg}"


def test_process_cli_sharding(tmp_path, capsys):
    """``--scene_range`` / ``--interval`` shard as the JAX package's CLI
    does (``tests/test_dufo.py``), on ``--device cpu``; without a card and
    without ``--device cpu`` the CLI raises."""
    for i in range(3):
        make_scene(str(tmp_path / f"s{i}.h5"), num_frames=3,
                   points_per_frame=512, labeled=False, seed=i)
    TP.main(["--data_dir", str(tmp_path), "--scene_range", "0,-1",
             "--interval", "2", "--window", "3", "--device", "cpu"])
    labeled = []
    for i in range(3):
        with h5py.File(str(tmp_path / f"s{i}.h5"), "r") as f:
            labeled.append("dufo_label" in f[sorted(f.keys())[0]])
    assert labeled == [True, False, True]
    out = capsys.readouterr().out
    assert "DUFO labeling 2 scenes [0:3:2] on cpu" in out and "dynamic fraction" in out
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.main(["--data_dir", str(tmp_path)])


def test_extract_av2_matches_jax(tmp_path):
    """The port's host copy of ``extract_av2`` writes the JAX package's
    ``.h5`` files, array for array, on the fixture's raw AV2 log."""
    from deflow_tpu.dataprocess.extract_av2 import main as jax_main
    from deflow_tpu_torch.dataprocess.extract_av2 import main as port_main

    argo = tmp_path / "argo"
    _write_raw_log(str(argo / "sensor" / "val" / "log0001"))
    outs = []
    for name, fn in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / name
        fn(["--argo_dir", str(argo), "--output_dir", str(out), "--data_mode", "val",
            "--nproc", "1"])
        outs.append(str(out / "val" / "log0001.h5"))
    with h5py.File(outs[0], "r") as a, h5py.File(outs[1], "r") as b:
        assert sorted(a.keys()) == sorted(b.keys()) and len(a.keys()) == 3
        for t in a.keys():
            assert sorted(a[t].keys()) == sorted(b[t].keys())
            for k in a[t].keys():
                np.testing.assert_array_equal(b[t][k][:], a[t][k][:], err_msg=f"{t}/{k}")
        assert "flow" in a[sorted(a.keys())[0]]
