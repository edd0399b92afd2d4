"""Synthetic AV2-schema scene generator.

The port's own copy of ``deflow_tpu/data/synthetic.py``: the same schema and
the same seeds, so one seed writes the same arrays.  A rigid "world" of
background points plus a few moving boxes, written in the ``.h5`` schema of
``h5dataset.py`` with consistent poses, total gt flow, category indices,
ground masks and DUFO labels, so the eval and save paths run the code they
would run on real AV2.  ``h5py`` is imported by the writer only.
"""

from __future__ import annotations

import os

import numpy as np


def _pose_at(t: float) -> np.ndarray:
    """Smooth ego trajectory: slow arc in the city frame."""
    pose = np.eye(4, dtype=np.float64)
    yaw = 0.02 * t
    c, s = np.cos(yaw), np.sin(yaw)
    pose[:2, :2] = [[c, -s], [s, c]]
    pose[0, 3] = 2.0 * t
    pose[1, 3] = 0.1 * t
    return pose


def make_scene(
    path: str,
    num_frames: int = 6,
    points_per_frame: int = 8192,
    labeled: bool = True,
    with_eval_mask: bool = False,
    seed: int = 0,
) -> str:
    import h5py

    rng = np.random.default_rng(seed)

    # static world geometry in city frame
    n_bg = int(points_per_frame * 0.8)
    bg_city = rng.uniform(-45, 45, size=(n_bg, 3))
    bg_city[:, 2] = rng.uniform(0.2, 2.5, size=n_bg)
    n_ground = int(points_per_frame * 0.1)
    ground_city = rng.uniform(-45, 45, size=(n_ground, 3))
    ground_city[:, 2] = rng.uniform(-0.2, 0.05, size=n_ground)

    # moving actors: boxes with constant city-frame velocity
    actors = []
    for k in range(3):
        n_a = (points_per_frame - n_bg - n_ground) // 3
        center = rng.uniform(-30, 30, size=3)
        center[2] = 1.0
        pts = center + rng.uniform(-1.5, 1.5, size=(n_a, 3)) * [1, 0.5, 0.4]
        vel = rng.uniform(-8, 8, size=3)
        vel[2] = 0.0
        cat = [19, 17, 3][k]  # REGULAR_VEHICLE, PEDESTRIAN, BICYCLE
        actors.append((pts, vel, cat))

    dt = 0.1
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for fi in range(num_frames):
            t = fi * dt
            pose = _pose_at(t)             # ego→city
            city_pts = [bg_city, ground_city] + [
                pts + vel * t for pts, vel, _ in actors
            ]
            cats = np.concatenate(
                [np.zeros(len(bg_city), np.uint8),
                 np.zeros(len(ground_city), np.uint8)]
                + [np.full(len(a[0]), a[2], np.uint8) for a in actors]
            )
            ground = np.concatenate(
                [np.zeros(len(bg_city), bool), np.ones(len(ground_city), bool)]
                + [np.zeros(len(a[0]), bool) for a in actors]
            )
            city = np.concatenate(city_pts)
            inv = np.linalg.inv(pose)
            ego = city @ inv[:3, :3].T + inv[:3, 3]

            group = f.create_group(str(1_000_000_000 + fi))
            group.create_dataset("lidar", data=ego.astype(np.float32))
            group.create_dataset("pose", data=pose)
            group.create_dataset("ground_mask", data=ground)
            if labeled:
                # ground-truth dynamics as DUFO labels (what dataprocess/
                # process.py would compute; schema: uint8, 1 = dynamic) so
                # SeFlow-style SSL training runs on synthetic splits without
                # a labelling pass.  Unlabeled scenes stay raw so the
                # process.py CLI tests exercise the real labelling pass.
                dufo = np.concatenate(
                    [np.zeros(len(bg_city) + len(ground_city), np.uint8)]
                    + [np.full(len(a[0]),
                               np.uint8(np.linalg.norm(a[1][:2]) > 0.5),
                               np.uint8) for a in actors])
                group.create_dataset("dufo_label", data=dufo)

            if labeled and fi + 1 < num_frames:
                t1 = (fi + 1) * dt
                pose1 = _pose_at(t1)
                city1 = np.concatenate(
                    [bg_city, ground_city]
                    + [pts + vel * t1 for pts, vel, _ in actors]
                )
                # AV2 convention (av2 api compute_flow): total gt flow =
                # the point's t1 position expressed in the *ego1* frame minus
                # its t0 position in the ego0 frame, so static background flow
                # equals the rigid ego flow (pose_0to1 ∘ p0 − p0).
                inv1 = np.linalg.inv(pose1)
                p_t1_in_ego1 = city1 @ inv1[:3, :3].T + inv1[:3, 3]
                flow = (p_t1_in_ego1 - ego).astype(np.float32)
                group.create_dataset("flow", data=flow)
                group.create_dataset(
                    "flow_is_valid", data=np.ones(len(ego), bool))
                group.create_dataset("flow_category_indices", data=cats)
                ego_motion = np.linalg.inv(pose1) @ pose  # pose_0to1
                group.create_dataset("ego_motion", data=ego_motion)
            if with_eval_mask:
                em = (np.abs(ego[:, :2]) < 35).all(axis=1)
                group.create_dataset("eval_mask", data=em)
    return path


def make_split(
    root: str, split: str = "train", num_scenes: int = 1, seed: int = 0, **kw
) -> str:
    split_dir = os.path.join(root, split)
    os.makedirs(split_dir, exist_ok=True)
    for i in range(num_scenes):
        make_scene(os.path.join(split_dir, f"synthetic_{seed + i:04d}.h5"),
                   seed=seed + i, **kw)
    return split_dir
