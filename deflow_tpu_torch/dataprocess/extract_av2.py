"""AV2 sensor raw → per-scene ``.h5`` preprocessing, on the host.

The port's copy of ``deflow_tpu/dataprocess/extract_av2.py`` (the
reference's ``dataprocess/extract_av2.py``, invoked at reference
assets/slurm/0_process.sh:17-35; README.md:48-57): reads the official
Argoverse 2 sensor-dataset directory layout directly with pyarrow (no av2-api
dependency), computes per-frame ground masks, rigid ego motion, and — for
labeled splits — per-point total scene flow + category indices from the
cuboid annotations, then writes the ``.h5`` schema consumed by
``deflow_tpu_torch.data.h5dataset.HDF5Dataset``.  Its work is file
conversion with pyarrow and numpy, so it runs on the host; it writes the
same files as the JAX package's (``tests/test_torch_extract_av2.py``).

    python -m deflow_tpu_torch.dataprocess.extract_av2 --nproc 64
        --av2_type sensor --data_mode train --argo_dir ... --output_dir ...
        [--mask_dir .../3d_scene_flow]

AV2 raw layout read here (public sensor-dataset format):
    <argo_dir>/<av2_type>/<split>/<log_id>/
        city_SE3_egovehicle.feather      timestamp_ns + quaternion + translation
        sensors/lidar/<t_ns>.feather     x, y, z, intensity, ...
        annotations.feather              per-cuboid pose/size/category/timestamps
        map/<...>_ground_height_surface____*.npy  + *img_Sim2_city.json
    <mask_dir>/<split>/<log_id>/<t_ns>.feather    official eval masks (val/test)

Flow definition (matches the official AV2 scene-flow labels and
``deflow_tpu_torch.data.synthetic``): for a pc0 point p (ego0 frame), its
flow is the position of the same physical point at t1 *in the ego1 frame*
minus p.  Background points move rigidly with ego motion; points inside an
annotated cuboid follow the cuboid's city-frame motion; points whose cuboid
vanishes at t1 get ``flow_is_valid=False``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
from typing import Dict, Optional, Tuple

import numpy as np

from deflow_tpu_torch.metrics.bucketed import AV2_CATEGORIES

_CAT_TO_INDEX = {c: i for i, c in enumerate(AV2_CATEGORIES)}
GROUND_HEIGHT_TOLERANCE_M = 0.3


# ---------------------------------------------------------------- SE3 helpers
def quat_to_rot(qw, qx, qy, qz) -> np.ndarray:
    """Quaternion (scalar-first, AV2 convention) → rotation matrices [..., 3, 3]."""
    q = np.stack([qw, qx, qy, qz], axis=-1).astype(np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = np.empty(q.shape[:-1] + (3, 3))
    rot[..., 0, 0] = 1 - 2 * (y * y + z * z)
    rot[..., 0, 1] = 2 * (x * y - w * z)
    rot[..., 0, 2] = 2 * (x * z + w * y)
    rot[..., 1, 0] = 2 * (x * y + w * z)
    rot[..., 1, 1] = 1 - 2 * (x * x + z * z)
    rot[..., 1, 2] = 2 * (y * z - w * x)
    rot[..., 2, 0] = 2 * (x * z - w * y)
    rot[..., 2, 1] = 2 * (y * z + w * x)
    rot[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return rot


def make_se3(rot: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = np.tile(np.eye(4), rot.shape[:-2] + (1, 1))
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    return out


def apply_se3(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ pose[:3, :3].T + pose[:3, 3]


# ---------------------------------------------------------------- raw readers
def read_poses(log_dir: str) -> Dict[int, np.ndarray]:
    import pyarrow.feather as feather

    df = feather.read_feather(os.path.join(log_dir, "city_SE3_egovehicle.feather"))
    rot = quat_to_rot(df["qw"].to_numpy(), df["qx"].to_numpy(),
                      df["qy"].to_numpy(), df["qz"].to_numpy())
    trans = np.stack([df["tx_m"], df["ty_m"], df["tz_m"]], axis=-1)
    ts = df["timestamp_ns"].to_numpy()
    return {int(t): make_se3(rot[i], trans[i]) for i, t in enumerate(ts)}


def read_lidar(log_dir: str, t_ns: int) -> np.ndarray:
    import pyarrow.feather as feather

    df = feather.read_feather(
        os.path.join(log_dir, "sensors", "lidar", f"{t_ns}.feather"))
    return np.stack([df["x"], df["y"], df["z"]], axis=-1).astype(np.float32)


def lidar_timestamps(log_dir: str):
    d = os.path.join(log_dir, "sensors", "lidar")
    return sorted(int(f[:-len(".feather")]) for f in os.listdir(d)
                  if f.endswith(".feather"))


def read_annotations(log_dir: str):
    """Returns {timestamp_ns: {track_uuid: (city_SE3_obj? no — ego_SE3_obj,
    dims, category)}}; AV2 cuboid poses are in the ego frame at t."""
    import pyarrow.feather as feather

    path = os.path.join(log_dir, "annotations.feather")
    if not os.path.exists(path):
        return {}
    df = feather.read_feather(path)
    rot = quat_to_rot(df["qw"].to_numpy(), df["qx"].to_numpy(),
                      df["qy"].to_numpy(), df["qz"].to_numpy())
    trans = np.stack([df["tx_m"], df["ty_m"], df["tz_m"]], axis=-1)
    dims = np.stack([df["length_m"], df["width_m"], df["height_m"]], axis=-1)
    out: Dict[int, Dict[str, Tuple[np.ndarray, np.ndarray, str]]] = {}
    ts = df["timestamp_ns"].to_numpy()
    uuids = df["track_uuid"].to_numpy()
    cats = df["category"].to_numpy()
    for i in range(len(df)):
        out.setdefault(int(ts[i]), {})[str(uuids[i])] = (
            make_se3(rot[i], trans[i]), dims[i], str(cats[i]))
    return out


class GroundHeightMap:
    """AV2 HD-map ground-height raster lookup (av2 map api semantics):
    a point is ground iff |z − raster_height(x, y)| ≤ 0.3 m (city frame)."""

    def __init__(self, map_dir: str):
        self.height = None
        self.scale = 1.0
        self.offset = np.zeros(2)
        if not os.path.isdir(map_dir):
            return
        npy = [f for f in os.listdir(map_dir)
               if f.endswith(".npy") and "ground_height" in f]
        sim2 = [f for f in os.listdir(map_dir)
                if f.endswith(".json") and "img_Sim2_city" in f]
        if not npy or not sim2:
            return
        self.height = np.load(os.path.join(map_dir, npy[0]))
        with open(os.path.join(map_dir, sim2[0])) as f:
            params = json.load(f)
        # av2 Sim2 json: {"R": [4], "t": [2], "s": float}; city → image px
        self.rot2 = np.asarray(params["R"], dtype=np.float64).reshape(2, 2)
        self.offset = np.asarray(params["t"], dtype=np.float64)
        self.scale = float(params["s"])

    def is_ground(self, city_pts: np.ndarray) -> np.ndarray:
        if self.height is None:
            return np.zeros(len(city_pts), bool)
        uv = (city_pts[:, :2] @ self.rot2.T + self.offset) * self.scale
        col = np.clip(uv[:, 0].astype(np.int64), 0, self.height.shape[1] - 1)
        row = np.clip(uv[:, 1].astype(np.int64), 0, self.height.shape[0] - 1)
        ground_z = self.height[row, col]
        valid = np.isfinite(ground_z)
        return valid & (np.abs(city_pts[:, 2] - ground_z) <= GROUND_HEIGHT_TOLERANCE_M)


def points_in_cuboid(pts_ego: np.ndarray, ego_SE3_obj: np.ndarray,
                     dims: np.ndarray) -> np.ndarray:
    """Boolean mask of ego-frame points inside an oriented cuboid."""
    inv = np.eye(4)
    rot_t = ego_SE3_obj[:3, :3].T
    inv[:3, :3] = rot_t
    inv[:3, 3] = -rot_t @ ego_SE3_obj[:3, 3]
    local = apply_se3(inv, pts_ego)
    half = dims / 2.0
    return (np.abs(local) <= half).all(axis=1)


# ---------------------------------------------------------------- flow labels
def compute_flow(
    pc0: np.ndarray,
    ego1_SE3_ego0: np.ndarray,
    annos0: Dict[str, Tuple[np.ndarray, np.ndarray, str]],
    annos1: Dict[str, Tuple[np.ndarray, np.ndarray, str]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-point (flow, valid, category) for pc0, official AV2 semantics."""
    flow = apply_se3(ego1_SE3_ego0, pc0) - pc0  # rigid background default
    valid = np.ones(len(pc0), bool)
    cats = np.zeros(len(pc0), np.uint8)

    for uuid, (ego0_SE3_obj0, dims, cat) in annos0.items():
        inside = points_in_cuboid(pc0, ego0_SE3_obj0, dims)
        if not inside.any():
            continue
        cats[inside] = _CAT_TO_INDEX.get(cat, 0)
        if uuid in annos1:
            ego1_SE3_obj1 = annos1[uuid][0]
            # p at t1 in ego1: the point is rigid in the object frame.
            obj0_SE3_ego0 = np.linalg.inv(ego0_SE3_obj0)
            motion = ego1_SE3_obj1 @ obj0_SE3_ego0
            flow[inside] = apply_se3(motion, pc0[inside]) - pc0[inside]
        else:
            valid[inside] = False  # object vanished; no supervision
    return flow.astype(np.float32), valid, cats


# ---------------------------------------------------------------- per-scene job
def process_log(args_tuple) -> str:
    log_dir, out_path, mask_dir, labeled = args_tuple
    log_id = os.path.basename(log_dir)
    poses = read_poses(log_dir)
    annos = read_annotations(log_dir) if labeled else {}
    ground = GroundHeightMap(os.path.join(log_dir, "map"))
    ts_list = lidar_timestamps(log_dir)

    import h5py

    with h5py.File(out_path, "w") as f:
        for i, t in enumerate(ts_list):
            pc = read_lidar(log_dir, t)
            pose = poses.get(t)
            if pose is None:  # nearest pose fallback
                key = min(poses, key=lambda k: abs(k - t))
                pose = poses[key]
            g = f.create_group(str(t))
            g.create_dataset("lidar", data=pc, compression="lzf")
            g.create_dataset("pose", data=pose)
            city_pts = apply_se3(pose, pc.astype(np.float64))
            g.create_dataset("ground_mask", data=ground.is_ground(city_pts),
                             compression="lzf")

            if labeled and i + 1 < len(ts_list):
                t1 = ts_list[i + 1]
                pose1 = poses.get(t1, pose)
                ego1_SE3_ego0 = np.linalg.inv(pose1) @ pose
                flow, valid, cats = compute_flow(
                    pc.astype(np.float64), ego1_SE3_ego0,
                    annos.get(t, {}), annos.get(t1, {}))
                g.create_dataset("flow", data=flow, compression="lzf")
                g.create_dataset("flow_is_valid", data=valid, compression="lzf")
                g.create_dataset("flow_category_indices", data=cats,
                                 compression="lzf")
                g.create_dataset("ego_motion", data=ego1_SE3_ego0)

            if mask_dir:
                mpath = os.path.join(mask_dir, log_id, f"{t}.feather")
                if os.path.exists(mpath):
                    import pyarrow.feather as feather

                    mdf = feather.read_feather(mpath)
                    g.create_dataset("eval_mask",
                                     data=mdf["mask"].to_numpy().astype(bool),
                                     compression="lzf")
    return log_id


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--argo_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--av2_type", default="sensor")
    p.add_argument("--data_mode", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--mask_dir", default="")
    p.add_argument("--nproc", type=int, default=os.cpu_count())
    args = p.parse_args(argv)

    split_dir = os.path.join(args.argo_dir, args.av2_type, args.data_mode)
    out_dir = os.path.join(args.output_dir, args.data_mode)
    os.makedirs(out_dir, exist_ok=True)
    labeled = args.data_mode in ("train", "val")
    mask_dir = (os.path.join(args.mask_dir, args.data_mode)
                if args.mask_dir else "")

    logs = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d)))
    jobs = [(os.path.join(split_dir, log), os.path.join(out_dir, log + ".h5"),
             mask_dir, labeled) for log in logs]
    print(f"extracting {len(jobs)} logs from {split_dir} with {args.nproc} procs")
    if args.nproc <= 1:
        for j in jobs:
            print("done:", process_log(j))
    else:
        with mp.Pool(args.nproc) as pool:
            for log_id in pool.imap_unordered(process_log, jobs):
                print("done:", log_id, flush=True)


if __name__ == "__main__":
    main()
