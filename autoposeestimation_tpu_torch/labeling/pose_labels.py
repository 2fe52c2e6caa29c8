"""Pose-label fitter, Phase C of the offline pipeline (port of
`autoposeestimation_tpu/labeling/pose_labels.py`).

Per run, the object position is the AABB midpoint of the reconstructed
cloud; for a run whose acquisition `object_pose` declares a manual turn,
the canonical <obj>_out cloud is registered onto the run cloud with ICP,
the recovered rotation is composed and the euler components the turn did
not request are zeroed. Per sample, cam2robot = inv(handEye) @
inv(robot2endEff), and the pose-label meta is written. 'extra' samples
reuse the remembered run pose matched by their object_pose rotation.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..ops import icp as icp_ops
from ..ops import pointcloud as pc
from ..utils import io
from ..utils import transforms as T
from ..utils.device import resolve_device


def _mat2euler_deg(rot: np.ndarray) -> np.ndarray:
    """sxyz euler angles in degrees of a 3x3 rotation, in f32 (host)."""
    angles = T.mat_to_euler(torch.as_tensor(np.asarray(rot, np.float32)))
    return np.rad2deg(np.asarray([float(a) for a in angles]))


def _euler2mat(e: np.ndarray) -> np.ndarray:
    """3x3 rotation of sxyz euler angles in radians, in f32 (host)."""
    return T.euler_to_mat(*(torch.tensor(float(a), dtype=torch.float32)
                            for a in e[:3])).numpy()


def _register_canonical(canonical: np.ndarray, run_cloud: np.ndarray,
                        voxel_size: float = 5.0, threshold: float = 10.0,
                        global_regression: bool = False, device=None):
    """ICP of the canonical cloud onto a run cloud: (tf, the downsampled
    canonical cloud moved by tf)."""
    dev = resolve_device(device)
    size = max(1024, len(canonical), len(run_cloud))
    s, sv = pc.to_device(*pc.pad_bucket(canonical, min_size=size), dev)
    t, tv = pc.to_device(*pc.pad_bucket(run_cloud, min_size=size), dev)
    _, _, src, svalid, tf = icp_ops.icp_regression(
        t, tv, s, sv, voxel_size=voxel_size, threshold=threshold,
        icp_point2point=True, icp_point2plane=False,
        global_regression=global_regression)
    tf = tf.cpu().numpy()
    return tf, pc.compact(src, svalid) @ tf[:3, :3].T + tf[:3, 3]


def _aabb_center(cloud: np.ndarray, dev) -> np.ndarray:
    return pc.aabb_center(*pc.to_device(*pc.pad_bucket(cloud), dev)
                          ).cpu().numpy()


def create_pose_label(root: str, object_name: str,
                      with_extra: bool = False,
                      global_regression: bool = False,
                      device=None) -> int:
    """Fit and write the pose labels of every sample of the object on
    `device` (CUDA unless the caller passes another). Returns the number of
    labels written."""
    dev = resolve_device(device)
    object_path = os.path.join(io.data_dir(root), object_name)
    pc_path = os.path.join(io.pc_dir(root), object_name,
                           f"{object_name}_out.ply")
    runs = [d for d in sorted(os.listdir(object_path))
            if d not in ("background", "extra")]
    if not runs:
        raise ValueError("no foreground")
    if with_extra and os.path.isdir(os.path.join(object_path, "extra")):
        runs.append("extra")

    remembered: List[Dict] = []
    written = 0
    for run in runs:
        data_path = os.path.join(object_path, run)
        label_path = os.path.join(io.label_dir(root), object_name, run)
        os.makedirs(label_path, exist_ok=True)

        pc_position = None
        pc_rotation = None
        if run != "extra":
            source = io.read_ply(pc_path)
            pc_position = _aabb_center(source, dev)
            # the run's declared manual rotation, from any sample meta
            metas = sorted(f for f in os.listdir(data_path)
                           if f.endswith(".meta.json"))
            meta0 = io.read_sample_meta(os.path.join(data_path, metas[0]))
            pc_rotation = np.asarray(meta0["object_pose"])[:3, :3]
            old_rotation = _mat2euler_deg(pc_rotation)

            if not np.allclose(old_rotation, 0.0):
                run_cloud = io.read_ply(os.path.join(
                    io.pc_dir(root), object_name, f"{run}.ply"))
                tf, moved = _register_canonical(
                    source, run_cloud, global_regression=global_regression,
                    device=dev)
                pc_rotation = pc_rotation @ tf[:3, :3]
                euler = np.deg2rad(_mat2euler_deg(pc_rotation))
                for i, angle in enumerate(old_rotation):
                    if angle == 0.0:
                        euler[i] = 0.0
                pc_rotation = _euler2mat(euler)
                pc_position = _aabb_center(moved, dev)
            remembered.append({"old_rotation": old_rotation,
                               "pc_position": pc_position,
                               "pc_rotation": pc_rotation})

        for stem in io.list_sample_ids(data_path):
            meta = io.read_sample_meta(os.path.join(data_path,
                                                    stem + ".meta.json"))
            if run == "extra":
                object_rotation = _mat2euler_deg(
                    np.asarray(meta["object_pose"])[:3, :3])
                for rem in remembered:
                    if np.array_equal(object_rotation, rem["old_rotation"]):
                        pc_position = rem["pc_position"]
                        pc_rotation = rem["pc_rotation"]
                        break

            robot2object = np.eye(4)
            robot2object[:3, :3] = pc_rotation
            robot2object[:3, 3] = pc_position
            cam2robot = (np.linalg.inv(meta["hand_eye_calibration"])
                         @ np.linalg.inv(meta["robot2endEff_tf"]))
            cam2object = cam2robot @ robot2object
            io.write_pose_label_meta(
                os.path.join(label_path, stem + ".meta.json"),
                position=cam2object[:3, 3], rotation=cam2object[:3, :3],
                cls_name=object_name, cam2robot=cam2robot,
                robot2object=robot2object)
            written += 1
    return written
