"""The robot scan loop (port of
`autoposeestimation_tpu/acquisition/get_data.py`, reference
data_generation/getData.py): drive the robot along a recorded viewpoint
path, wait while state.json says 'pause', capture a frame and its meta at
every capture point, and let a thread capture a timestamped extra sample
every >= 25 mm of end-effector travel between viewpoints. The meta schema
is the on-disk contract's.

The two 4x4s of a meta (`robot2endEff_tf`, `object_pose`) are built in
f32, as the JAX package builds them, so every later stage reads the same
rounding. They are a few scalars a capture and are computed on the CPU:
the scan loop launches nothing on the card.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..utils import io
from ..utils import transforms as T


def robot2end_from_pose(pose: Dict) -> np.ndarray:
    """UR pose dict {x,y,z,a,b,c} (mm + rotation vector) -> 4x4 f32 (mm)."""
    rv = torch.tensor([pose["a"], pose["b"], pose["c"]], dtype=torch.float32,
                      device="cpu")
    trans = torch.tensor([pose["x"], pose["y"], pose["z"]],
                         dtype=torch.float32, device="cpu")
    return T.make_tf(T.rotvec_to_mat(rv), trans).numpy()


def object_pose_tf(object_pose: Dict) -> np.ndarray:
    """The acquisition object_pose matrix: the f32 rotation of the turn's
    euler angles (degrees) in an f64 4x4. The translation keeps the
    reference's (z, y, z) quirk (getData.py:185); only the rotation is ever
    read downstream."""
    angles = [torch.tensor(np.deg2rad(object_pose.get(k, 0.0)),
                           dtype=torch.float32, device="cpu")
              for k in ("a", "b", "c")]
    tf = np.eye(4)
    tf[:3, :3] = T.euler_to_mat(*angles).numpy()
    tf[:3, 3] = [object_pose.get("z", 0.0), object_pose.get("y", 0.0),
                 object_pose.get("z", 0.0)]
    return tf


def build_meta(controller, camera, object_pose: Dict, symmetric: int,
               hand_eye_calibration, view_point_id: int) -> Dict:
    pose = controller.get_pose(return_mm=True)
    return {
        "joints": [float(v) for v in controller.get_joints()],
        "pose": pose,
        "object_pose": object_pose_tf(object_pose),
        "robot2endEff_tf": robot2end_from_pose(pose),
        "intr": camera.get_intrinsics(),
        "depth_scale": camera.get_depth_scale(),
        "symmetric": int(symmetric),
        "hand_eye_calibration": np.asarray(hand_eye_calibration),
        "view_point_id": view_point_id,
    }


def write_sample(save_dir: str, stem: str, frames: Dict, meta: Dict) -> None:
    io.write_png(os.path.join(save_dir, stem + ".color.png"),
                 np.asarray(frames["image"], np.uint8))
    io.write_png(os.path.join(save_dir, stem + ".depth.png"),
                 np.asarray(frames["depth"], np.uint16))
    io.write_sample_meta(os.path.join(save_dir, stem + ".meta.json"), meta)


def extra_sample_worker(stop_flag, controller, camera, extra_dir: str,
                        object_pose: Dict, symmetric: int,
                        hand_eye_calibration, view_point_id: int,
                        min_dist_travelled: float = 25.0,
                        poll: float = 0.1) -> int:
    """Capture a timestamped extra sample every >= min_dist_travelled mm of
    end-effector travel until `stop_flag()`. Returns the number captured."""
    os.makedirs(extra_dir, exist_ok=True)
    pose = controller.get_pose(return_mm=True)
    last = np.asarray([pose["x"], pose["y"], pose["z"]])
    captured = 0
    while not stop_flag():
        time.sleep(poll)
        pose = controller.get_pose(return_mm=True)
        cur = np.asarray([pose["x"], pose["y"], pose["z"]])
        if np.linalg.norm(cur - last) >= min_dist_travelled:
            frames = camera.get_frames(return_first=True)
            if frames is None:
                continue
            meta = build_meta(controller, camera, object_pose, symmetric,
                              hand_eye_calibration, view_point_id)
            write_sample(extra_dir, str(time.time()), frames, meta)
            captured += 1
            last = cur
    return captured


def wait_until_running(state_path: str, poll: float = 0.5) -> None:
    """Pause gate: block while state.json says {'state': 'pause'}."""
    while True:
        state = "running"
        if os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    state = json.load(f).get("state", "running")
            except (json.JSONDecodeError, OSError):
                state = "running"
        if state != "pause":
            return
        time.sleep(poll)


def get_data(camera, controller, path_data: Dict, root: str, name: str,
             run: str, object_pose: Dict, symmetric, hand_eye_calibration,
             min_dist_travelled: float = 25.0, settle: float = 0.5,
             state_path: Optional[str] = None,
             with_extra: bool = True,
             motion_poll: float = 0.05) -> int:
    """Run one scan. `path_data` is the viewpoint path dict
    ({'joints': [...], 'via_points': [...]}); returns the number of
    captured viewpoint samples (0 unless the robot starts at home)."""
    symmetric = 1 if symmetric else 0
    save_dir = os.path.join(io.data_dir(root), name, run)
    os.makedirs(save_dir, exist_ok=True)
    extra_dir = os.path.join(io.data_dir(root), name, "extra")
    state_path = state_path or os.path.join(root, "data_generation",
                                            "state.json")

    if not controller.is_home():
        return 0

    point = 0
    for i, joints in enumerate(path_data["joints"]):
        wait_until_running(state_path)

        stop = {"flag": False}
        thread = None
        if with_extra:
            thread = threading.Thread(
                target=extra_sample_worker,
                args=(lambda: stop["flag"], controller, camera, extra_dir,
                      object_pose, symmetric, hand_eye_calibration, point,
                      min_dist_travelled),
                daemon=True)
            thread.start()

        controller.move_joints(np.deg2rad(np.asarray(joints, float)))
        target_deg = np.asarray(joints, float)
        while (not controller.at_target(target_deg)) or controller.is_moving():
            time.sleep(motion_poll)

        stop["flag"] = True
        if thread is not None:
            thread.join()

        if int(path_data["via_points"][i]) == 0:
            time.sleep(settle)
            frames = camera.get_frames(with_repair=True, secure_image=True)
            meta = build_meta(controller, camera, object_pose, symmetric,
                              hand_eye_calibration, point)
            write_sample(save_dir, f"{point:06d}", frames, meta)
            point += 1
    return point


def load_robot_path(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
