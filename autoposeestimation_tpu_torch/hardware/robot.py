"""The robot controller interface and a fake robot (port of
`autoposeestimation_tpu/hardware/robot.py`).

`RobotControllerBase` is the seam a user's robot controller fills:
move_joints, move_to_pose, get_pose(return_mm), get_joints(type),
is_moving, is_home(eps), at_target, close_gripper / open_gripper.
`FakeRobot` moves at once (or for `move_duration` seconds) and computes its
pose from a forward-kinematics function, so the acquisition and grasping
flows run without hardware."""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils import transforms as T

HOME_JOINTS_DEG = [0.0, -90.0, 0.0, -90.0, 0.0, 0.0]


class RobotControllerBase:
    def move_joints(self, target, moveType: str = "p", vel: float = 0.1,
                    acc: float = 0.1) -> None:
        raise NotImplementedError

    def move_to_pose(self, pose: Dict, moveType: str = "p", vel: float = 0.1,
                     acc: float = 0.1) -> None:
        raise NotImplementedError

    def get_pose(self, return_mm: bool = True) -> Dict:
        raise NotImplementedError

    def get_joints(self, type: str = "deg"):
        raise NotImplementedError

    def is_moving(self) -> bool:
        raise NotImplementedError

    def is_home(self, eps: float = 0.02) -> bool:
        j = np.asarray(self.get_joints("deg"))
        return bool(np.all(np.abs(np.asarray(HOME_JOINTS_DEG) - j) <= eps))

    def at_target(self, t, type: str = "deg", eps: float = 0.02) -> bool:
        j = np.asarray(self.get_joints(type))
        return bool(np.all(np.abs(np.asarray(t) - j) <= eps))

    def close_gripper(self) -> None:
        raise NotImplementedError

    def open_gripper(self) -> None:
        raise NotImplementedError


class FakeRobot(RobotControllerBase):
    """A simulated robot. Joint targets come in radians, as the callers'
    move_joints(np.deg2rad(...)) give them; the state is kept in degrees.
    `fk_fn(joints_deg)` gives the robot -> end-effector 4x4 transform (mm);
    by default the identity. `history` records every motion and gripper
    action."""

    def __init__(self, fk_fn: Optional[Callable] = None,
                 move_duration: float = 0.0):
        self.joints_deg = np.asarray(HOME_JOINTS_DEG, float)
        self.move_duration = move_duration
        self._moving_until = 0.0
        self.fk_fn = fk_fn or (lambda j: np.eye(4))
        self.gripper_closed = False
        self.history: List = []
        self._lock = threading.Lock()

    def move_joints(self, target, moveType: str = "p", vel: float = 0.1,
                    acc: float = 0.1) -> None:
        with self._lock:
            self.joints_deg = np.rad2deg(np.asarray(target, float))
            self._moving_until = time.time() + self.move_duration
            self.history.append(("joints", self.joints_deg.copy()))

    def move_to_pose(self, pose: Dict, moveType: str = "p", vel: float = 0.1,
                     acc: float = 0.1) -> None:
        with self._lock:
            self._pose_override = dict(pose)
            self._moving_until = time.time() + self.move_duration
            self.history.append(("pose", dict(pose)))

    def is_moving(self) -> bool:
        return time.time() < self._moving_until

    def get_joints(self, type: str = "deg"):
        if type == "deg":
            return self.joints_deg.copy()
        if type == "rad":
            return np.deg2rad(self.joints_deg)
        return -1

    def get_pose(self, return_mm: bool = True) -> Dict:
        """The last pose moved to, else the pose of the joints: x, y, z
        (mm, or m with return_mm=False) and the rotation vector a, b, c."""
        override = getattr(self, "_pose_override", None)
        if override is not None:
            return dict(override)
        tf = np.asarray(self.fk_fn(self.joints_deg))
        rv = T.mat_to_rotvec(torch.as_tensor(tf[:3, :3],
                                             dtype=torch.float32)).numpy()
        scale = 1.0 if return_mm else 1e-3
        return {"x": float(tf[0, 3]) * scale, "y": float(tf[1, 3]) * scale,
                "z": float(tf[2, 3]) * scale,
                "a": float(rv[0]), "b": float(rv[1]), "c": float(rv[2])}

    def robot2end(self) -> np.ndarray:
        return np.asarray(self.fk_fn(self.joints_deg))

    def close_gripper(self) -> None:
        self.gripper_closed = True
        self.history.append(("gripper", "close"))

    def open_gripper(self) -> None:
        self.gripper_closed = False
        self.history.append(("gripper", "open"))


def ring_fk(cams: List[np.ndarray], hand_eye: Optional[np.ndarray] = None
            ) -> Callable:
    """Forward kinematics for a camera ring: joint 0 at i degrees puts the
    camera at cams[i % len(cams)] (the end-effector at cams[i] @
    inv(hand_eye)), so a `FakeDepthCam` that follows the robot renders
    consistent views."""
    hand_eye = np.eye(4) if hand_eye is None else hand_eye

    def fk(joints_deg):
        idx = int(round(joints_deg[0])) % len(cams)
        return cams[idx] @ np.linalg.inv(hand_eye)

    return fk
