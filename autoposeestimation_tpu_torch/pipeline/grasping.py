"""Grasping: the robot's motions and the multi-view prediction (port of
`autoposeestimation_tpu/pipeline/grasping.py`).

The joint-space constants (home, via point, grasp position, 5 view points)
and the workspace box; move-and-poll loops; the prediction averaged over
the 5 view points (positions and quaternions element-wise, keeping only the
classes seen from every view); the constraint check, the approach
(`approach_dist` above the target), the descent, and the moves back to the
grasp position and home. Confirmation prompts are injected (`confirm`).

Also the taught grasps: per class the delta between a predicted object pose
and the robot pose that grasps it, kept in
pipeline/data/<ds>_grasping_deltas.json.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils import io
from . import predict

# joint-space constants (degrees) and the workspace box (m)
CONSTRAINTS: Dict = {
    "home": ["j", [0.0, -90.0, 0.0, -90.0, 0.0, 0.0]],
    "via_point": ["j", [-1.93293161e+01, -8.25593825e+01, -8.47928270e+01,
                        -9.00302434e+01, 3.57270253e-02, 1.57928464e-02]],
    "grasp_pos": ["j", [-79.3068464, -125.35420593, -45.72337998,
                        -98.47686513, 88.83903427, 21.43752372]],
    "view_points": [
        ["j", [-56.57611344, -125.54468625, -60.90790138, -102.53858739,
               40.49850361, 27.27815167]],
        ["j", [-49.58489573, -103.54265252, -105.98638492, -40.72687804,
               28.49001676, -22.5935181]],
        ["j", [-64.02976228, -113.13764762, -125.48807764, 34.6443109,
               52.05968136, -79.16827552]],
        ["j", [-102.16350072, -112.44105029, -117.86479422, 17.05826768,
               132.82784992, -148.84610883]],
        ["j", [-83.63292429, -96.79734894, -90.29489956, -67.31125837,
               92.8942132, -271.21859887]],
    ],
    "max_x": 0.24705265462,
    "min_x": -0.2185443788766861,
    "max_y": -0.6827195882797241,
    "min_y": -0.8518663644790649,
    "max_z": 0.09871791303,
    "min_z": -0.02057011425,
    "approach_dist": 0.1,
}


def _move_and_wait(controller, joints_deg, vel: float = 0.1,
                   poll: float = 0.5) -> None:
    controller.move_joints(np.deg2rad(np.asarray(joints_deg, float)),
                           moveType="p", vel=vel)
    while (not controller.at_target(joints_deg)) or controller.is_moving():
        time.sleep(poll)


def move_to_grasp_position(controller, vel: float = 0.1,
                           constraints: Dict = CONSTRAINTS,
                           poll: float = 0.5) -> bool:
    if not controller.is_home():
        return False
    _move_and_wait(controller, constraints["via_point"][1], vel, poll)
    _move_and_wait(controller, constraints["grasp_pos"][1], vel, poll)
    return True


def move_home(controller, vel: float = 0.1,
              constraints: Dict = CONSTRAINTS, poll: float = 0.5) -> bool:
    if not controller.at_target(constraints["grasp_pos"][1]):
        return False
    _move_and_wait(controller, constraints["via_point"][1], vel, poll)
    _move_and_wait(controller, constraints["home"][1], vel, poll)
    return True


def return_to_grasp_position(controller, vel: float = 0.1,
                             constraints: Dict = CONSTRAINTS,
                             poll: float = 0.5) -> bool:
    _move_and_wait(controller, constraints["grasp_pos"][1], vel, poll)
    return True


def get_predictions(controller, camera, end2cam,
                    models: predict.PredictionModels, vel: float = 0.1,
                    constraints: Dict = CONSTRAINTS,
                    poll: float = 0.5) -> Tuple[bool, Dict]:
    """Predict from every view point in the robot frame and average per
    class: classes not seen from every view are dropped; positions and
    quaternions are averaged element-wise. (False, {}) unless the robot
    starts at the grasp position."""
    predictions: Dict[str, Dict[str, List]] = {}
    if not controller.at_target(constraints["grasp_pos"][1]):
        return False, {}
    meta = {"intr": camera.get_intrinsics(),
            "depth_scale": camera.get_depth_scale()}
    for joints in constraints["view_points"]:
        _move_and_wait(controller, joints[1], vel, poll)
        frames = camera.get_frames()
        out = predict.full_prediction(frames["image"], frames["depth"], meta,
                                      models)
        out = predict.get_robot2object(out, controller, end2cam)
        for cls, p in out["predictions"].items():
            predictions.setdefault(cls, {"position": [], "rotation": []})
            predictions[cls]["position"].append(p["position"])
            predictions[cls]["rotation"].append(p["rotation"])

    _move_and_wait(controller, constraints["grasp_pos"][1], vel, poll)

    n_views = len(constraints["view_points"])
    final = {}
    for cls, p in predictions.items():
        if len(p["position"]) != n_views:
            continue
        final[cls] = {
            "position": np.mean(np.asarray(p["position"]), axis=0),
            "rotation": np.mean(np.asarray(p["rotation"]), axis=0),
        }
    return True, final


def check_object_position_constraints(pos,
                                      constraints: Dict = CONSTRAINTS) -> bool:
    return (constraints["max_x"] > pos[0] > constraints["min_x"]
            and constraints["max_y"] > pos[1] > constraints["min_y"]
            and constraints["max_z"] > pos[2] > constraints["min_z"])


def approach_object(pos, rotation, controller, moveType: str = "p",
                    vel: float = 0.1, acc: float = 0.1,
                    confirm: Optional[Callable[[str], bool]] = None,
                    constraints: Dict = CONSTRAINTS,
                    poll: float = 0.5) -> bool:
    if not check_object_position_constraints(pos, constraints):
        return False
    pose = {"x": pos[0], "y": pos[1],
            "z": pos[2] + constraints["approach_dist"],
            "a": rotation[0], "b": rotation[1], "c": rotation[2]}
    if confirm is not None and not confirm(f"Move to pose {pose}"):
        return False
    controller.move_to_pose(pose, moveType=moveType, vel=vel, acc=acc)
    while controller.is_moving():
        time.sleep(poll)
    return True


def move_down(pos, rotation, controller, moveType: str = "l",
              vel: float = 0.1, acc: float = 0.1,
              confirm: Optional[Callable[[str], bool]] = None,
              poll: float = 0.5) -> bool:
    pose = {"x": pos[0], "y": pos[1], "z": pos[2],
            "a": rotation[0], "b": rotation[1], "c": rotation[2]}
    if confirm is not None and not confirm(f"Move to pose {pose}"):
        return False
    controller.move_to_pose(pose, moveType=moveType, vel=vel, acc=acc)
    while controller.is_moving():
        time.sleep(poll)
    return True


# ---------------------------------------------------------------------------
# Taught grasps
# ---------------------------------------------------------------------------

def deltas_path(root: str, data_set_name: str) -> str:
    return os.path.join(root, "pipeline", "data",
                        f"{data_set_name}_grasping_deltas.json")


def save_grasping_delta(root: str, data_set_name: str, cls: str,
                        object_position, object_rotation,
                        robot_pose: Dict) -> None:
    """Store the taught delta between a predicted object pose and the robot
    grasp pose for the class."""
    path = deltas_path(root, data_set_name)
    data = io.read_json(path) if os.path.exists(path) else {}
    data[cls] = {
        "object_position": [float(v) for v in object_position],
        "object_rotation": [float(v) for v in object_rotation],
        "robot_pose": {k: float(v) for k, v in robot_pose.items()},
        "delta_position": [
            float(robot_pose["x"] - object_position[0]),
            float(robot_pose["y"] - object_position[1]),
            float(robot_pose["z"] - object_position[2]),
        ],
    }
    io.write_json(path, data)


def load_grasping_deltas(root: str, data_set_name: str) -> Dict:
    path = deltas_path(root, data_set_name)
    return io.read_json(path) if os.path.exists(path) else {}


def grasp_target_from_delta(prediction: Dict, delta: Dict) -> Dict:
    """Compose a grasp pose from a live prediction + the taught delta."""
    pos = np.asarray(prediction["position"]) + np.asarray(
        delta["delta_position"])
    return {"x": float(pos[0]), "y": float(pos[1]), "z": float(pos[2]),
            "a": delta["robot_pose"]["a"], "b": delta["robot_pose"]["b"],
            "c": delta["robot_pose"]["c"]}


def execute_grasp(controller, camera, end2cam, models, root: str,
                  data_set_name: str, cls: str,
                  confirm: Optional[Callable[[str], bool]] = None,
                  constraints: Dict = CONSTRAINTS, vel: float = 0.1,
                  poll: float = 0.5) -> bool:
    """The grasp of class `cls`: multi-view prediction, constraint check,
    approach, descent, close, lift, return to the grasp position, release.
    False where a step refuses."""
    ok, preds = get_predictions(controller, camera, end2cam, models, vel,
                                constraints, poll)
    if not ok or cls not in preds:
        return False
    deltas = load_grasping_deltas(root, data_set_name)
    if cls not in deltas:
        return False
    target = grasp_target_from_delta(preds[cls], deltas[cls])
    pos = np.asarray([target["x"], target["y"], target["z"]])
    rot = np.asarray([target["a"], target["b"], target["c"]])
    if not approach_object(pos, rot, controller, vel=vel, confirm=confirm,
                           constraints=constraints, poll=poll):
        return False
    if not move_down(pos, rot, controller, vel=vel, confirm=confirm,
                     poll=poll):
        return False
    controller.close_gripper()
    approach_object(pos, rot, controller, vel=vel, confirm=confirm,
                    constraints=constraints, poll=poll)  # lift
    return_to_grasp_position(controller, vel, constraints, poll)
    controller.open_gripper()
    return True
