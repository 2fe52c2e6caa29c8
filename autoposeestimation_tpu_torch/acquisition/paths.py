"""Robot viewpoint paths (port of
`autoposeestimation_tpu/acquisition/paths.py`): the interactive recorder,
the JSON file ({'joints': [...], 'via_points': [...], 'cart_pose': [...]},
the schema of the reference's viewpointsPath.json) and a ring path for the
fake robot."""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional


def record_path(controller, input_fn: Callable[[str], str] = input,
                print_fn: Callable[[str], None] = print) -> Dict:
    """Interactive recorder: jog the robot externally, then mark each
    station as capture ('c'), via ('v'), or finish ('d')."""
    joints: List = []
    vias: List[int] = []
    carts: List = []
    print_fn("record path: 'c'=capture point, 'v'=via point, 'd'=done")
    while True:
        cmd = input_fn("station> ").strip().lower()
        if cmd == "d":
            break
        if cmd not in ("c", "v"):
            print_fn("use c/v/d")
            continue
        joints.append([float(v) for v in controller.get_joints("deg")])
        carts.append(controller.get_pose(return_mm=True))
        vias.append(0 if cmd == "c" else 1)
    return {"joints": joints, "via_points": vias, "cart_pose": carts}


def save_path(path: str, data: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)


def load_path(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def generate_ring_path(n_viewpoints: int = 24, n_via: int = 0,
                       base_joints: Optional[List[float]] = None) -> Dict:
    """A scan path for the fake robot's ring forward kinematics: joint 0
    sweeps the view index, with `n_via` via points between captures."""
    base = base_joints or [0.0, -90.0, 0.0, -90.0, 0.0, 0.0]
    joints = []
    vias = []
    for i in range(n_viewpoints):
        j = list(base)
        j[0] = float(i)
        joints.append(j)
        vias.append(0)
        for v in range(n_via):
            jv = list(base)
            jv[0] = float(i) + (v + 1) / (n_via + 1)
            joints.append(jv)
            vias.append(1)
    return {"joints": joints, "via_points": vias, "cart_pose": []}
