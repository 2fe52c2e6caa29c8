"""The on-disk dataset contract, as far as the prediction loader reads it
(numpy copy of the matching functions in `autoposeestimation_tpu/utils/io.py`;
the layout is documented there)."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class Intrinsics:
    """Pinhole intrinsics as stored in the acquisition meta.json `intr`."""

    width: int = 640
    height: int = 480
    ppx: float = 320.0
    ppy: float = 240.0
    fx: float = 600.0
    fy: float = 600.0
    coeffs: List[float] = field(default_factory=lambda: [0.0] * 5)

    @classmethod
    def from_dict(cls, d: Dict) -> "Intrinsics":
        return cls(width=int(d["width"]), height=int(d["height"]),
                   ppx=float(d["ppx"]), ppy=float(d["ppy"]),
                   fx=float(d["fx"]), fy=float(d["fy"]),
                   coeffs=list(d.get("coeffs", [0.0] * 5)))

    def as_array(self) -> np.ndarray:
        """(fx, fy, ppx, ppy) vector for the projection ops."""
        return np.asarray([self.fx, self.fy, self.ppx, self.ppy], np.float32)


def read_sample_meta(path: str) -> Dict:
    """Acquisition meta.json with `intr` parsed and the 4x4 transforms
    reshaped."""
    with open(path) as f:
        meta = json.load(f)
    out = dict(meta)
    out["intr"] = Intrinsics.from_dict(meta["intr"])
    for key in ("robot2endEff_tf", "hand_eye_calibration", "object_pose"):
        if meta.get(key) is not None:
            out[key] = np.asarray(meta[key], np.float64).reshape(4, 4)
    return out


def read_lines(path: str) -> List[str]:
    """List files (classes.txt, *_data_list.txt): lines up to the first
    blank one."""
    out: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                break
            out.append(line)
    return out


def read_xyz(path: str) -> np.ndarray:
    """`.xyz` model cloud: one `[x y z]` numpy repr per line."""
    points = []
    with open(path) as f:
        for line in f:
            line = line.strip().strip("[]")
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 3:
                points.append(vals[:3])
    return np.asarray(points, dtype=np.float64)


def data_dir(root: str) -> str:
    return os.path.join(root, "data_generation", "data")


def dataset_dir(root: str, kind: str, name: str) -> str:
    """kind in {segmentation, pose_estimation}."""
    return os.path.join(root, "label_generator", "data_sets", kind, name)


def pc_dir(root: str) -> str:
    return os.path.join(root, "pc_reconstruction", "data")
