"""The hand-eye transform on disk (port of `save_hand_eye` /
`load_hand_eye` of `autoposeestimation_tpu/hardware/hand_eye.py`):
handEye_tf.json holds {'tf': 16 floats}, the end-effector -> camera
transform in mm."""
from __future__ import annotations

import numpy as np

from ..utils import io


def save_hand_eye(path: str, tf: np.ndarray) -> None:
    io.write_json(path, {"tf": [float(v) for v in np.asarray(tf).flatten()]})


def load_hand_eye(path: str) -> np.ndarray:
    return np.asarray(io.read_json(path)["tf"], np.float64).reshape(4, 4)
