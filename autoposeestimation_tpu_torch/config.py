"""One typed configuration for a workspace (port of
`autoposeestimation_tpu/config.py`): every knob of the stages with the
reference's values as defaults, and the port's own `DFConfig` and
`SegConfig` re-exported."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from .train.densefusion import DFConfig  # noqa: F401  (re-exported)
from .train.segmentation import SegConfig  # noqa: F401  (re-exported)


@dataclass
class LabelGenConfig:
    """Classical label generation (reference main.py:167-185,
    create_labels.py:511-524)."""

    threshold: float = 30.0
    hsv: bool = False
    both: bool = True
    open_k: int = 6
    close_k: int = 6
    remove_one_std: bool = True
    min_size: int = 100
    depth_margin_mm: float = 150.0


@dataclass
class ReconstructionConfig:
    """create_pose_data Phase B hyperparameters (reference
    create_labels.py:219-232)."""

    n_viewpoints: int = 30
    min_friends: int = 20
    min_dist: float = 5.0
    nb_neighbors: int = 20
    threshold: float = 10.0
    voxel_size: float = 2.0
    voxel_size_out: float = 5.0
    global_regression: bool = False
    icp_point2point: bool = True
    icp_point2plane: bool = False


@dataclass
class AcquisitionConfig:
    """Scan-loop settings (reference getData.py:113-137, main.py:26)."""

    fps: int = 30
    width: int = 640
    height: int = 480
    min_dist_travelled_mm: float = 25.0
    settle_seconds: float = 0.5
    robot_vel: float = 0.60
    robot_acc: float = 0.3


@dataclass
class ServingConfig:
    """Live-prediction shapes (reference pipeline/utils.py:520,569)."""

    num_points: int = 1000
    crop: int = 320
    refine_iters: int = 2
    min_class_pixels: int = 100


@dataclass
class AppConfig:
    """Workspace-level configuration."""

    root: str = "."
    reference_point: Tuple[float, float, float] = (0.0, -767.5, 0.0)
    p_test: float = 0.2
    labels: LabelGenConfig = field(default_factory=LabelGenConfig)
    reconstruction: ReconstructionConfig = field(
        default_factory=ReconstructionConfig)
    acquisition: AcquisitionConfig = field(default_factory=AcquisitionConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    segmentation: SegConfig = field(default_factory=SegConfig)
    pose: DFConfig = field(default_factory=DFConfig)

    def reference_point_array(self) -> np.ndarray:
        return np.asarray(self.reference_point, np.float64)
