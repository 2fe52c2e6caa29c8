"""Point-cloud splatting onto images (port of `pointcloud2image` of
`autoposeestimation_tpu/pipeline/visualize.py`), in numpy with the
projection of `ops/projection.py::points_to_pixels`."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import projection as proj


def pointcloud2image(image: np.ndarray, points: np.ndarray, point_size: int,
                     intr, color: Optional[Sequence[int]] = None
                     ) -> np.ndarray:
    """Splat point_size x point_size marks at the projected points, blended
    0.3 mark / 0.7 image, one point after another. Marks that would reach
    past the frame's edge are skipped. `intr` is an `Intrinsics` or a dict
    with fx, fy, ppx, ppy."""
    img = np.asarray(image, np.float64).copy()
    h, w = img.shape[:2]
    step = (point_size - 1) // 2
    mark = np.asarray(color if color is not None else (255, 0, 0), np.float64)
    intr_vec = intr.as_array() if hasattr(intr, "as_array") else np.asarray(
        [intr["fx"], intr["fy"], intr["ppx"], intr["ppy"]], np.float32)
    pix = proj.points_to_pixels(
        torch.as_tensor(np.asarray(points, np.float32)),
        torch.as_tensor(intr_vec)).numpy()
    for r, c in pix:
        r0, r1 = r - step, r + step + 1
        c0, c1 = c - step, c + step + 1
        if r0 < 0 or c0 < 0 or r1 > h or c1 > w:
            continue
        img[r0:r1, c0:c1] = mark * 0.3 + img[r0:r1, c0:c1] * 0.7
    return np.clip(img, 0, 255).astype(np.uint8)
