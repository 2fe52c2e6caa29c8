"""Labelled views of the tabletop scene (`scene.py`) for segmentation
training: each view's colour image and, for every pixel, the class of the
object its ray hits first (object i of `scene.place_objects`' order is
class i + 1; the table and the sky are 0), as a YCB-Video frame and its
`-label.png` give them."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from traffic import scene

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def labels(hw: Tuple[int, int], focal: float, robot2cam: np.ndarray,
           objects, device) -> torch.Tensor:
    """int64 (H, W): the class of the nearest object each pixel's ray
    hits, else 0, rendered by `scene.render` with object i coloured
    (i + 1, 0, 0): the table's colour has no 0 in it."""
    ids = [(centre, radius, (i + 1, 0, 0))
           for i, (centre, radius, _) in enumerate(objects)]
    colour, _ = scene.render(hw, focal, robot2cam, ids, device)
    return torch.where(colour[..., 1] == 0, colour[..., 0].to(torch.int64),
                       0)


def labelled_views(layout: Dict, hw: Tuple[int, int], count: int,
                   seed: int, device) -> Dict[str, torch.Tensor]:
    """`count` views of one seeded scene on `device`: 'image' (F, H, W, 3)
    float32 normalized as YCBSegDataset normalizes (/255, ImageNet mean
    and std) and 'label' (F, H, W) int64."""
    rng = np.random.default_rng(seed)
    objects = scene.place_objects(layout, rng)
    focal = float(layout["camera"]["focal_px"])
    images, labelled = [], []
    for tf in scene.cameras(layout, count, rng):
        colour, _ = scene.render(hw, focal, tf, objects, device)
        images.append(colour)
        labelled.append(labels(hw, focal, tf, objects, device))
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    image = (torch.stack(images).to(torch.float32) / 255.0 - mean) / std
    return {"image": image, "label": torch.stack(labelled)}
