"""Visualization in numpy (port of `autoposeestimation_tpu/pipeline/
visualize.py`): point-cloud splatting with the projection of
`ops/projection.py::points_to_pixels`, the mask and pose overlays of
`full_prediction(color_prediction=True)`, and the mask and pose-label
slideshows with their cancellation token. No PIL, matplotlib or cv2."""
from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..ops import projection as proj
from ..utils import io
from ..utils import transforms as T


class CancellationToken:
    """Stops a slideshow from an input thread."""

    def __init__(self) -> None:
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def listen(self, input_fn=input,
               prompt: str = "press enter to stop") -> threading.Thread:
        """Cancel once `input_fn` returns (or meets the end of its input),
        waiting in a daemon thread."""
        def wait():
            try:
                input_fn(prompt)
            except EOFError:
                pass
            self.cancel()

        t = threading.Thread(target=wait, daemon=True)
        t.start()
        return t


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


def overlay_mask(image: np.ndarray, mask: np.ndarray,
                 color: Sequence[int], alpha: float = 0.3) -> np.ndarray:
    """Blend `color` over the mask's pixels: image * (1 - alpha) + color *
    alpha."""
    img = np.asarray(image, np.float64).copy()
    m = np.asarray(mask) > 0
    img[m] = img[m] * (1.0 - alpha) + np.asarray(color, np.float64) * alpha
    return np.clip(img, 0, 255).astype(np.uint8)


def draw_bbox(image: np.ndarray, bbox, color: Sequence[int],
              thickness: int = 2) -> np.ndarray:
    """Rectangle (rmin, rmax, cmin, cmax), clipped to the image."""
    img = np.asarray(image).copy()
    rmin, rmax, cmin, cmax = [int(v) for v in bbox]
    h, w = img.shape[:2]
    rmin, rmax = np.clip([rmin, rmax], 0, h - 1)
    cmin, cmax = np.clip([cmin, cmax], 0, w - 1)
    t = thickness
    img[rmin:rmin + t, cmin:cmax] = color
    img[max(rmax - t, 0):rmax, cmin:cmax] = color
    img[rmin:rmax, cmin:cmin + t] = color
    img[rmin:rmax, max(cmax - t, 0):cmax] = color
    return img


def paint_prediction(image: np.ndarray, prediction: Dict, color_dict: Dict,
                     intr, model_points: Dict[str, np.ndarray],
                     with_bbox: bool = False) -> Dict[str, np.ndarray]:
    """'segmented_prediction' (each class's mask overlaid in its colour,
    with its quantized bbox if `with_bbox`) and 'pose_prediction' (each
    class's model cloud splatted through its predicted pose)."""
    seg = np.asarray(image).copy()
    pose_img = np.asarray(image).copy()
    for cls, p in prediction["predictions"].items():
        color = color_dict[cls]["value"] if cls in color_dict else (255, 0, 0)
        seg = overlay_mask(seg, p["mask"], color)
        if with_bbox:
            mask = np.asarray(p["mask"]) > 0
            if mask.any():
                bbox = [int(v) for v in proj.get_bbox(
                    torch.as_tensor(mask), mask.shape[0], mask.shape[1])]
                seg = draw_bbox(seg, bbox, color)
        if cls in model_points:
            rot = T.quat_to_mat(torch.as_tensor(
                np.asarray(p["rotation"], np.float32))).numpy()
            pts = model_points[cls] @ rot.T + np.asarray(p["position"])
            pose_img = pointcloud2image(pose_img, pts, 3, intr, color)
    return {"segmented_prediction": seg, "pose_prediction": pose_img}


def visualise_segmentation_masks(root: str, obj: str, run: str,
                                 mode: str = "gen", color=(255, 0, 0),
                                 token: Optional[CancellationToken] = None
                                 ) -> Iterable[np.ndarray]:
    """The mask overlay of every labelled sample of a run, in order, until
    `token` is cancelled."""
    data_dir = os.path.join(io.data_dir(root), obj, run)
    label_dir = os.path.join(io.label_dir(root), obj, run)
    for stem in io.list_sample_ids(data_dir):
        if token is not None and token.cancelled:
            return
        label_path = os.path.join(label_dir, f"{stem}.{mode}.label.png")
        if not os.path.exists(label_path):
            continue
        image = io.read_color(os.path.join(data_dir, stem + ".color.png"))
        yield overlay_mask(image, io.read_label(label_path), color)


def visualise_pose_labels(root: str, obj: str, run: str,
                          token: Optional[CancellationToken] = None
                          ) -> Iterable[np.ndarray]:
    """The object's model cloud moved by each sample's pose label and
    splatted onto its image, until `token` is cancelled."""
    data_dir = os.path.join(io.data_dir(root), obj, run)
    label_dir = os.path.join(io.label_dir(root), obj, run)
    cloud = io.read_ply(os.path.join(io.pc_dir(root), obj, obj + ".ply"))
    for stem in io.list_sample_ids(data_dir):
        if token is not None and token.cancelled:
            return
        meta_path = os.path.join(label_dir, stem + ".meta.json")
        if not os.path.exists(meta_path):
            continue
        meta = io.read_pose_label_meta(meta_path)
        sample_meta = io.read_sample_meta(
            os.path.join(data_dir, stem + ".meta.json"))
        pts = cloud @ meta["rotation"].T + meta["position"]
        image = io.read_color(os.path.join(data_dir, stem + ".color.png"))
        yield pointcloud2image(image, pts, 3, sample_meta["intr"],
                               color=(0, 255, 0))
