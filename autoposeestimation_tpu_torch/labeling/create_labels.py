"""The offline labeling functions (port of
`autoposeestimation_tpu/labeling/create_labels.py`, whose docstring cites
the reference behaviour kept):

  * `create_labels`: the classical background-subtraction masks ('gen'),
    `ops/bg_subtraction.py::create_label_rgbd` per sample with the
    reference's per-sample parameters (threshold 30, HSV and RGB, open and
    close 6, remove_one_std) as defaults;
  * `create_mask_predictions`: the learned 7-channel background
    subtraction U-Net ('pred'): `build_bs_input`, the U-Net, softmax,
    argmax > 0, the best component by summed maximum probability;
  * `create_new_pred_labels`: Phase A, re-labeling every sample with the
    trained multi-class U-Net (the best component of the object's class by
    mean probability), then the trust checks on the host: no overlap with
    the BS label falls back to it, no overlap with the depth or nothing
    inside the centre crop (30 / 50 pixels in) drops the sample;
  * `create_pose_data`: Phase A, then Phases B and C
    (`reconstruction/create_pointcloud.py::load_point_cloud`,
    `labeling/pose_labels.py::create_pose_label`) at the reference's
    settings, with the per-phase times.

The networks and the label ops run on the model's device; Phases B and C
on `device` (cuda unless the caller passes another). Models are the port's
torch modules with weights loaded (`main.py::App` loads them).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.common import normalize_imagenet
from ..ops import bg_subtraction as bgs
from ..ops import cca as cca_ops
from ..parallel import mesh as pmesh
from ..reconstruction import create_pointcloud as rec
from ..utils import io
from ..utils.device import resolve_device
from . import pose_labels

DEFAULT_DIST = 1050.0   # mm, where no reference point is given


def _measure_dist(meta: Dict, reference_point: Optional[np.ndarray]
                  ) -> Optional[float]:
    """Camera-to-reference distance (mm) of a sample, None without a
    reference point."""
    if reference_point is None or reference_point.size == 0:
        return None
    pos = io.robot2cam_from_meta(meta)[:3, 3]
    return float(np.linalg.norm(reference_point - pos))


def _foreground_runs(root: str, object_name: str,
                     with_extra: bool = False) -> List[str]:
    runs = io.list_runs(root, object_name)
    if "background" not in runs:
        raise ValueError(
            f"background does not exist for object {object_name}")
    out = [r for r in runs if r != "background"
           and (with_extra or r != "extra")]
    if not out:
        raise ValueError("no foreground")
    return out


def _pairs(root: str, object_name: str):
    """(run, stem, background path, foreground path, label dir) of every
    foreground sample that has a background view, in the JAX order."""
    data_root = os.path.join(io.data_dir(root), object_name)
    bg_dir = os.path.join(data_root, "background")
    bg_ids = io.list_sample_ids(bg_dir)
    for run in _foreground_runs(root, object_name):
        fg_dir = os.path.join(data_root, run)
        save_dir = os.path.join(io.label_dir(root), object_name, run)
        os.makedirs(save_dir, exist_ok=True)
        for stem in bg_ids:
            if os.path.exists(os.path.join(fg_dir, stem + ".color.png")):
                yield (run, stem, os.path.join(bg_dir, stem),
                       os.path.join(fg_dir, stem), save_dir)


def _read_pair(bg: str, fg: str, dev: torch.device,
               reference_point: Optional[np.ndarray]):
    """Both views' RGB and depth on `dev`, and the sample's reference
    distance (DEFAULT_DIST without a reference point)."""
    tensors = [torch.from_numpy(io.read_color(bg + ".color.png")),
               torch.from_numpy(io.read_color(fg + ".color.png")),
               torch.from_numpy(io.read_depth(bg + ".depth.png").astype(
                   np.float32)),
               torch.from_numpy(io.read_depth(fg + ".depth.png").astype(
                   np.float32))]
    dist = _measure_dist(io.read_sample_meta(fg + ".meta.json"),
                         reference_point)
    return ([t.to(dev) for t in tensors],
            DEFAULT_DIST if dist is None else dist)


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def create_labels(object_name: str, root: str,
                  reference_point: Optional[np.ndarray] = None,
                  hsv: bool = False, both: bool = True,
                  threshold: float = 30.0, open_k: int = 6, close_k: int = 6,
                  remove_one_std: bool = True, progress=None,
                  device=None) -> int:
    """'gen' mode: the classical mask of every foreground sample, on
    `device` (cuda unless given), written as NNNNNN.gen.label.png. Returns
    the number of labels written."""
    dev = resolve_device(device)
    count = 0
    for run, stem, bg, fg, save_dir in _pairs(root, object_name):
        (bg_rgb, fg_rgb, bg_d, fg_d), dist = _read_pair(bg, fg, dev,
                                                        reference_point)
        label = bgs.create_label_rgbd(
            bg_rgb, fg_rgb, bg_d, fg_d, dist, threshold=threshold, hsv=hsv,
            both=both, open_k=open_k, close_k=close_k,
            remove_one_std=remove_one_std)
        io.write_png(os.path.join(save_dir, stem + ".gen.label.png"),
                     label.cpu().numpy())
        count += 1
        if progress is not None:
            progress(object_name, run, stem)
    return count


@torch.inference_mode()
def bs_mask(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The learned background subtraction mask (H, W) bool of one 7-channel
    input (H, W, 7): softmax, argmax > 0, then the component with the
    largest summed maximum probability."""
    logits = model(x.permute(2, 0, 1)[None].contiguous())[0]
    probs = torch.softmax(logits.to(torch.float32), dim=0)
    mask = torch.argmax(probs, dim=0) > 0
    comp, _ = cca_ops.best_component_mask(mask, torch.amax(probs, dim=0),
                                          0.0, "sum")
    return comp


def create_mask_predictions(object_name: str, root: str,
                            model: torch.nn.Module,
                            reference_point: Optional[np.ndarray] = None,
                            progress=None) -> int:
    """'pred' mode: the learned model's mask of every foreground sample, on
    the model's device, written as NNNNNN.pred.label.png. Returns the
    number of labels written."""
    dev = _model_device(model)
    count = 0
    for run, stem, bg, fg, save_dir in _pairs(root, object_name):
        (bg_rgb, fg_rgb, bg_d, fg_d), dist = _read_pair(bg, fg, dev,
                                                        reference_point)
        comp = bs_mask(model, bgs.build_bs_input(bg_rgb, fg_rgb, bg_d, fg_d,
                                                 dist))
        io.write_png(os.path.join(save_dir, stem + ".pred.label.png"),
                     comp.cpu().numpy().astype(np.uint8) * 255)
        count += 1
        if progress is not None:
            progress(object_name, run, stem)
    return count


@torch.inference_mode()
def class_mask(model: torch.nn.Module, image: torch.Tensor,
               cls_id: int) -> torch.Tensor:
    """The multi-class model's mask (H, W) bool of class `cls_id` in one
    uint8 RGB frame (H, W, 3): the component of the class's argmax pixels
    with the highest mean probability."""
    x = normalize_imagenet(image.permute(2, 0, 1)[None])
    probs = torch.softmax(model(x)[0].to(torch.float32), dim=0)
    cls_pixels = torch.argmax(probs, dim=0) == cls_id
    score = torch.where(cls_pixels, probs[cls_id], 0.0)
    comp, found = cca_ops.best_component_mask(cls_pixels, score, 0.0,
                                              "mean_float")
    return comp & found


def create_new_pred_labels(root: str, classes: Sequence[str],
                           seg_model: torch.nn.Module,
                           reference_point: Optional[np.ndarray],
                           get_extra_labels: bool = False,
                           progress=None) -> Dict[str, int]:
    """Phase A: re-label every sample with the trained multi-class model on
    its device and apply the trust checks; writes NNNNNN.new_pred.label.png
    where a sample passes and removes it and the sample's pose-label meta
    where it does not. Returns the stats dict."""
    dev = _model_device(seg_model)
    stats = {"n_samples": 0, "n_extra_samples": 0, "bs_copied": 0,
             "no_depth_overlap": 0, "not_in_center": 0}
    for class_id, cls in enumerate(classes):
        data_path = os.path.join(io.data_dir(root), cls)
        for run in _foreground_runs(root, cls, with_extra=get_extra_labels):
            run_dir = os.path.join(data_path, run)
            label_path = os.path.join(io.label_dir(root), cls, run)
            os.makedirs(label_path, exist_ok=True)
            for stem in io.list_sample_ids(run_dir):
                meta = io.read_sample_meta(
                    os.path.join(run_dir, stem + ".meta.json"))
                dist = _measure_dist(meta, reference_point)
                depth = io.read_depth(os.path.join(
                    run_dir, stem + ".depth.png")).astype(np.float64)
                if dist is not None:
                    depth[(depth > dist + 150) | (depth < dist - 150)] = 0
                image = torch.from_numpy(io.read_color(
                    os.path.join(run_dir, stem + ".color.png"))).to(dev)
                pred = class_mask(seg_model, image, class_id + 1).cpu(
                    ).numpy().astype(np.uint8) * 255

                save = False
                if run != "extra":
                    bs_path = os.path.join(label_path,
                                           stem + ".pred.label.png")
                    bs_label = (io.read_label(bs_path)
                                if os.path.exists(bs_path)
                                else np.zeros_like(pred))
                    # no overlap with the BS label: fall back to it
                    if len(np.unique(pred[bs_label != 0])) <= 1:
                        pred = bs_label
                        save = True
                        stats["bs_copied"] += 1

                if not save:
                    if len(np.unique(pred[depth != 0])) <= 1:
                        stats["no_depth_overlap"] += 1
                    else:
                        s0, s1 = pred.shape
                        cut0, cut1 = 30, 50
                        if len(np.unique(
                                pred[cut0:s0 - cut0, cut1:s1 - cut1])) > 1:
                            save = True
                        else:
                            stats["not_in_center"] += 1

                new_path = os.path.join(label_path,
                                        stem + ".new_pred.label.png")
                meta_path = os.path.join(label_path, stem + ".meta.json")
                if save:
                    stats["n_extra_samples" if run == "extra"
                          else "n_samples"] += 1
                    io.write_png(new_path, pred)
                else:
                    for p in (new_path, meta_path):
                        if os.path.exists(p):
                            os.remove(p)
                if progress is not None:
                    progress(cls, run, stem, save)
    return stats


def create_pose_data(root: str, classes: Sequence[str], ds_name: str,
                     seg_model: Optional[torch.nn.Module],
                     reference_point: np.ndarray,
                     new_pred: bool = True, get_extra_labels: bool = False,
                     n_viewpoints: int = 30, global_regression: bool = False,
                     progress=None, data_parallel: str = "auto",
                     device=None) -> Dict:
    """Phase A (re-labeling, on the model's device), then per class Phase B
    (reconstruction) and Phase C (pose labels) on `device` (cuda unless
    given), at the reference's settings. Returns {"stats": Phase A's stats,
    "times": {"seg": [s], "pc": [s per class], "pose": [s per class]}}.
    `data_parallel` ('auto', 'on', 'off') goes through `parallel/mesh.py::
    auto_mesh`: with a mesh, every rank calls this, Phase B's per-view
    surfaces are split over its 'data' ranks (`load_point_cloud(mesh=)`),
    and Phases A and C, which write files, run on rank 0."""
    dev = resolve_device(device)
    mesh = pmesh.auto_mesh(data_parallel, device=dev)
    writer = pmesh.is_writer(mesh)
    mode = "new_pred" if new_pred else "pred"
    times = {"seg": [], "pc": [], "pose": []}
    stats: Dict = {}

    t0 = time.time()
    if new_pred and writer:
        stats = create_new_pred_labels(root, classes, seg_model,
                                       reference_point, get_extra_labels,
                                       progress=progress)
    pmesh.barrier(mesh)
    times["seg"].append(time.time() - t0)

    for cls in classes:
        t1 = time.time()
        rec.load_point_cloud(
            cls, io.pc_dir(root), root, reference_point=reference_point,
            mode=mode, n_viewpoints=n_viewpoints, min_friends=20, min_dist=5,
            nb_neighbors=20, threshold=10, voxel_size=2, voxel_size_out=5,
            global_regression=global_regression, icp_point2point=True,
            icp_point2plane=False, mesh=mesh, device=dev)
        times["pc"].append(time.time() - t1)

        t2 = time.time()
        if writer:
            pose_labels.create_pose_label(
                root, cls, with_extra=get_extra_labels,
                global_regression=global_regression, device=dev)
        pmesh.barrier(mesh)
        times["pose"].append(time.time() - t2)

    return {"stats": stats, "times": times}
