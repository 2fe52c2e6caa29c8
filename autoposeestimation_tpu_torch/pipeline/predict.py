"""The live multi-object prediction path (port of the single-frame path of
`autoposeestimation_tpu/pipeline/predict.py`).

  normalize -> U-Net -> softmax/argmax -> per-class best-component CCA
  -> zoom window crop + choose + backproject (per class) -> one PoseNet
  forward over all class slots -> iterative refiner -> per-class pose.

Every class has a slot; `found` marks the live ones. The random draws of the
point selection come from a `torch.Generator`, or are given as `uniforms`
(K, num_points) in [0, 1) so that a caller can reproduce another
implementation's draws exactly.
"""
from __future__ import annotations

import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import weights
from ..models import losses
from ..models.common import init_like_flax, normalize_imagenet
from ..models.densefusion import PoseNet, PoseRefineNet
from ..models.unet import UNet
from ..ops import cca
from ..ops import projection as proj
from ..train import checkpoints
from ..utils import io
from ..utils.device import resolve_device


class PredictionModels(NamedTuple):
    seg_model: UNet
    posenet: PoseNet
    refiner: PoseRefineNet
    classes: tuple               # class names; index 0 = first foreground
    model_points: torch.Tensor   # (K, M, 3) per-class model clouds [m]
    device: torch.device
    num_points: int
    crop: int
    refine_iters: int
    # > 1: confidence-weighted top-k candidate averaging; 1 = argmax pick
    agg_topk: int = 1
    # CCA pooling factor and unrolled sweep count (ops/cca.py)
    cca_scale: int = 8
    cca_sweeps: int = 3
    # PSPNet embedding decoder stride (8 non-symmetric, 2 symmetric sets)
    emb_stride: int = 8
    emb_resize_late: bool = False
    # component rule: "sum" (probability mass) serves; "mean_float" is the
    # original live path's mean-probability rule
    cca_rule: str = "sum"


def _pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """Bool masks (..., H, W) -> (..., H, W//8) uint8, MSB first
    (np.unpackbits order); W % 8 == 0."""
    m = masks.reshape(masks.shape[:-1] + (-1, 8)).to(torch.int32)
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                        device=masks.device)
    return (m * bits).sum(-1).to(torch.uint8)


def _unpack_masks(packed: np.ndarray) -> np.ndarray:
    """Host inverse of `_pack_masks`."""
    return np.unpackbits(packed, axis=-1).astype(bool)


def _segment(seg_model: UNet, image: torch.Tensor):
    """image uint8 (3, H, W) -> (probs (C, H, W), argmax (H, W))."""
    logits = seg_model(normalize_imagenet(image)[None])[0]
    probs = torch.softmax(logits, dim=0)
    return probs, torch.argmax(probs, dim=0)


def _class_mask(score_plane, pred_arg, cls_id, min_count: int = 100,
                cca_scale: int = 1, cca_sweeps: int = 0,
                cca_rule: str = "sum"):
    """Best connected component of class `cls_id` (1-based; a tensor of
    shape S for planes (S, H, W)) scored on its probability plane. Returns
    (component (S, H, W), found (S,), converged); `found` also needs more
    than `min_count` class pixels."""
    cls_id = torch.as_tensor(cls_id, device=pred_arg.device)
    cls_mask = pred_arg == cls_id[..., None, None]
    count = cls_mask.sum((-2, -1))
    score = torch.where(cls_mask, score_plane, 0.0)
    comp, found, converged = cca.best_component_mask(
        cls_mask, score, min_size=0.0, rule=cca_rule,
        scale=max(1, cca_scale), fixed_sweeps=cca_sweeps, with_flag=True)
    return comp, found & (count > min_count), converged


def _pose_stage(models: PredictionModels, crops, clouds, chooses, obj_idx,
                refine_iters: int):
    pred_r, pred_t, pred_c, emb = models.posenet(crops, clouds, chooses,
                                                 obj_idx)
    quat, trans = losses.estimator_prediction(pred_r, pred_t, pred_c, clouds,
                                              topk=models.agg_topk)
    new_points = losses.rebase_points(quat, trans, clouds)
    for _ in range(refine_iters):
        dr, dt = models.refiner(new_points, emb, obj_idx)
        quat, trans = losses.compose_refined(dr, dt, quat, trans)
        new_points = losses.rebase_points(quat, trans, clouds)
    return quat, trans


def _predict_frame(models: PredictionModels, image, depth, intr,
                   depth_scale, uniforms) -> Dict[str, torch.Tensor]:
    """One frame on the models' device: image uint8 (H, W, 3), depth
    (H, W), intr (4,), uniforms (K, num_points)."""
    img = image.permute(2, 0, 1)
    depth = depth.to(torch.float32)
    h, w = depth.shape
    k = len(models.classes)
    probs, pred_arg = _segment(models.seg_model, img)
    cls_ids = torch.arange(1, k + 1, device=img.device)
    masks, found, converged = _class_mask(
        probs[1:k + 1], pred_arg, cls_ids, cca_scale=models.cca_scale,
        cca_sweeps=models.cca_sweeps, cca_rule=models.cca_rule)

    r0, c0, win = proj.zoom_window_bbox(masks, models.crop, h, w)
    clouds, chooses, counts = proj.backproject_choose_zoom(
        depth, masks, intr, depth_scale, r0, c0, win, models.crop,
        models.num_points, uniforms)
    crops = normalize_imagenet(
        proj.resample_window(img, r0, c0, win, models.crop))
    found = found & (counts > 0)

    obj_idx = torch.arange(k, device=img.device)
    quat, trans = _pose_stage(models, crops, clouds, chooses, obj_idx,
                              models.refine_iters)
    out = {"found": found, "masks": masks, "quats": quat,
           "positions": trans, "argmax": pred_arg,
           "cca_converged": converged.expand(k)}
    if w % 8 == 0:
        out["masks_packed"] = _pack_masks(masks)
    return out


def _intr_vec(meta: Dict) -> np.ndarray:
    intr = meta["intr"]
    return (intr.as_array() if hasattr(intr, "as_array") else np.asarray(
        [intr["fx"], intr["fy"], intr["ppx"], intr["ppy"]], np.float32))


def _uniforms(shape, device: torch.device,
              generator: Optional[torch.Generator],
              uniforms) -> torch.Tensor:
    """The point-selection draws: given, or from `generator` (seeded from
    the clock when None)."""
    if uniforms is not None:
        if not isinstance(uniforms, torch.Tensor):
            uniforms = np.array(uniforms, np.float32)
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms must be {tuple(shape)}: "
                             f"{tuple(u.shape)}")
        return u
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            time.time_ns() % (2 ** 31))
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def _frame_inputs(image, depth, meta, device):
    return (torch.as_tensor(np.asarray(image, np.uint8), device=device),
            torch.as_tensor(np.asarray(depth, np.float32), device=device),
            torch.as_tensor(_intr_vec(meta), device=device),
            torch.tensor(float(meta["depth_scale"]), dtype=torch.float32,
                         device=device))


def _materialize(out: Dict, models: PredictionModels) -> Dict:
    """One frame's device outputs -> the class-keyed prediction dict."""
    found = out["found"].cpu().numpy()
    quats = out["quats"].cpu().numpy()
    positions = out["positions"].cpu().numpy()
    masks = (_unpack_masks(out["masks_packed"].cpu().numpy())
             if "masks_packed" in out else out["masks"].cpu().numpy())
    cca_conv = out["cca_converged"].cpu().numpy()
    predictions = {}
    for i, cls in enumerate(models.classes):
        if found[i]:
            predictions[cls] = {"position": positions[i],
                                "rotation": quats[i],
                                "mask": masks[i].astype(np.uint8) * 255}
    return {"predictions": predictions,
            "cca_converged": {cls: bool(cca_conv[i])
                              for i, cls in enumerate(models.classes)}}


def full_prediction(image: np.ndarray, depth: np.ndarray, meta: Dict,
                    models: PredictionModels,
                    generator: Optional[torch.Generator] = None,
                    uniforms=None) -> Dict:
    """{'predictions': {cls: {'mask', 'position', 'rotation'}},
    'cca_converged': {cls: bool},
    'elapsed_times': {'segmentation', 'pose_estimation', 'total'}}.

    `image` uint8 RGB (H, W, 3); `depth` raw units (H, W); `meta` gives
    `intr` (Intrinsics or dict) and `depth_scale` (to meters).
    'segmentation' times the whole frame on the device, 'pose_estimation'
    the copy of its outputs to the host."""
    t_start = time.perf_counter()
    k, dev = len(models.classes), models.device
    with torch.inference_mode():
        frame = _frame_inputs(image, depth, meta, dev)
        u = _uniforms((k, models.num_points), dev, generator, uniforms)
        t0 = time.perf_counter()
        out = _predict_frame(models, *frame, u)
        out["found"] = out["found"].cpu()
        t1 = time.perf_counter()
        out_dict = _materialize(out, models)
    t2 = time.perf_counter()
    out_dict["elapsed_times"] = {"segmentation": t1 - t0,
                                 "pose_estimation": t2 - t1,
                                 "total": t2 - t_start}
    return out_dict


def pose_from_mask(image, depth, meta: Dict, models: PredictionModels, mask,
                   cls_name: str, generator: Optional[torch.Generator] = None,
                   uniforms=None, refine_iters: Optional[int] = None) -> Dict:
    """Pose stage only, for a given mask (H, W) of class `cls_name`:
    {'position', 'rotation', 'count'}. `uniforms` is (num_points,). With
    neither `generator` nor `uniforms` the draws come from a generator
    seeded with 0, as the JAX side's PRNGKey(0), so repeated calls give the
    same pose."""
    dev = models.device
    iters = models.refine_iters if refine_iters is None else refine_iters
    if generator is None and uniforms is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        image_t, depth_t, intr, scale = _frame_inputs(image, depth, meta, dev)
        m = torch.as_tensor(np.asarray(mask, bool), device=dev)[None]
        u = _uniforms((1, models.num_points), dev, generator,
                      None if uniforms is None
                      else np.asarray(uniforms).reshape(1, -1))
        h, w = depth_t.shape
        img = image_t.permute(2, 0, 1)
        r0, c0, win = proj.zoom_window_bbox(m, models.crop, h, w)
        cloud, choose, count = proj.backproject_choose_zoom(
            depth_t, m, intr, scale, r0, c0, win, models.crop,
            models.num_points, u)
        crops = normalize_imagenet(
            proj.resample_window(img, r0, c0, win, models.crop))
        obj = torch.tensor([models.classes.index(cls_name)], device=dev)
        quat, trans = _pose_stage(models, crops, cloud, choose, obj, iters)
    return {"position": trans[0].cpu().numpy(),
            "rotation": quat[0].cpu().numpy(), "count": int(count[0])}


def build_models(num_classes_fg: int, model_points: np.ndarray, classes,
                 seg_vars=None, pose_vars=None, refine_vars=None,
                 num_points: int = 1000, crop: int = 320,
                 refine_iters: int = 2, dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, agg_topk: int = 1, cca_scale: int = 8,
                 cca_sweeps: int = 3, emb_stride: int = 8,
                 emb_resize_late: bool = False, cca_rule: str = "sum",
                 device=None) -> PredictionModels:
    """The networks in inference mode on `device` (cuda by default). The
    `*_vars` are the JAX package's flax variable trees (numpy); a missing
    one is initialized from `seed` the way flax initializes it, on the CPU,
    so a seed gives the same weights on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    nets = [
        (UNet(num_classes_fg + 1, dtype=dtype), seg_vars,
         weights.unet_state_dict),
        (PoseNet(num_classes_fg, dtype=dtype, emb_stride=emb_stride,
                 emb_resize_late=emb_resize_late), pose_vars,
         weights.posenet_state_dict),
        (PoseRefineNet(num_classes_fg, dtype=dtype), refine_vars,
         weights.refiner_state_dict),
    ]
    for net, variables, to_state in nets:
        if variables is None:
            init_like_flax(net, gen)
        else:
            net.load_state_dict(to_state(variables))
        net.requires_grad_(False).eval().to(dev)
    return PredictionModels(
        nets[0][0], nets[1][0], nets[2][0], tuple(classes),
        torch.as_tensor(np.asarray(model_points, np.float32), device=dev),
        dev, num_points, crop, refine_iters, agg_topk, cca_scale, cca_sweeps,
        emb_stride, emb_resize_late, cca_rule)


def dataset_has_symmetric(root: str, classes) -> bool:
    """True if any class's first acquisition meta carries symmetric=1."""
    data_root = io.data_dir(root)
    for cls in classes:
        obj_dir = os.path.join(data_root, cls)
        try:
            run_dir = os.path.join(obj_dir, sorted(os.listdir(obj_dir))[0])
            metas = sorted(f for f in os.listdir(run_dir)
                           if f.endswith(".meta.json"))
            meta = io.read_sample_meta(os.path.join(run_dir, metas[0]))
        except (OSError, IndexError):
            continue
        if bool(meta.get("symmetric", 0)):
            return True
    return False


def get_prediction_models(root: str, data_set_name: str,
                          dtype: torch.dtype = torch.bfloat16,
                          emb_stride: Optional[int] = None,
                          device=None) -> PredictionModels:
    """Classes, per-class model clouds (mm -> m, wrap-padded to one M) and
    the trained weights of a dataset. `emb_stride=None` picks 2 when any
    class is symmetric (those regress at coarser strides), else 8."""
    classes = io.read_lines(os.path.join(
        io.dataset_dir(root, "segmentation", data_set_name), "classes.txt"))
    if emb_stride is None:
        emb_stride = 2 if dataset_has_symmetric(root, classes) else 8
    clouds = [io.read_xyz(os.path.join(io.pc_dir(root), cls,
                                       f"{cls}.xyz")) / 1000.0
              for cls in classes]
    max_m = max(len(p) for p in clouds)
    model_points = np.zeros((len(classes), max_m, 3), np.float32)
    for i, pts in enumerate(clouds):
        # wrap-pad so padded rows are real surface points
        model_points[i] = pts[np.arange(max_m) % max(len(pts), 1)]
    pose_dir = os.path.join(root, "DenseFusion", "trained_models",
                            data_set_name)
    seg_vars = checkpoints.load_checkpoint(os.path.join(
        root, "segmentation", "trained_models", data_set_name,
        "Unet_resnet34.ckpt.npz"))["variables"]
    pose_vars = checkpoints.load_checkpoint(
        os.path.join(pose_dir, "pose_model.npz"))["variables"]
    refine_vars = checkpoints.load_checkpoint(
        os.path.join(pose_dir, "pose_refine_model.npz"))["variables"]
    return build_models(len(classes), model_points, classes,
                        seg_vars=seg_vars, pose_vars=pose_vars,
                        refine_vars=refine_vars, dtype=dtype,
                        emb_stride=emb_stride, device=device)
