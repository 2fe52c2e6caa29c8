"""The frame graph cut into cumulative prefixes (port of
`autoposeestimation_tpu/utils/serving_stages.py`).

Each prefix is a step function `step(c, i) -> (carry, out)` over a fixed
frame, the first k stages of `pipeline/predict.py::_predict_frame`: the
U-Net with softmax and argmax; + the per-class CCA; + each class's zoom
window, point choice, backprojection and colour crop; + the PoseNet
estimator; + the refiner's iterations. The difference of two consecutive
prefixes' times is a stage's cost, the glue between stages included. Each
prefix's outputs reach its carry, which the next call adds to its input
image, so a chain of calls is dependent work.

The frame is the headline scene's geometry (`utils/synthetic.py`: spheres
on a 120 mm ring, the first ring camera) rendered at (h, w), with the
intrinsics of the JAX package's `build_prefixes`. The point choice's
draws for call i come from `uniforms(i)`, a (K, num_points) array in
[0, 1), where a caller gives them (the JAX package draws them from
`fold_in(PRNGKey(0), i)`), else from a generator seeded with 0 on the
device.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.common import normalize_imagenet
from ..ops import projection as proj
from ..pipeline import predict
from . import synthetic

PREFIX_ORDER = ("seg", "seg_cca", "perclass", "estimator", "full")
STAGE_LABELS = {"seg": "U-Net fwd + softmax/argmax",
                "seg_cca": "+ per-class CCA",
                "perclass": "+ crop/choose/backproject",
                "estimator": "+ PoseNet estimator (refine off)",
                "full": "+ iterative refine"}


def initial_carry(device) -> torch.Tensor:
    """The first call's carry: a uint8 zero on `device`."""
    return torch.zeros((), dtype=torch.uint8, device=device)


def headline_frame(num_classes: int, h: int, w: int,
                   rng: np.random.Generator):
    """The prefixes' frame (image uint8 (h, w, 3), depth (h, w)): the
    headline scene's spheres on a 120 mm ring, coloured from `rng`, seen
    from the first camera of a 500 mm ring at 450 mm."""
    cfg = synthetic.SynthConfig(img_h=h, img_w=w, fx=600.0, fy=600.0,
                                ring_radius=500.0, ring_height=450.0)
    spheres = [
        synthetic.SphereObject(
            f"obj{i}",
            np.asarray([120.0 * np.cos(a), 120.0 * np.sin(a), 40.0]),
            45.0, tuple(int(v) for v in rng.integers(60, 255, 3)))
        for i, a in enumerate(np.linspace(0, 2 * np.pi, num_classes,
                                          endpoint=False))]
    cam = synthetic.ring_cameras(cfg, np.zeros(3))[0]
    image, depth, _ = synthetic.render(cfg, cam, spheres)
    return image, depth


def build_prefixes(num_classes: int = 5, num_points: int = 1000,
                   crop: int = 320, h: int = 480, w: int = 640,
                   refine_iters: int = 2, emb_stride: int = 8,
                   seg_out_stride: int = 1, device=None,
                   dtype: torch.dtype = torch.bfloat16,
                   uniforms: Optional[Callable[[int], np.ndarray]] = None,
                   seg_vars=None, pose_vars=None, refine_vars=None):
    """(steps, models): steps maps a prefix's name to `step(c, i)` on
    `device` (cuda by default), `c` a uint8 scalar tensor
    (`initial_carry`); models are the `PredictionModels` (random weights
    from a seed, or the given flax variable trees)."""
    rng = np.random.default_rng(0)
    model_points = rng.normal(size=(num_classes, 1000, 3)).astype(
        np.float32) * 0.05
    models = predict.build_models(
        num_classes, model_points,
        tuple(f"obj{i}" for i in range(num_classes)),
        seg_vars=seg_vars, pose_vars=pose_vars, refine_vars=refine_vars,
        num_points=num_points, crop=crop, refine_iters=refine_iters,
        dtype=dtype, emb_stride=emb_stride, seg_out_stride=seg_out_stride,
        device=device)
    dev = models.device

    image, depth = headline_frame(num_classes, h, w, rng)
    image_d = torch.as_tensor(image, device=dev).permute(2, 0, 1)
    depth_d = torch.as_tensor(depth.astype(np.float32), device=dev)
    intr = torch.tensor([600.0, 600.0, 320.0, 240.0], device=dev)
    scale = torch.tensor(0.001, device=dev)
    cls_ids = torch.arange(1, num_classes + 1, device=dev)
    obj_idx = torch.arange(num_classes, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draws(i) -> torch.Tensor:
        if uniforms is None:
            return torch.rand((num_classes, num_points), generator=gen,
                              device=dev)
        return torch.as_tensor(np.asarray(uniforms(i), np.float32),
                               device=dev)

    def seg(c):
        return predict._segment(models.seg_model, image_d + c)

    def cca(probs, pred_arg):
        return predict._class_mask(
            probs[1:num_classes + 1], pred_arg, cls_ids,
            cca_scale=models.cca_scale, cca_sweeps=models.cca_sweeps,
            cca_rule=models.cca_rule, seg_stride=seg_out_stride,
            full_hw=(h, w))

    def perclass(masks, i):
        r0, c0, win = proj.zoom_window_bbox(masks, crop, h, w)
        clouds, chooses, counts = proj.backproject_choose_zoom(
            depth_d, masks, intr, scale, r0, c0, win, crop, num_points,
            draws(i))
        crops = normalize_imagenet(
            proj.resample_window(image_d, r0, c0, win, crop))
        return clouds, chooses, counts, crops

    def pose(clouds, chooses, crops, iters=refine_iters):
        return predict._pose_stage(models, crops, clouds, chooses, obj_idx,
                                   iters)

    @torch.inference_mode()
    def prefix_seg(c, i):
        probs, pred_arg = seg(c)
        return (pred_arg.sum() * 0).to(torch.uint8), pred_arg[0, 0]

    @torch.inference_mode()
    def prefix_seg_cca(c, i):
        masks, found, _ = cca(*seg(c))
        return (masks.sum() * 0).to(torch.uint8), found

    @torch.inference_mode()
    def prefix_perclass(c, i):
        masks, found, _ = cca(*seg(c))
        clouds, chooses, counts, crops = perclass(masks, i)
        dep = (clouds.sum() + crops.to(torch.float32).sum()
               + chooses.sum()) * 0
        return dep.to(torch.uint8), counts

    @torch.inference_mode()
    def prefix_estimator(c, i):
        masks, found, _ = cca(*seg(c))
        clouds, chooses, counts, crops = perclass(masks, i)
        quat, trans = pose(clouds, chooses, crops, iters=0)
        return (trans.sum() * 0).to(torch.uint8), trans

    @torch.inference_mode()
    def prefix_full(c, i):
        masks, found, _ = cca(*seg(c))
        clouds, chooses, counts, crops = perclass(masks, i)
        quat, trans = pose(clouds, chooses, crops)
        return (trans.sum() * 0).to(torch.uint8), trans

    steps = {"seg": prefix_seg, "seg_cca": prefix_seg_cca,
             "perclass": prefix_perclass, "estimator": prefix_estimator,
             "full": prefix_full}
    return steps, models
