"""The port's counterpart of `__graft_entry__.py`: `entry()`, the
flagship forward with example inputs, and `dryrun_multichip`, the
multi-rank dry run of the training, serving and reconstruction paths
(`parallel/dryrun.py`).

`entry()` returns `(fn, example_args)`: `fn(*example_args)` runs the
single-frame graph `pipeline/predict.py::_predict_frame` (normalize, U-Net
segmentation, per-class best-component CCA, zoom-window crop, choose and
backproject, one batched PoseNet, 2 refiner iterations) at the JAX entry's
settings: 2 classes, 500 points, crop 160, a 640x480 random uint8 frame
with depth uniform in 400-900, intrinsics (600, 600, 320, 240), depth
scale 0.001, random weights from seed 0. The point-selection draws are a
(2, 500) `uniforms` tensor from a CPU generator seeded with 0, so every
device gets the same draws.

    from autoposeestimation_tpu_torch.graft_entry import entry
    fn, args = entry()                 # on the card, bf16
    out = fn(*args)                    # found, masks, quats, positions, ...
"""
from __future__ import annotations

import numpy as np
import torch

from .parallel.dryrun import dryrun_multichip
from .pipeline import predict
from .utils.device import resolve_device

__all__ = ["entry", "dryrun_multichip"]

NUM_CLASSES = 2
CLASSES = ("obj_a", "obj_b")
NUM_POINTS = 500
CROP = 160
REFINE_ITERS = 2
FRAME_HW = (480, 640)
DEPTH_SCALE = 0.001


def forward(models: predict.PredictionModels, image, depth, intr,
            depth_scale, uniforms):
    """The frame graph on the models' device, without autograd."""
    with torch.inference_mode():
        return predict._predict_frame(models, image, depth, intr,
                                      depth_scale, uniforms)


def _entry(device=None, dtype: torch.dtype = torch.bfloat16, hw=FRAME_HW,
           seg_vars=None, pose_vars=None, refine_vars=None):
    """`entry()` at a frame of `hw` (intrinsics scaled with its width,
    the principal point at its centre) and, where given, the JAX package's
    flax variable trees as the weights."""
    dev = resolve_device(device)
    h, w = hw
    # the JAX entry's draws, in its order: model points, frame, depth
    rng = np.random.default_rng(0)
    model_points = rng.normal(size=(NUM_CLASSES, 100, 3)).astype(
        np.float32) * 0.05
    models = predict.build_models(
        NUM_CLASSES, model_points, CLASSES, seg_vars=seg_vars,
        pose_vars=pose_vars, refine_vars=refine_vars, num_points=NUM_POINTS,
        crop=CROP, refine_iters=REFINE_ITERS, dtype=dtype, device=dev)
    image = torch.as_tensor(rng.integers(0, 255, (h, w, 3)),
                            dtype=torch.uint8).to(dev)
    depth = torch.as_tensor(rng.uniform(400, 900, (h, w)),
                            dtype=torch.float32).to(dev)
    f = 600.0 * w / FRAME_HW[1]
    intr = torch.tensor([f, f, w / 2.0, h / 2.0], dtype=torch.float32,
                        device=dev)
    uniforms = torch.rand((NUM_CLASSES, NUM_POINTS),
                          generator=torch.Generator().manual_seed(0)).to(dev)
    scale = torch.tensor(DEPTH_SCALE, dtype=torch.float32, device=dev)
    return forward, (models, image, depth, intr, scale, uniforms)


def entry(device=None, dtype: torch.dtype = torch.bfloat16):
    """(fn, example_args): the flagship forward and its inputs, on the card
    unless `device` says otherwise (no card and no `device`: it raises)."""
    return _entry(device, dtype)
