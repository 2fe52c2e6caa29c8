"""The DenseFusion training step cut into stages (port of
`autoposeestimation_tpu/utils/train_stages.py`).

Each stage is a step function `step(carry, i) -> (carry, out)` whose next
call's input depends on the previous output, so that a chain of calls is
timed as dependent work; `utils/flops.py` counts one call of the same
function. The stages follow the estimator and refiner steps of
`train/densefusion.py`: the PSPNet forward, the PoseNet forward, the
symmetric loss forward (hand kernel row 1, `csrc/sym_moments.cu`) and
forward and backward (row 2, `csrc/sym_moments_train.cu`), a whole
estimator step with exact and with bf16 distances in the loss kernel, and
the refiner step. The refiner step's frozen estimator forward does not
change from call to call, so it is computed once here, as the JAX
package's timing loop hoists it; a call costs the refiner's forward,
backward and Adam update.

The inputs are drawn from `np.random.default_rng(1)` in the order of the
JAX package's `build_stages`; `pose_vars` / `refine_vars` (the JAX
package's flax variable trees) set the initial weights, else the networks
are initialized from a fixed seed as flax initializes them. An estimator
step's dropout comes from a `torch.Generator` seeded with the call's `i`.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from .. import weights
from ..models import losses
from ..models.common import init_like_flax
from ..models.densefusion import PoseNet, PoseRefineNet
from ..train import densefusion as dft
from .device import resolve_device

TRAIN_STAGE_ORDER = ("pspnet_fwd", "posenet_fwd", "symloss_fwd",
                     "symloss_fwd_bwd", "estimator_step",
                     "estimator_step_symbf16", "refiner_step")
W = 0.015      # the loss's confidence weight (DFConfig.w)
LR = 1e-4


def inputs(num_obj: int, bs: int, n: int, m: int, crop: int) -> dict:
    """The stages' batch in the JAX package's layout (numpy, img
    (B, S, S, 3)), drawn as its `build_stages` draws it."""
    rng = np.random.default_rng(1)
    return {
        "img": rng.normal(size=(bs, crop, crop, 3)).astype(np.float32),
        "cloud": (rng.normal(size=(bs, n, 3)) * 0.1).astype(np.float32),
        "choose": rng.integers(0, crop * crop, (bs, n)),
        "target": (rng.normal(size=(bs, m, 3)) * 0.05).astype(np.float32),
        "model_points": (rng.normal(size=(bs, m, 3)) * 0.05).astype(
            np.float32),
        "obj_idx": rng.integers(0, num_obj, bs),
        "is_sym": np.asarray([True, False] * (bs // 2)),
    }


def build_stages(num_obj: int = 5, bs: int = 8, n: int = 1000,
                 m: Optional[int] = None, crop: int = 320, device=None,
                 dtype: torch.dtype = torch.bfloat16, pose_vars=None,
                 refine_vars=None):
    """(steps, carries): steps maps a stage's name to `step(carry, i)`,
    carries to its initial carry, on `device` (cuda by default). The
    estimator stages' carries are (PoseNet, ClippedAdam) pairs of their
    own, the refiner's (PoseRefineNet, ClippedAdam); a step updates its
    carry in place and returns it."""
    dev = resolve_device(device)
    if m is None:
        m = dft.DFConfig.num_points_mesh
    batch = dft.to_device(inputs(num_obj, bs, n, m, crop), dev)
    img, cloud, choose = batch["img"], batch["cloud"], batch["choose"]
    target, model_points = batch["target"], batch["model_points"]
    obj_idx, is_sym = batch["obj_idx"], batch["is_sym"]

    gen = torch.Generator().manual_seed(0)
    posenet, refiner = PoseNet(num_obj, dtype), PoseRefineNet(num_obj, dtype)
    for net, variables, to_state in (
            (posenet, pose_vars, weights.posenet_state_dict),
            (refiner, refine_vars, weights.refiner_state_dict)):
        if variables is None:
            init_like_flax(net, gen)
        else:
            net.load_state_dict(to_state(variables))
        net.to(dev)

    @torch.no_grad()
    def pspnet_fwd(c, i):
        emb_map = posenet.cnn(img + c)
        return (emb_map.sum() * 0).to(torch.float32), emb_map[0, 0, 0, 0]

    @torch.no_grad()
    def posenet_fwd(c, i):
        pr, pt, pc, emb = posenet(img + c, cloud, choose, obj_idx)
        return (pr.sum() * 0).to(torch.float32), pt[0, 0]

    # the PoseNet outputs that feed the loss stages, computed once so that
    # those stages hold the loss alone
    with torch.no_grad():
        pr0, pt0, pc0, emb0 = posenet(img, cloud, choose, obj_idx)
        est0 = losses.pose_loss(pr0, pt0, pc0, target, model_points, cloud,
                                is_sym, w=W, with_sym=True)

    @torch.no_grad()
    def symloss_fwd(c, i):
        out = losses.pose_loss(pr0 + c, pt0, pc0, target, model_points,
                               cloud, is_sym, w=W, with_sym=True)
        return (out.loss * 0).to(torch.float32), out.loss

    def symloss_fwd_bwd(c, i):
        args = [(pr0 + c).requires_grad_(), pt0.clone().requires_grad_(),
                pc0.clone().requires_grad_(), cloud.clone().requires_grad_()]
        out = losses.pose_loss(args[0], args[1], args[2], target,
                               model_points, args[3], is_sym, w=W,
                               with_sym=True)
        g = torch.autograd.grad(out.loss, args)
        return (g[0].sum() * 0).to(torch.float32), g[0][0, 0, 0]

    def make_est_step(sym_bf16: bool):
        def est_step(carry, i):
            net, opt = carry
            metrics = dft.estimator_step(
                net, opt, batch, W, with_sym=True, sym_bf16=sym_bf16,
                generator=torch.Generator(device=dev).manual_seed(int(i)))
            return carry, metrics["loss"]
        return est_step

    def ref_step(carry, i):
        net, opt = carry
        opt.zero_grad()
        new_points, new_target = est0.new_points, est0.new_target
        total = 0.0
        for _ in range(2):
            dr, dt = net(new_points, emb0, obj_idx)
            mean_dis, dis, new_points, new_target = losses.refine_loss(
                dr, dt, new_target, model_points, new_points, is_sym,
                with_sym=True)
            total = total + mean_dis
        total.backward()
        opt.step()
        return carry, dis.detach().mean()

    def estimator_carry():
        net = copy.deepcopy(posenet)
        return net, dft.make_optimizer(net.parameters(), LR)

    zero = torch.zeros((), device=dev)
    steps = {
        "pspnet_fwd": pspnet_fwd,
        "posenet_fwd": posenet_fwd,
        "symloss_fwd": symloss_fwd,
        "symloss_fwd_bwd": symloss_fwd_bwd,
        "estimator_step": make_est_step(False),
        "estimator_step_symbf16": make_est_step(True),
        "refiner_step": ref_step,
    }
    carries = {
        "pspnet_fwd": zero,
        "posenet_fwd": zero,
        "symloss_fwd": zero,
        "symloss_fwd_bwd": zero,
        "estimator_step": estimator_carry(),
        "estimator_step_symbf16": estimator_carry(),
        "refiner_step": (refiner, dft.make_optimizer(refiner.parameters(),
                                                     LR)),
    }
    return steps, carries
