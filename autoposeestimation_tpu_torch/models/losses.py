"""DenseFusion ADD(-S) losses (differentiable), the pose-extraction helpers
and the ADD(-S) metric (port of the pose part of `autoposeestimation_tpu/
models/losses.py`). Everything is batched over a leading sample axis. The
rebased clouds the losses return for the refiner are detached, as the JAX
version stops their gradient."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import addloss
from ..utils import transforms as T


class PoseLossOut(NamedTuple):
    loss: torch.Tensor        # scalar
    dis: torch.Tensor         # (B,) best-candidate ADD(-S) distance
    new_points: torch.Tensor  # (B, N, 3) cloud rebased for the refiner
    new_target: torch.Tensor  # (B, M, 3) target rebased for the refiner
    best_r: torch.Tensor      # (B, 4) max-confidence quaternion
    best_t: torch.Tensor      # (B, 3) max-confidence translation


def _take(x: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), which (B,) -> (B, D)."""
    return x[torch.arange(x.shape[0], device=x.device), which]


def pose_loss(pred_r, pred_t, pred_c, target, model_points, points, is_sym,
              w: float = 0.015, with_sym: bool = True,
              sym_bf16: bool = False) -> PoseLossOut:
    """DenseFusion estimator loss (lib/loss.py). pred_r (B, N, 4), pred_t
    (B, N, 3), pred_c (B, N, 1) or (B, N), target/model_points (B, M, 3),
    points (B, N, 3), is_sym (B,) bool. Symmetric samples take the matched
    moments of `ops.addloss.sym_moments` (one call for the whole batch,
    differentiable; `sym_bf16` runs its distances in bf16); `with_sym=False`
    skips them."""
    if pred_c.dim() == 3:
        pred_c = pred_c[..., 0]
    rot = T.quat_to_mat(pred_r)                                # (B, N, 3, 3)
    pred = (torch.einsum("bmj,bnij->bnmi", model_points, rot)
            + (points + pred_t)[:, :, None, :])                # (B, N, M, 3)
    per_point = torch.linalg.vector_norm(pred - target[:, None], dim=3)
    dis = per_point.mean(dim=2)
    std = per_point.std(dim=2, correction=1)
    if with_sym:
        dis_s, std_s = addloss.sym_moments(pred_r, pred_t, points,
                                           model_points, target,
                                           bf16=sym_bf16)
        sym = is_sym.to(torch.bool)[:, None]
        dis = torch.where(sym, dis_s, dis)
        std = torch.where(sym, std_s, std)
    loss = torch.mean((dis + 2.0 * std) * pred_c
                      - w * torch.log(torch.clamp(pred_c, min=1e-12)), dim=1)

    which = torch.argmax(pred_c, dim=1)
    best_r = T.quat_normalize(_take(pred_r, which))
    best_t = _take(points, which) + _take(pred_t, which)
    best_rot = T.quat_to_mat(best_r)
    # x' = R^T (x - t): the rebase into the predicted frame
    new_points = torch.matmul(points - best_t[:, None], best_rot)
    new_target = torch.matmul(target - best_t[:, None], best_rot)
    return PoseLossOut(loss.mean(), _take(dis[..., None], which)[:, 0],
                       new_points.detach(), new_target.detach(), best_r,
                       best_t)


def refine_loss(pred_r, pred_t, target, model_points, points, is_sym,
                with_sym: bool = True):
    """Refiner loss (lib/loss_refiner.py) for one global correction per
    sample: pred_r (B, 4), pred_t (B, 3). The expansion form only picks the
    nearest target; the matched distance is measured in direct form with a
    1e-12 floor inside the sqrt. Returns (mean dis, dis (B,), new_points,
    new_target)."""
    rot = T.quat_to_mat(pred_r)                                # (B, 3, 3)
    pred = torch.matmul(model_points, rot.transpose(1, 2)) + pred_t[:, None]
    diff = pred - target
    per_point = torch.sqrt(torch.sum(diff * diff, dim=2) + 1e-12)
    if with_sym:
        tt = torch.sum(target * target, dim=2)
        pp = torch.sum(pred * pred, dim=2, keepdim=True)
        d2 = pp + tt[:, None, :] - 2.0 * torch.matmul(pred,
                                                      target.transpose(1, 2))
        idx = torch.argmin(d2, dim=2)                          # (B, M)
        matched = torch.gather(target, 1, idx[..., None].expand(-1, -1, 3))
        sdiff = pred - matched
        sym_pp = torch.sqrt(torch.sum(sdiff * sdiff, dim=2) + 1e-12)
        per_point = torch.where(is_sym.to(torch.bool)[:, None], sym_pp,
                                per_point)
    dis = per_point.mean(dim=1)
    new_points = torch.matmul(points - pred_t[:, None], rot)
    new_target = torch.matmul(target - pred_t[:, None], rot)
    return dis.mean(), dis, new_points.detach(), new_target.detach()


def estimator_prediction(pred_r, pred_t, pred_c, points, topk: int = 1):
    """Max-confidence candidate -> (quat (B, 4), trans (B, 3)). `topk` > 1
    averages the top-k candidates weighted by confidence, quaternions
    sign-aligned to the best one first."""
    if pred_c.dim() == 3:
        pred_c = pred_c[..., 0]
    if topk <= 1:
        which = torch.argmax(pred_c, dim=1)
        quat = T.quat_normalize(_take(pred_r, which))
        return quat, _take(points, which) + _take(pred_t, which)
    conf, idx = torch.topk(pred_c, topk, dim=1)                # (B, K)

    def gather(x):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    quats = T.quat_normalize(gather(pred_r))
    sign = torch.sign(torch.sum(quats * quats[:, :1], dim=-1, keepdim=True))
    quats = quats * torch.where(sign == 0, 1.0, sign)
    wgt = conf / torch.clamp(conf.sum(dim=1, keepdim=True), min=1e-12)
    quat = T.quat_normalize(torch.sum(quats * wgt[..., None], dim=1))
    trans = torch.sum((gather(points) + gather(pred_t)) * wgt[..., None],
                      dim=1)
    return quat, trans


def rebase_points(quat, trans, points):
    """The cloud expressed in the current pose estimate's frame."""
    rot = T.quat_to_mat(quat)
    return torch.matmul(points - trans[:, None, :], rot)


def compose_refined(delta_r, delta_t, quat, trans):
    """current pose @ delta."""
    return T.compose_quat_poses(quat, trans, T.quat_normalize(delta_r),
                                delta_t)


def add_metric(quat, trans, target, model_points, is_sym,
               with_sym: bool = True):
    """Mean distance between the predicted-pose model points and the target
    points (B,); symmetric samples use nearest-point matching."""
    rot = T.quat_to_mat(quat)
    pred = torch.matmul(model_points, rot.transpose(1, 2)) + trans[:, None]
    per = torch.linalg.vector_norm(pred - target, dim=2)
    if with_sym:
        tt = torch.sum(target * target, dim=2)
        pp = torch.sum(pred * pred, dim=2)
        d2 = (pp[:, :, None] + tt[:, None, :]
              - 2.0 * torch.matmul(pred, target.transpose(1, 2)))
        sym_per = torch.sqrt(torch.clamp(d2.amin(dim=2), min=0.0))
        per = torch.where(is_sym.to(torch.bool)[:, None], sym_per, per)
    return per.mean(dim=1)
