"""DenseFusion ADD(-S) losses (differentiable), the pose-extraction helpers,
the ADD(-S) metric and the segmentation loss and metrics (port of
`autoposeestimation_tpu/models/losses.py`). Everything is batched over a
leading sample axis. The rebased clouds the losses return for the refiner
are detached, as the JAX version stops their gradient. Segmentation logits
are NCHW; no function here makes the host wait for the device."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed.nn.functional as dist_fn

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


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------

def jaccard_loss(labels: torch.Tensor, logits: torch.Tensor,
                 eps: float = 1e-7, per_column: bool = False,
                 group=None) -> torch.Tensor:
    """Soft-jaccard loss over the classes present in the batch; labels
    (B, H, W) int, logits (B, C, H, W). `per_column=True` is the
    reference's exact reduction, which sums over batch and height only and
    averages the per-(class, image column) IoUs. With a process `group`
    the batch is the union of its ranks' rows: the sums are all-reduced,
    differentiably, and every rank returns the global batch's loss."""
    c = logits.shape[1]
    probas = torch.softmax(logits, dim=1)
    classes = torch.arange(c, device=logits.device)
    onehot = (labels[:, None] == classes[None, :, None, None]).to(
        probas.dtype)
    dims = (0, 2) if per_column else (0, 2, 3)
    intersection = (probas * onehot).sum(dims)      # (C, W) or (C,)
    total = (probas + onehot).sum(dims)
    labelled = onehot.sum((0, 2, 3))
    if group is not None:
        n = intersection.numel()
        sums = dist_fn.all_reduce(torch.cat(
            [intersection.reshape(-1), total.reshape(-1), labelled]),
            group=group)
        intersection = sums[:n].reshape(intersection.shape)
        total = sums[n:2 * n].reshape(total.shape)
        labelled = sums[2 * n:]
    union = total - intersection
    per_class = intersection / (union + eps)
    present = labelled > 0
    n_present = present.to(per_class.dtype).sum()
    if per_column:
        masked = torch.where(present[:, None], per_class, 0.0)
        mean = masked.sum() / torch.clamp(n_present * masked.shape[1],
                                          min=1.0)
    else:
        mean = torch.where(present, per_class, 0.0).sum() / torch.clamp(
            n_present, min=1.0)
    return 1.0 - mean


def confusion_matrix(pred: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(C, C) int64 counts, rows the ground truth."""
    x = (pred.reshape(-1) + num_classes * labels.reshape(-1)).to(torch.int64)
    counts = torch.zeros(num_classes ** 2, dtype=torch.int64,
                         device=x.device).scatter_add_(0, x,
                                                       torch.ones_like(x))
    return counts.reshape(num_classes, num_classes)


def iou_from_confusion(conf: torch.Tensor):
    """(per-class IoU (C,), mIoU over classes 1..): background is left out
    of the mean; an absent class (no pixel predicted or labelled) has IoU
    NaN and leaves the mean."""
    conf = conf.to(torch.float32)
    tp = torch.diagonal(conf)
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    iou = torch.where(denom > 0, tp / torch.clamp(denom, min=1.0),
                      torch.nan)
    fg = iou[1:]
    valid = ~torch.isnan(fg)
    miou = torch.where(valid, fg, 0.0).sum() / torch.clamp(
        valid.to(torch.float32).sum(), min=1.0)
    return iou, miou
