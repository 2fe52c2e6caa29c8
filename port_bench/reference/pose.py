"""The DenseFusion losses, the pose read-out and the clipped Adam update in
plain float32 PyTorch.

The symmetric (ADD-S) distance matches each transformed model point to its
nearest target: the match is found without gradient, in blocks of
candidates, and the distance to the matched target is then differentiated,
which is the gradient of the minimum wherever it is not a tie."""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .geometry import compose_quat_poses, quat_normalize, quat_to_mat

_BLOCK_ELEMS = 1 << 24


def _take(x: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    return x[torch.arange(x.shape[0], device=x.device), which]


@torch.no_grad()
def nearest_targets(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred (B, N, M, 3), target (B, M, 3) -> index (B, N, M) of each
    point's nearest target, by direct-form squared distances."""
    b, n, m = pred.shape[:3]
    block = max(1, min(n, _BLOCK_ELEMS // max(m * m, 1)))
    idx = torch.empty((b, n, m), dtype=torch.int64, device=pred.device)
    for i in range(b):
        for c0 in range(0, n, block):
            p = pred[i, c0:c0 + block]                        # (c, M, 3)
            d2 = ((p[:, :, None, :] - target[i][None, None]) ** 2).sum(-1)
            idx[i, c0:c0 + block] = d2.argmin(-1)
    return idx


class PoseLoss(NamedTuple):
    loss: torch.Tensor
    dis: torch.Tensor
    new_points: torch.Tensor
    new_target: torch.Tensor


def pose_loss(pred_r, pred_t, pred_c, target, model_points, points, is_sym,
              w: float) -> PoseLoss:
    """DenseFusion's estimator loss (lib/loss.py) with ADD-S for symmetric
    samples: mean over candidates of (dis + 2 std) c - w log c."""
    pred_c = pred_c[..., 0]
    rot = quat_to_mat(pred_r)                                  # (B, N, 3, 3)
    pred = (torch.einsum("bmj,bnij->bnmi", model_points, rot)
            + (points + pred_t)[:, :, None, :])                # (B, N, M, 3)
    per_point = torch.linalg.vector_norm(pred - target[:, None], dim=3)
    idx = nearest_targets(pred, target)
    matched = torch.gather(target[:, None].expand(pred.shape), 2,
                           idx[..., None].expand(pred.shape))
    sym_point = torch.linalg.vector_norm(pred - matched, dim=3)
    sym = is_sym.to(torch.bool)[:, None, None]
    per_point = torch.where(sym, sym_point, per_point)
    dis = per_point.mean(dim=2)
    std = per_point.std(dim=2, correction=1)
    loss = torch.mean((dis + 2.0 * std) * pred_c
                      - w * torch.log(torch.clamp(pred_c, min=1e-12)), dim=1)
    which = torch.argmax(pred_c, dim=1)
    best_r = quat_normalize(_take(pred_r, which))
    best_t = _take(points, which) + _take(pred_t, which)
    best_rot = quat_to_mat(best_r)
    new_points = torch.matmul(points - best_t[:, None], best_rot)
    new_target = torch.matmul(target - best_t[:, None], best_rot)
    return PoseLoss(loss.mean(), _take(dis[..., None], which)[:, 0],
                    new_points.detach(), new_target.detach())


def refine_loss(pred_r, pred_t, target, model_points, points, is_sym):
    """The refiner's loss (lib/loss_refiner.py): (mean dis, dis (B,),
    new_points, new_target)."""
    rot = quat_to_mat(pred_r)
    pred = torch.matmul(model_points, rot.transpose(1, 2)) + pred_t[:, None]
    diff = pred - target
    per_point = torch.sqrt(torch.sum(diff * diff, dim=2) + 1e-12)
    tt = torch.sum(target * target, dim=2)
    pp = torch.sum(pred * pred, dim=2, keepdim=True)
    d2 = pp + tt[:, None, :] - 2.0 * torch.matmul(pred, target.transpose(1, 2))
    idx = torch.argmin(d2, dim=2)
    matched = torch.gather(target, 1, idx[..., None].expand(-1, -1, 3))
    sdiff = pred - matched
    sym_pp = torch.sqrt(torch.sum(sdiff * sdiff, dim=2) + 1e-12)
    per_point = torch.where(is_sym.to(torch.bool)[:, None], sym_pp, per_point)
    dis = per_point.mean(dim=1)
    new_points = torch.matmul(points - pred_t[:, None], rot)
    new_target = torch.matmul(target - pred_t[:, None], rot)
    return dis.mean(), dis, new_points.detach(), new_target.detach()


def rebase_points(quat, trans, points):
    return torch.matmul(points - trans[:, None, :], quat_to_mat(quat))


def refine_chain(refiner, quat, trans, points, emb, obj_idx, iters: int):
    """`iters` refiner passes from the pose (quat, trans), each composing
    its correction onto the pose."""
    new_points = rebase_points(quat, trans, points)
    for _ in range(iters):
        dr, dt = refiner(new_points, emb, obj_idx)
        quat, trans = compose_quat_poses(quat, trans, quat_normalize(dr), dt)
        new_points = rebase_points(quat, trans, points)
    return quat, trans


class ClippedAdam:
    """Adam (0.9, 0.999, eps 1e-8) behind a global-norm clip, in plain
    tensor arithmetic: g <- g * min(1, clip / |g|), then Adam's
    bias-corrected step. `lr` is rounded to float32."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 clip: float, t: int = 0, m=None, v=None):
        """From step `t` with moments `m`, `v` ({leaf: tensor}; zeros where
        None or a leaf is missing)."""
        self.params = params
        self.lr = float(torch.tensor(lr, dtype=torch.float32))
        self.clip = clip
        self.t = t
        m, v = m or {}, v or {}
        self.m = {k: m[k].clone() if k in m else torch.zeros_like(p)
                  for k, p in params.items()}
        self.v = {k: v[k].clone() if k in v else torch.zeros_like(p)
                  for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update; returns the clipped gradients as Adam took
        them."""
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        taken = {}
        for k, g in grads.items():
            g = g * scale
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(eps)
            self.params[k].addcdiv_(self.m[k], denom,
                                    value=-self.lr / (1 - b1 ** self.t))
        return taken


def leaf_grads(module: torch.nn.Module, loss: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    names, params = zip(*[(n, p) for n, p in module.named_parameters()
                          if p.requires_grad])
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}

