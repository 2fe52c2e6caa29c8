"""DenseFusion evaluation steps (port of `eval_step` / `eval_step_full` of
`autoposeestimation_tpu/train/densefusion.py`; training comes later).

A batch is a dict of tensors on the networks' device: img (B, 3, S, S)
normalized crops, cloud (B, N, 3), choose (B, N), target and model_points
(B, M, 3), obj_idx (B,), is_sym (B,) bool."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..models import losses
from ..models.densefusion import PoseNet, PoseRefineNet


@dataclass
class EvalModels:
    """What evaluation needs of a trainer: the two networks, the confidence
    weight `w` and whether symmetric samples use ADD-S."""

    posenet: PoseNet
    refiner: Optional[PoseRefineNet]
    w: float = 0.015
    with_sym: bool = True


@torch.inference_mode()
def eval_step_full(posenet: PoseNet, refiner: Optional[PoseRefineNet],
                   batch: Dict[str, torch.Tensor], w: float,
                   refine_start: bool = False, iteration: int = 2,
                   with_sym: bool = True):
    """Per-sample test distances (B,) and the composed predicted pose
    (quat (B, 4), trans (B, 3)); with `refine_start`, `iteration` rebased
    refiner steps follow the estimator."""
    pred_r, pred_t, pred_c, emb = posenet(batch["img"], batch["cloud"],
                                          batch["choose"], batch["obj_idx"])
    est = losses.pose_loss(pred_r, pred_t, pred_c, batch["target"],
                           batch["model_points"], batch["cloud"],
                           batch["is_sym"], w=w, with_sym=with_sym)
    dis = est.dis
    quat, trans = losses.estimator_prediction(pred_r, pred_t, pred_c,
                                              batch["cloud"])
    if refine_start:
        new_points, new_target = est.new_points, est.new_target
        for _ in range(iteration):
            dr, dt = refiner(new_points, emb, batch["obj_idx"])
            _, dis, new_points, new_target = losses.refine_loss(
                dr, dt, new_target, batch["model_points"], new_points,
                batch["is_sym"], with_sym=with_sym)
            quat, trans = losses.compose_refined(dr, dt, quat, trans)
    return dis, quat, trans


def eval_step(posenet, refiner, batch, w: float, refine_start: bool = False,
              iteration: int = 2, with_sym: bool = True) -> torch.Tensor:
    """Per-sample test distances (B,)."""
    return eval_step_full(posenet, refiner, batch, w, refine_start,
                          iteration, with_sym)[0]
