"""DenseFusion two-phase training and evaluation (port of
`autoposeestimation_tpu/train/densefusion.py`).

A batch comes in as the JAX package's Loader gives it, a dict of numpy
arrays (or tensors): img (B, S, S, 3) normalized crops, channels last,
cloud (B, N, 3), choose (B, N), target and model_points (B, M, 3), obj_idx
(B,), is_sym (B,) bool, optionally target_t (B, 3). `train()` and
`experiments/eval.py::evaluate` take that layout; `to_device` turns it into
the steps' own (img (B, 3, S, S) contiguous, on the networks' device), which
`estimator_step`, `refiner_step` and `eval_step_full` take.

As in the JAX trainer: a true batch of 8 per optimizer step, the
margin-triggered phase machine on the host (`TrainerState.
maybe_transition`), refiner-phase gradients summed over the `iteration`
rebased refine passes, Adam behind a global-norm clip, and the best
`pose_model.npz` / `pose_refine_model.npz` written in the JAX package's
checkpoint format with the `losses.json` curve log beside them."""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import weights
from ..models import losses
from ..models.common import init_like_flax
from ..models.densefusion import PoseNet, PoseRefineNet
from ..utils.device import resolve_device
from ..utils.timing import JsonCurveLog
from . import checkpoints


_DROPOUT_SEED = 1234


@dataclass
class DFConfig:
    """Hyperparameters (the JAX `DFConfig`'s defaults, reference
    train.py:34-49)."""

    batch_size: int = 8
    lr: float = 1e-4
    lr_rate: float = 0.3
    w: float = 0.015
    w_rate: float = 0.3
    decay_margin: float = 0.016
    refine_margin: float = 0.010
    noise_trans: float = 0.03
    iteration: int = 2
    nepoch: int = 500
    refine_epoch_margin: int = 400
    start_epoch: int = 1
    num_points: int = 1000
    num_points_mesh: int = 500
    with_sym: bool = True
    # bf16 distances in the symmetric-loss training kernel (evaluation and
    # checkpoint selection stay f32)
    sym_bf16: bool = True
    # global-norm gradient clip (see make_optimizer; <= 0 disables)
    grad_clip: float = 10.0


class ClippedAdam:
    """Adam (beta 0.9/0.999, eps 1e-8) behind optax's global-norm clip:
    g * where(norm < clip, 1, clip / norm). `step` returns the norm taken
    before the clip."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 clip: float = 10.0):
        self.params: List[torch.nn.Parameter] = list(params)
        self.clip = clip
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if self.clip and self.clip > 0:
            scale = torch.where(gnorm < self.clip, 1.0, self.clip / gnorm)
            for g in grads:
                g.mul_(scale)
        self.adam.step()
        return gnorm


def make_optimizer(params, lr: float, clip: float = 10.0) -> ClippedAdam:
    return ClippedAdam(params, lr, clip)


def set_lr(optimizer: ClippedAdam, lr: float) -> ClippedAdam:
    for group in optimizer.adam.param_groups:
        group["lr"] = lr
    return optimizer


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch in the JAX package's layout (numpy arrays or tensors, img
    (B, S, S, 3)) -> tensors on `device` in the steps' layout: img
    (B, 3, S, S) contiguous, floats as f32, integers as int64, booleans
    kept."""
    out = {}
    for key, val in batch.items():
        t = val if isinstance(val, torch.Tensor) else torch.as_tensor(
            np.asarray(val))
        if t.is_floating_point():
            t = t.to(torch.float32)
        elif t.dtype != torch.bool:
            t = t.to(torch.int64)
        out[key] = t.to(device)
    img = out["img"]
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError("img must be (B, S, S, 3), channels last: "
                         f"{tuple(img.shape)}")
    out["img"] = img.permute(0, 3, 1, 2).contiguous()
    return out


def estimator_step(posenet: PoseNet, optimizer: ClippedAdam,
                   batch: Dict[str, torch.Tensor], w: float,
                   with_sym: bool = True, sym_bf16: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """One estimator phase step with dropout from `generator`. Returns
    {loss, dis, gnorm}, gnorm the gradient norm before the clip."""
    optimizer.zero_grad()
    pred_r, pred_t, pred_c, _ = posenet(
        batch["img"], batch["cloud"], batch["choose"], batch["obj_idx"],
        train=True, generator=generator)
    out = losses.pose_loss(pred_r, pred_t, pred_c, batch["target"],
                           batch["model_points"], batch["cloud"],
                           batch["is_sym"], w=w, with_sym=with_sym,
                           sym_bf16=sym_bf16)
    out.loss.backward()
    gnorm = optimizer.step()
    return {"loss": out.loss.detach(), "dis": out.dis.detach().mean(),
            "gnorm": gnorm}


def refiner_step(posenet: PoseNet, refiner: PoseRefineNet,
                 optimizer: ClippedAdam, batch: Dict[str, torch.Tensor],
                 w: float, iteration: int = 2, with_sym: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """One refiner phase step: the frozen estimator's forward, then
    `iteration` rebased refiner passes whose mean distances are summed into
    one loss. Returns {dis}, the last pass's mean distance."""
    with torch.no_grad():
        pred_r, pred_t, pred_c, emb = posenet(
            batch["img"], batch["cloud"], batch["choose"], batch["obj_idx"])
        est = losses.pose_loss(pred_r, pred_t, pred_c, batch["target"],
                               batch["model_points"], batch["cloud"],
                               batch["is_sym"], w=w, with_sym=with_sym)
    optimizer.zero_grad()
    new_points, new_target = est.new_points, est.new_target
    total = 0.0
    for _ in range(iteration):
        dr, dt = refiner(new_points, emb, batch["obj_idx"])
        mean_dis, dis, new_points, new_target = losses.refine_loss(
            dr, dt, new_target, batch["model_points"], new_points,
            batch["is_sym"], with_sym=with_sym)
        total = total + mean_dis
    total.backward()
    optimizer.step()
    return {"dis": dis.detach().mean()}


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


@dataclass
class TrainerState:
    """Host-side two-phase state machine."""

    cfg: DFConfig
    posenet: PoseNet
    refiner: PoseRefineNet
    optimizer: ClippedAdam
    device: torch.device
    refine_optimizer: Optional[ClippedAdam] = None
    decay_start: bool = False
    refine_start: bool = False
    best_test: float = float("inf")
    lr: float = 1e-4
    w: float = 0.015

    def maybe_transition(self, epoch: int) -> None:
        """train.py:396-420 phase machine."""
        cfg = self.cfg
        if self.best_test < cfg.decay_margin and not self.decay_start:
            self.decay_start = True
            self.lr *= cfg.lr_rate
            self.w *= cfg.w_rate
            set_lr(self.optimizer, self.lr)
        if ((self.best_test < cfg.refine_margin
             or epoch >= cfg.refine_epoch_margin) and not self.refine_start):
            self.refine_start = True
            self.refine_optimizer = make_optimizer(
                self.refiner.parameters(), self.lr, cfg.grad_clip)


def create_trainer(num_obj: int, cfg: Optional[DFConfig] = None,
                   dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                   device=None) -> TrainerState:
    """Both networks initialized from `seed` the way flax initializes them
    (on the CPU, so a seed gives the same weights on every device), moved
    to `device` (cuda by default), and the estimator's optimizer."""
    cfg = cfg or DFConfig()
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    posenet, refiner = PoseNet(num_obj, dtype), PoseRefineNet(num_obj, dtype)
    for net in (posenet, refiner):
        init_like_flax(net, gen)
        net.to(dev)
    return TrainerState(cfg, posenet, refiner,
                        make_optimizer(posenet.parameters(), cfg.lr,
                                       cfg.grad_clip),
                        dev, lr=cfg.lr, w=cfg.w)


def train(state: TrainerState, train_batches: Callable[[], Iterable],
          test_batches: Callable[[], Iterable], out_dir: str,
          log_dir: Optional[str] = None, epochs: Optional[int] = None,
          epoch_callback=None) -> TrainerState:
    """The two-phase loop. `train_batches`/`test_batches` return a fresh
    iterator of batches per epoch in the JAX package's layout (numpy or
    tensors, img (B, S, S, 3); see `to_device`). Each epoch draws its
    dropout from a generator seeded by the epoch, so a run repeats. Artifacts:
    pose_model.npz / pose_refine_model.npz on the best test distance, and
    losses.json."""
    cfg = state.cfg
    dev = state.device
    os.makedirs(out_dir, exist_ok=True)
    log = JsonCurveLog(os.path.join(log_dir or out_dir, "losses.json"))

    for epoch in range(cfg.start_epoch, (epochs or cfg.nepoch)):
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(_DROPOUT_SEED + epoch)
        epoch_losses, epoch_dis, epoch_gnorms = [], [], []
        for batch in train_batches():
            batch = to_device(batch, dev)
            if state.refine_start:
                metrics = refiner_step(state.posenet, state.refiner,
                                       state.refine_optimizer, batch,
                                       state.w, cfg.iteration, cfg.with_sym)
                epoch_losses.append(0.0)
            else:
                metrics = estimator_step(state.posenet, state.optimizer,
                                         batch, state.w, cfg.with_sym,
                                         cfg.sym_bf16, gen)
                epoch_losses.append(float(metrics["loss"]))
                epoch_gnorms.append(float(metrics["gnorm"]))
            epoch_dis.append(float(metrics["dis"]))

        test_dis, test_terr = [], []
        for batch in test_batches():
            batch = to_device(batch, dev)
            dis, _, trans = eval_step_full(
                state.posenet, state.refiner, batch, state.w,
                state.refine_start, cfg.iteration, cfg.with_sym)
            if "target_t" in batch:
                test_terr.extend(torch.linalg.vector_norm(
                    trans - batch["target_t"], dim=1).tolist())
            test_dis.extend(dis.tolist())
        test_mean = float(np.mean(test_dis)) if test_dis else float("inf")

        log.append(losses=float(np.mean(epoch_losses or [0.0])),
                   train_dists=float(np.mean(epoch_dis or [0.0])),
                   grad_norm_max=float(np.max(epoch_gnorms or [0.0])),
                   test_dists=test_mean,
                   test_t_errs=float(np.mean(test_terr)) if test_terr
                   else float("nan"),
                   epoch_seconds=time.time() - t0)

        if test_mean <= state.best_test:
            state.best_test = test_mean
            meta = {"epoch": epoch, "test_dis": test_mean}
            if state.refine_start:
                checkpoints.save_checkpoint(
                    os.path.join(out_dir, "pose_refine_model"),
                    weights.refiner_variables(state.refiner), meta)
            else:
                checkpoints.save_checkpoint(
                    os.path.join(out_dir, "pose_model"),
                    weights.posenet_variables(state.posenet), meta)

        state.maybe_transition(epoch)
        if epoch_callback is not None:
            epoch_callback(state, epoch, test_mean)
    return state
