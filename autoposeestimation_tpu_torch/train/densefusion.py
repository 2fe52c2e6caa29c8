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
checkpoint format with the `losses.json` curve log beside them. Every epoch
`train()` also writes `trainer_resume.npz`, a snapshot of both networks,
both optimizers and the phase machine in the JAX trainer's layout, which
`resume_trainer` restores (either package's), and, given test batches with
the raw frames, the per-epoch pose images and the loss curves.

Data parallelism (`DFConfig.data_parallel`, `parallel/mesh.py`): every
rank runs `train()` on the same batches; the steps take `mesh=` and keep
their rank's block of rows (a batch that does not divide is replicated),
draw dropout for the whole batch and keep their rows, average the
gradients over 'data' before the clip, take the clip's norm over the
logical gradients (a column-sharded weight's squares summed over
'model'), and return global-batch metrics; `eval_step_full` gathers the
per-sample outputs. Only rank 0 writes files."""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import weights
from ..models import losses
from ..models import torch_import as ti
from ..models.common import init_like_flax
from ..models.densefusion import PoseNet, PoseRefineNet
from ..parallel import mesh as pmesh
from ..pipeline.visualize import pointcloud2image
from ..utils import io
from ..utils import transforms as T
from ..utils.device import resolve_device
from ..utils.timing import JsonCurveLog, span
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
    # mesh data parallelism (parallel/mesh.py::auto_mesh): 'auto' engages
    # when more than one rank is up, 'on' always, 'off' never
    data_parallel: str = "auto"
    # global-norm gradient clip (see make_optimizer; <= 0 disables)
    grad_clip: float = 10.0


def _f32(lr: float) -> float:
    """The learning rate as optax holds it (an f32 hyperparameter)."""
    return float(np.float32(lr))


class ClippedAdam:
    """Adam (beta 0.9/0.999, eps 1e-8) behind optax's global-norm clip:
    g * where(norm < clip, 1, clip / norm). `step` returns the norm taken
    before the clip. The learning rate is rounded to f32, as optax's
    injected hyperparameter is, so a snapshot restores it exactly.

    `step(mesh)` first averages the gradients over 'data'; the norm is the
    logical gradient's: the squares of a column-parallel shard are summed
    over 'model', a replicated parameter's counted once."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 clip: float = 10.0):
        self.params: List[torch.nn.Parameter] = list(params)
        self.clip = clip
        self.adam = torch.optim.Adam(self.params, lr=_f32(lr),
                                     betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
        with span("step.optimizer"):
            with span("optimizer.clip"):
                gnorm = self._clip(mesh)
            with span("optimizer.adam"):
                self.adam.step()
        return gnorm

    def _clip(self, mesh: Optional[pmesh.Mesh]) -> torch.Tensor:
        if mesh is not None:
            pmesh.all_reduce_grads(mesh, self.params)
        live = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in live]
        norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
        sharded = torch.tensor([hasattr(p, "tp_shard") for p in live],
                               device=norms.device)
        if mesh is not None and bool(sharded.any()):
            tp_sq = torch.where(sharded, norms * norms, 0.0).sum()
            dist.all_reduce(tp_sq, group=mesh.groups[mesh.axes[1]])
            gnorm = torch.sqrt(torch.where(sharded, 0.0, norms * norms).sum()
                               + tp_sq)
        else:
            gnorm = torch.linalg.vector_norm(norms)
        if self.clip and self.clip > 0:
            scale = torch.where(gnorm < self.clip, 1.0, self.clip / gnorm)
            for g in grads:
                g.mul_(scale)
        return gnorm


def make_optimizer(params, lr: float, clip: float = 10.0) -> ClippedAdam:
    return ClippedAdam(params, lr, clip)


def set_lr(optimizer: ClippedAdam, lr: float) -> ClippedAdam:
    for group in optimizer.adam.param_groups:
        group["lr"] = _f32(lr)
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


def _local(mesh: Optional[pmesh.Mesh], batch: Dict[str, torch.Tensor]):
    """(this rank's rows of the batch, the dropout's `rows` (n, lo) or
    None when the batch is whole here)."""
    if mesh is None:
        return batch, None
    n = batch["obj_idx"].shape[0]
    block = pmesh.row_block(mesh, n)
    return (pmesh.shard_batch_data(mesh, batch),
            None if block is None else (n, block[0]))


def estimator_step(posenet: PoseNet, optimizer: ClippedAdam,
                   batch: Dict[str, torch.Tensor], w: float,
                   with_sym: bool = True, sym_bf16: bool = False,
                   generator: Optional[torch.Generator] = None,
                   mesh: Optional[pmesh.Mesh] = None
                   ) -> Dict[str, torch.Tensor]:
    """One estimator phase step with dropout from `generator`. Returns
    {loss, dis, gnorm}, gnorm the gradient norm before the clip. With
    `mesh` every rank passes the same global batch and takes its rows.
    Spans (`utils/timing.py`): one unit 'step' (kind 'estimator') of
    'step.forward', 'step.backward' and `ClippedAdam.step`'s
    'step.optimizer'."""
    with span("step", unit=True, kind="estimator"):
        with span("step.forward"):
            optimizer.zero_grad()
            batch, rows = _local(mesh, batch)
            pred_r, pred_t, pred_c, _ = posenet(
                batch["img"], batch["cloud"], batch["choose"],
                batch["obj_idx"], train=True, generator=generator, rows=rows)
            out = losses.pose_loss(pred_r, pred_t, pred_c, batch["target"],
                                   batch["model_points"], batch["cloud"],
                                   batch["is_sym"], w=w, with_sym=with_sym,
                                   sym_bf16=sym_bf16)
        with span("step.backward"):
            out.loss.backward()
        gnorm = optimizer.step(mesh)
        return {"loss": pmesh.data_mean(mesh, out.loss.detach()),
                "dis": pmesh.data_mean(mesh, out.dis.detach().mean()),
                "gnorm": gnorm}


def refiner_step(posenet: PoseNet, refiner: PoseRefineNet,
                 optimizer: ClippedAdam, batch: Dict[str, torch.Tensor],
                 w: float, iteration: int = 2, with_sym: bool = True,
                 mesh: Optional[pmesh.Mesh] = None
                 ) -> Dict[str, torch.Tensor]:
    """One refiner phase step: the frozen estimator's forward, then
    `iteration` rebased refiner passes whose mean distances are summed into
    one loss. Returns {dis}, the last pass's mean distance. Spans as
    `estimator_step`'s, kind 'refiner'."""
    with span("step", unit=True, kind="refiner"):
        with span("step.forward"):
            batch, _ = _local(mesh, batch)
            with torch.no_grad():
                pred_r, pred_t, pred_c, emb = posenet(
                    batch["img"], batch["cloud"], batch["choose"],
                    batch["obj_idx"])
                est = losses.pose_loss(pred_r, pred_t, pred_c,
                                       batch["target"],
                                       batch["model_points"], batch["cloud"],
                                       batch["is_sym"], w=w,
                                       with_sym=with_sym)
            optimizer.zero_grad()
            new_points, new_target = est.new_points, est.new_target
            total = 0.0
            for _ in range(iteration):
                dr, dt = refiner(new_points, emb, batch["obj_idx"])
                mean_dis, dis, new_points, new_target = losses.refine_loss(
                    dr, dt, new_target, batch["model_points"], new_points,
                    batch["is_sym"], with_sym=with_sym)
                total = total + mean_dis
        with span("step.backward"):
            total.backward()
        optimizer.step(mesh)
        return {"dis": pmesh.data_mean(mesh, dis.detach().mean())}


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
                   with_sym: bool = True,
                   mesh: Optional[pmesh.Mesh] = None):
    """Per-sample test distances (B,) and the composed predicted pose
    (quat (B, 4), trans (B, 3)); with `refine_start`, `iteration` rebased
    refiner steps follow the estimator. With `mesh` each rank runs its
    rows and the outputs are gathered, in order, on every rank."""
    batch, rows = _local(mesh, batch)
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
    if rows is not None:
        dis, quat, trans = (pmesh.all_gather_rows(mesh, t)
                            for t in (dis, quat, trans))
    return dis, quat, trans


def eval_step(posenet, refiner, batch, w: float, refine_start: bool = False,
              iteration: int = 2, with_sym: bool = True,
              mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
    """Per-sample test distances (B,)."""
    return eval_step_full(posenet, refiner, batch, w, refine_start,
                          iteration, with_sym, mesh)[0]


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
          epoch_callback=None, save_resume: bool = True,
          image_dump_dir: Optional[str] = None,
          image_batches: Optional[Callable[[], Iterable]] = None,
          image_every: int = 1) -> TrainerState:
    """The two-phase loop. `train_batches`/`test_batches` return a fresh
    iterator of batches per epoch in the JAX package's layout (numpy or
    tensors, img (B, S, S, 3); see `to_device`). Each epoch draws its
    dropout from a generator seeded by the epoch, so a run repeats.
    Artifacts: pose_model.npz / pose_refine_model.npz on the best test
    distance, losses.json, with `save_resume` the `trainer_resume.npz`
    snapshot after every epoch, and with `image_dump_dir` every
    `image_every` epochs `test_images_epoch_<N>.png` from `image_batches`
    (test batches with raw_img and intr) and `losses.png`.

    `cfg.data_parallel` engages `parallel/mesh.py::auto_mesh`: every rank
    calls `train()` with the same batches, the networks start from rank
    0's weights, the steps run data-parallel, and only rank 0 writes (the
    others wait for it at the end of each epoch)."""
    cfg = state.cfg
    dev = state.device
    mesh = pmesh.auto_mesh(cfg.data_parallel, device=dev)
    writer = pmesh.is_writer(mesh)
    if mesh is not None:
        pmesh.replicate_params(mesh, state.posenet)
        pmesh.replicate_params(mesh, state.refiner)
    os.makedirs(out_dir, exist_ok=True)
    log = JsonCurveLog(os.path.join(log_dir or out_dir, "losses.json")
                       if writer else None)

    for epoch in range(cfg.start_epoch, (epochs or cfg.nepoch)):
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(_DROPOUT_SEED + epoch)
        epoch_losses, epoch_dis, epoch_gnorms = [], [], []
        for batch in train_batches():
            batch = to_device(batch, dev)
            if state.refine_start:
                metrics = refiner_step(state.posenet, state.refiner,
                                       state.refine_optimizer, batch,
                                       state.w, cfg.iteration, cfg.with_sym,
                                       mesh)
                epoch_losses.append(0.0)
            else:
                metrics = estimator_step(state.posenet, state.optimizer,
                                         batch, state.w, cfg.with_sym,
                                         cfg.sym_bf16, gen, mesh)
                epoch_losses.append(float(metrics["loss"]))
                epoch_gnorms.append(float(metrics["gnorm"]))
            epoch_dis.append(float(metrics["dis"]))

        test_dis, test_terr = [], []
        for batch in test_batches():
            batch = to_device(batch, dev)
            dis, _, trans = eval_step_full(
                state.posenet, state.refiner, batch, state.w,
                state.refine_start, cfg.iteration, cfg.with_sym, mesh)
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
            if writer and state.refine_start:
                checkpoints.save_checkpoint(
                    os.path.join(out_dir, "pose_refine_model"),
                    weights.refiner_variables(state.refiner), meta)
            elif writer:
                checkpoints.save_checkpoint(
                    os.path.join(out_dir, "pose_model"),
                    weights.posenet_variables(state.posenet), meta)

        state.maybe_transition(epoch)
        if save_resume and writer:
            save_trainer_snapshot(state, out_dir, next_epoch=epoch + 1)
        if (image_dump_dir and image_batches is not None and writer
                and epoch % max(image_every, 1) == 0):
            os.makedirs(image_dump_dir, exist_ok=True)
            dump_pose_images(state, image_batches, os.path.join(
                image_dump_dir, f"test_images_epoch_{epoch}.png"))
            plot_loss_curves(log, os.path.join(image_dump_dir, "losses.png"))
        pmesh.barrier(mesh)
        if epoch_callback is not None:
            epoch_callback(state, epoch, test_mean)
    return state


@torch.inference_mode()
def dump_pose_images(state: TrainerState, batches: Callable[[], Iterable],
                     path: str, max_panels: int = 8) -> None:
    """A PNG of (target reprojection | prediction reprojection) panels, one
    row per test sample, up to `max_panels` (the reference's
    test_images_epoch_<N>.png). `batches` yields test batches with the
    raw_img and intr extras; the prediction is the estimator's, refined
    `cfg.iteration` times in the refiner phase."""
    panels = []
    for batch in batches():
        t = to_device(batch, state.device)
        pred_r, pred_t, pred_c, emb = state.posenet(
            t["img"], t["cloud"], t["choose"], t["obj_idx"])
        quat, trans = losses.estimator_prediction(pred_r, pred_t, pred_c,
                                                  t["cloud"])
        if state.refine_start:
            new_points = losses.rebase_points(quat, trans, t["cloud"])
            for _ in range(state.cfg.iteration):
                dr, dt = state.refiner(new_points, emb, t["obj_idx"])
                quat, trans = losses.compose_refined(dr, dt, quat, trans)
                new_points = losses.rebase_points(quat, trans, t["cloud"])
        rot = T.quat_to_mat(quat).cpu().numpy()
        trans_np = trans.cpu().numpy()
        for i in range(len(np.asarray(batch["obj_idx"]))):
            if len(panels) >= max_panels:
                break
            raw = np.asarray(batch["raw_img"][i])
            fx, fy, ppx, ppy = np.asarray(batch["intr"][i]).tolist()
            intr = {"fx": fx, "fy": fy, "ppx": ppx, "ppy": ppy}
            mp = np.asarray(batch["model_points"][i])
            pred_pts = mp @ rot[i].T + trans_np[i]
            img_t = pointcloud2image(raw, np.asarray(batch["target"][i]), 3,
                                     intr, color=(0, 255, 0))
            img_p = pointcloud2image(raw, pred_pts, 3, intr,
                                     color=(255, 0, 0))
            panels.append(np.concatenate([img_t, img_p], axis=1))
        if len(panels) >= max_panels:
            break
    if panels:
        io.write_png(path, np.concatenate(panels, axis=0).astype(np.uint8))


_CURVES = ("losses", "train_dists", "test_dists", "epoch_seconds")


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """A 2-pixel-wide segment from p0 to p1 ((row, col) floats)."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    rows = np.rint(np.linspace(p0[0], p1[0], n)).astype(int)
    cols = np.rint(np.linspace(p0[1], p1[1], n)).astype(int)
    h, w = img.shape[:2]
    for dr, dc in ((0, 0), (1, 0), (0, 1), (1, 1)):
        r, c = rows + dr, cols + dc
        ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
        img[r[ok], c[ok]] = color


def plot_loss_curves(log: JsonCurveLog, path: str) -> None:
    """losses.png: the estimator loss, training distance, test distance and
    epoch time per epoch in a 2x2 grid of 600x400 panels (the layout of the
    JAX package's matplotlib figure, reference train.py:329-353), each
    curve a polyline scaled to its panel's range, non-finite points left
    out. Drawn in numpy, without axis labels or text, so not pixel-equal
    to the JAX plot."""
    curves = log.data["curves"]
    ph, pw, margin = 400, 600, 40
    fig = np.full((2 * ph, 2 * pw, 3), 255, np.uint8)
    for k, key in enumerate(_CURVES):
        top, left = (k // 2) * ph + margin, (k % 2) * pw + margin
        bottom, right = top + ph - 2 * margin, left + pw - 2 * margin
        for p0, p1 in (((top, left), (top, right)),
                       ((bottom, left), (bottom, right)),
                       ((top, left), (bottom, left)),
                       ((top, right), (bottom, right))):
            _draw_line(fig, p0, p1, (0, 0, 0))
        y = np.asarray(curves.get(key, []), np.float64)
        x = np.arange(len(y))
        ok = np.isfinite(y)
        if not ok.any():
            continue
        x, y = x[ok], y[ok]
        lo, hi = y.min(), y.max()
        span_y = hi - lo if hi > lo else 1.0
        span_x = max(x.max() - x.min(), 1)
        rows = bottom - (y - lo) / span_y * (bottom - top)
        cols = left + (x - x.min()) / span_x * (right - left)
        pts = list(zip(rows, cols))
        for p0, p1 in zip(pts, pts[1:] or pts):
            _draw_line(fig, p0, p1, (31, 119, 180))
    io.write_png(path, fig)


def save_trainer_snapshot(state: TrainerState, out_dir: str,
                          next_epoch: int) -> None:
    """`<out_dir>/trainer_resume.npz`: both networks, both optimizers and
    the phase machine, in the JAX trainer's layout and meta keys."""
    clip = state.cfg.grad_clip
    opt = {"est": checkpoints.adam_tree(state.optimizer.adam, state.posenet,
                                        weights.posenet_plan(), clip)}
    if state.refine_optimizer is not None:
        opt["refine"] = checkpoints.adam_tree(
            state.refine_optimizer.adam, state.refiner,
            weights.refiner_plan(), clip)
    checkpoints.save_checkpoint(
        os.path.join(out_dir, "trainer_resume"),
        {"pose_vars": weights.posenet_variables(state.posenet),
         "refine_vars": weights.refiner_variables(state.refiner)},
        meta={"epoch": next_epoch, "best_test": state.best_test,
              "decay_start": state.decay_start,
              "refine_start": state.refine_start,
              "lr": state.lr, "w": state.w},
        opt_state=opt)


def resume_trainer(state: TrainerState, out_dir: str) -> TrainerState:
    """Restore `<out_dir>/trainer_resume.npz` (written by either package),
    so that `cfg.start_epoch` continues where the run stopped and the next
    step on the same batch is the uninterrupted run's. A snapshot in the
    refiner phase creates the refiner's optimizer."""
    out = checkpoints.load_checkpoint(
        os.path.join(out_dir, "trainer_resume"))
    meta, variables, opt = out["meta"], out["variables"], out["opt_state"]
    state.decay_start = bool(meta["decay_start"])
    state.refine_start = bool(meta["refine_start"])
    state.best_test = float(meta["best_test"])
    state.lr = float(meta["lr"])
    state.w = float(meta["w"])
    state.posenet.load_state_dict(
        weights.posenet_state_dict(variables["pose_vars"]))
    state.refiner.load_state_dict(
        weights.refiner_state_dict(variables["refine_vars"]))
    set_lr(state.optimizer, state.lr)
    checkpoints.load_adam_tree(state.optimizer.adam, state.posenet,
                               weights.posenet_plan(), opt["est"])
    if state.refine_start:
        refine = opt["refine"]
        inject = refine["1"] if "1" in refine else refine
        lr = float(inject[".hyperparams"]["learning_rate"])
        if state.refine_optimizer is None:
            state.refine_optimizer = make_optimizer(
                state.refiner.parameters(), lr, state.cfg.grad_clip)
        set_lr(state.refine_optimizer, lr)
        checkpoints.load_adam_tree(state.refine_optimizer.adam,
                                   state.refiner, weights.refiner_plan(),
                                   refine)
    state.cfg.start_epoch = int(meta["epoch"])
    return state


def warm_start(state: TrainerState, posenet_path: str,
               refinenet_path: Optional[str] = None) -> TrainerState:
    """Start from pretrained weights: an upstream DenseFusion `.pth` (the
    final per-object head layers drawn anew when the object count differs,
    `models/torch_import.py`) or a `.npz` checkpoint of either package; the
    optimizers start afresh."""
    num_obj = state.posenet.head_r.num_obj

    def load(path: str, kind: str) -> Dict[str, Any]:
        if path.endswith(".pth"):
            fn = (ti.warm_start_posenet if kind == "pose"
                  else ti.warm_start_refinenet)
            return fn(ti.load_pth(path), num_obj)
        return checkpoints.load_checkpoint(path)["variables"]

    state.posenet.load_state_dict(
        weights.posenet_state_dict(load(posenet_path, "pose")))
    state.optimizer = make_optimizer(state.posenet.parameters(),
                                     state.cfg.lr, state.cfg.grad_clip)
    if refinenet_path:
        state.refiner.load_state_dict(
            weights.refiner_state_dict(load(refinenet_path, "refine")))
        if state.refine_optimizer is not None:
            state.refine_optimizer = make_optimizer(
                state.refiner.parameters(),
                state.refine_optimizer.adam.param_groups[0]["lr"],
                state.cfg.grad_clip)
    return state
