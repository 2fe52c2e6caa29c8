"""Segmentation training (port of `autoposeestimation_tpu/train/
segmentation.py`): the multi-class U-Net of serving and the 7-channel
background-subtraction U-Net alike.

A batch comes in as the Loader gives it, numpy arrays (or tensors): image
(B, H, W, C) normalized f32, channels last, and label (B, H, W) int class
ids. `to_device` gives the steps' layout (image (B, C, H, W) contiguous on
the model's device, label int64), which `train_step` and `eval_step` take.
`segmentation_training` copies the batches to the card ahead of the steps
(`data/loader.py::device_prefetch`).

As in the JAX trainer: the soft-jaccard loss over the classes present,
BatchNorm in train mode (batch statistics, running statistics updated),
Adam or SGD with Nesterov momentum (the learning rate held in f32, as
optax's injected hyperparameter is), the confusion matrices summed per
epoch on the device and read once an epoch, the mIoU with the background
left out, the best-valid-mIoU checkpoint `ckpt_name` in the JAX package's
format (which its `load_checkpoint` reads) with the `logs.json` curve log,
an optional `ReduceLROnPlateau`, and the IoU after keeping each sample's
best connected component (`with_cca_metric`).

Data parallelism (`SegConfig.data_parallel`, `parallel/mesh.py`): every
rank iterates the same batches and keeps its block of rows (a batch that
does not divide is replicated); BatchNorm takes the global batch's
statistics, the jaccard loss is the global batch's, the gradients are
averaged over 'data', and the epoch's confusion matrices are summed over
the ranks before the IoU, so every rank sees one IoU and takes one
plateau decision. Only rank 0 writes files."""
from __future__ import annotations

import functools
import os
import time
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import weights
from ..data.loader import device_prefetch
from ..models import losses, seg_variants
from ..models.common import init_like_flax, sync_batchnorm
from ..models.unet import UNet
from ..ops import cca as cca_ops
from ..parallel import mesh as pmesh
from ..utils import io
from ..utils.device import resolve_device
from ..utils.timing import JsonCurveLog, span
from . import checkpoints
from .densefusion import _f32


@dataclass
class SegConfig:
    """The JAX `SegConfig`'s fields and defaults (the reference TUI's
    hardcoded config)."""

    model_name: str = "Unet"
    encoder_name: str = "resnet34"
    activation: str = "softmax"
    in_channels: int = 3
    classes: int = 2
    epochs: int = 500
    batch_size: int = 4
    lr: float = 1e-4
    optimizer: str = "adam"         # 'adam' | 'sgd' (nesterov)
    momentum: float = 0.9
    use_imagenet_stats: bool = True
    # mesh data parallelism (parallel/mesh.py::auto_mesh): 'auto' engages
    # when more than one rank is up, 'on' always, 'off' never
    data_parallel: str = "auto"


def build_model(cfg: SegConfig, dtype: torch.dtype = torch.bfloat16
                ) -> torch.nn.Module:
    """The registry {Unet, LinkNet, PSPNet} over the resnet34 encoder."""
    if cfg.encoder_name != "resnet34":
        raise NotImplementedError(
            f"encoder {cfg.encoder_name} — resnet34 is the registry encoder")
    if cfg.model_name == "Unet":
        return UNet(cfg.classes, dtype=dtype, in_ch=cfg.in_channels)
    if cfg.model_name == "LinkNet":
        return seg_variants.LinkNet(cfg.classes, dtype=dtype,
                                    in_ch=cfg.in_channels)
    if cfg.model_name == "PSPNet":
        return seg_variants.PSPNetSeg(cfg.classes, dtype=dtype,
                                      in_ch=cfg.in_channels)
    raise NotImplementedError(cfg.model_name)


def model_plan(cfg: SegConfig) -> List[weights.Entry]:
    """The weight plan of `build_model(cfg)`'s model."""
    return {"Unet": weights.unet_plan, "LinkNet": weights.linknet_plan,
            "PSPNet": weights.pspnet_seg_plan}[cfg.model_name]()


def make_optimizer(cfg: SegConfig, params) -> torch.optim.Optimizer:
    """optax's `adam` (b1 0.9, b2 0.999, eps 1e-8) or `sgd` with Nesterov
    momentum, whose trace torch's SGD with dampening 0 keeps alike."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=_f32(cfg.lr), betas=(0.9, 0.999),
                                eps=1e-8)
    return torch.optim.SGD(params, lr=_f32(cfg.lr), momentum=cfg.momentum,
                           nesterov=True, dampening=0.0)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = _f32(lr)


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A Loader batch (image (B, H, W, C), numpy or tensors) -> image
    (B, C, H, W) f32 contiguous and label int64, on `device`."""
    image = _tensor(batch["image"]).to(device, torch.float32)
    return {"image": image.permute(0, 3, 1, 2).contiguous(),
            "label": _tensor(batch["label"]).to(device, torch.int64)}


def _local(mesh: Optional[pmesh.Mesh], batch: Dict[str, torch.Tensor]):
    """(this rank's rows of the batch, whether its confusion counts): a
    replicated batch is counted by data index 0 alone, so that the sum
    over 'data' counts every pixel once."""
    if mesh is None:
        return batch, True
    if pmesh.row_block(mesh, batch["label"].shape[0]) is None:
        return batch, mesh.coords[mesh.axes[0]] == 0
    return pmesh.shard_batch_data(mesh, batch), True


def _data_group(mesh: Optional[pmesh.Mesh]):
    return None if mesh is None else mesh.groups[mesh.axes[0]]


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], num_classes: int,
               mesh: Optional[pmesh.Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """One step in train mode: the jaccard loss, its gradient and the
    optimizer's update; BatchNorm's running statistics move. Returns
    {loss, conf} as tensors on the device (nothing is read back). With
    `mesh` every rank passes the same global batch (and the model's
    BatchNorms are synced over 'data', see `segmentation_training`); the
    loss is the global batch's, `conf` this rank's share of its
    confusion. Spans (`utils/timing.py`): one unit 'step' (kind 'unet') of
    'step.forward' (the forward and the loss), 'step.backward' and
    'step.optimizer' (the gradients' average over 'data' and the update);
    the confusion follows them inside the unit."""
    with span("step", unit=True, kind="unet"):
        with span("step.forward"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            batch, counts = _local(mesh, batch)
            logits = model(batch["image"])
            loss = losses.jaccard_loss(batch["label"], logits,
                                       group=_data_group(mesh))
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            if mesh is not None:
                pmesh.all_reduce_grads(mesh, model.parameters())
            optimizer.step()
        conf = losses.confusion_matrix(logits.detach().argmax(1),
                                       batch["label"], num_classes)
        return {"loss": loss.detach(), "conf": conf if counts else conf * 0}


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              num_classes: int, with_cca: bool = False,
              mesh: Optional[pmesh.Mesh] = None) -> Dict[str, torch.Tensor]:
    """{loss, conf} in eval mode; with `with_cca` also conf_cca, the
    confusion after keeping each sample's foreground component of the
    largest summed max-probability. With `mesh` as in `train_step`."""
    model.eval()
    batch, counts = _local(mesh, batch)
    logits = model(batch["image"])
    pred = logits.argmax(1)
    out = {"loss": losses.jaccard_loss(batch["label"], logits,
                                       group=_data_group(mesh)),
           "conf": losses.confusion_matrix(pred, batch["label"],
                                           num_classes)}
    if with_cca:
        maxprob = torch.softmax(logits, dim=1).amax(1)
        comp, _ = cca_ops.best_component_mask(pred > 0, maxprob, 0.0, "sum")
        out["conf_cca"] = losses.confusion_matrix(
            torch.where(comp, pred, 0), batch["label"], num_classes)
    if not counts:
        for key in ("conf", "conf_cca"):
            if key in out:
                out[key] = out[key] * 0
    return out


class ReduceLROnPlateau:
    """torch-style plateau schedule: after more than `patience` epochs
    without improvement the rate is multiplied by `factor`."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 5,
                 mode: str = "max"):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.bad = 0

    def step(self, metric: float) -> float:
        better = (metric > self.best) if self.mode == "max" else (
            metric < self.best)
        if better:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr *= self.factor
                self.bad = 0
        return self.lr


@torch.no_grad()
def dump_prediction_images(model: torch.nn.Module, batch: Dict[str, Any],
                           path: str, num_classes: int) -> None:
    """A PNG of (input | ground truth | prediction) rows for the first 4
    samples of a Loader batch; classes on a grey ramp."""
    device = next(model.parameters()).device
    model.eval()
    head = {k: _tensor(v)[:4].cpu().numpy() for k, v in batch.items()}
    logits = model(to_device(head, device)["image"])
    pred = logits.argmax(1).cpu().numpy()
    label, img = head["label"], head["image"]
    disp = np.clip((img[..., :3] * 0.25 + 0.45) * 255, 0, 255).astype(np.uint8)
    scale = 255 // max(num_classes - 1, 1)
    rows = []
    for i in range(len(disp)):
        gt_panel = np.repeat((label[i] * scale).astype(np.uint8)[..., None],
                             3, axis=-1)
        pr_panel = np.repeat((pred[i] * scale).astype(np.uint8)[..., None],
                             3, axis=-1)
        rows.append(np.concatenate([disp[i], gt_panel, pr_panel], axis=1))
    io.write_png(path, np.concatenate(rows, axis=0))


def _mean(values: List[torch.Tensor]) -> float:
    """The mean of per-step scalars, read back at once."""
    return float(np.mean(torch.stack(values).tolist() if values else [0.0]))


def segmentation_training(train_loader: Callable[[], Iterable],
                          valid_loader: Callable[[], Iterable],
                          cfg: SegConfig,
                          out_dir: str,
                          ckpt_name: str = "Unet_resnet34.ckpt",
                          log_dir: Optional[str] = None,
                          plateau: Optional[ReduceLROnPlateau] = None,
                          with_cca_metric: bool = False,
                          dtype: torch.dtype = torch.bfloat16,
                          seed: int = 0,
                          image_dump_dir: Optional[str] = None,
                          epoch_callback=None, device=None,
                          init_variables: Optional[Dict[str, Any]] = None
                          ) -> Dict[str, Any]:
    """The train loop on `device` (cuda by default). The weights start from
    the port's seeded init, or from `init_variables`, a flax variable tree
    of the model. `epoch_callback(model, epoch, valid_iou)` runs after each
    epoch; a plateau's new rate is written to `cfg.lr`. Returns
    {'variables': the best epoch's flax tree (a copy), 'model': the model
    as it ends, 'best_iou', 'log'}. `cfg.data_parallel` engages
    `parallel/mesh.py::auto_mesh` (see the module's docstring): every rank
    calls this with the same loaders, the model starts from rank 0's
    weights, and only rank 0 writes."""
    if cfg.model_name == "PSPNet":
        # the JAX train_step gives PSPNet's dropout no key, so flax raises
        # InvalidRngError at its first step; the port matches it
        raise ValueError("PSPNet does not train: its dropout gets no random "
                         "key in the JAX package's train_step")
    dev = resolve_device(device)
    model = build_model(cfg, dtype=dtype)
    plan = model_plan(cfg)
    if init_variables is None:
        init_like_flax(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(weights.to_state_dict(init_variables, plan))
    model.to(dev)
    mesh = pmesh.auto_mesh(cfg.data_parallel, device=dev)
    writer = pmesh.is_writer(mesh)
    if mesh is not None:
        pmesh.replicate_params(mesh, model)
        sync_batchnorm(model, _data_group(mesh))
    optimizer = make_optimizer(cfg, model.parameters())

    os.makedirs(out_dir, exist_ok=True)
    log = JsonCurveLog(os.path.join(log_dir or out_dir, "logs.json")
                       if writer else None, config=asdict(cfg))
    best_iou = -1.0
    best_variables = weights.to_variables(model.state_dict(), plan)
    zeros = functools.partial(torch.zeros, (cfg.classes, cfg.classes),
                              dtype=torch.int64, device=dev)

    for epoch in range(cfg.epochs):
        t0 = time.time()
        train_losses, conf = [], zeros()
        for batch in device_prefetch(train_loader(), dev):
            m = train_step(model, optimizer, to_device(batch, dev),
                           cfg.classes, mesh)
            train_losses.append(m["loss"])
            conf += m["conf"]
        _, train_iou = losses.iou_from_confusion(pmesh.data_sum(mesh, conf))

        valid_losses, vconf, vconf_cca = [], zeros(), zeros()
        first_valid_batch = None
        for batch in device_prefetch(valid_loader(), dev):
            if first_valid_batch is None:
                first_valid_batch = batch
            m = eval_step(model, to_device(batch, dev), cfg.classes,
                          with_cca_metric, mesh)
            valid_losses.append(m["loss"])
            vconf += m["conf"]
            if with_cca_metric:
                vconf_cca += m["conf_cca"]
        vconf = pmesh.data_sum(mesh, vconf)
        vconf_cca = pmesh.data_sum(mesh, vconf_cca)
        if image_dump_dir and first_valid_batch is not None and writer:
            dump_prediction_images(
                model, first_valid_batch,
                os.path.join(image_dump_dir, f"epoch_{epoch:04d}.png"),
                cfg.classes)
        _, valid_iou = losses.iou_from_confusion(vconf)
        valid_iou = float(valid_iou)

        entry = {
            "train_loss": _mean(train_losses),
            "valid_loss": _mean(valid_losses),
            "train_iou": float(train_iou),
            "valid_iou": valid_iou,
            "epoch_seconds": time.time() - t0,
            "lr": float(cfg.lr),
        }
        if with_cca_metric:
            entry["valid_iou_cca"] = float(
                losses.iou_from_confusion(vconf_cca)[1])
        log.append(**entry)

        if valid_iou > best_iou:
            best_iou = valid_iou
            best_variables = weights.to_variables(model.state_dict(), plan)
            if writer:
                checkpoints.save_checkpoint(
                    os.path.join(out_dir, ckpt_name), best_variables,
                    meta={"epoch": epoch, "valid_iou": valid_iou,
                          "config": asdict(cfg)})
        pmesh.barrier(mesh)

        if plateau is not None:
            new_lr = plateau.step(valid_iou)
            if new_lr != cfg.lr:
                cfg.lr = new_lr
                set_lr(optimizer, new_lr)
        if epoch_callback is not None:
            epoch_callback(model, epoch, valid_iou)

    return {"variables": best_variables, "model": model,
            "best_iou": best_iou, "log": log.data}


def random_prediction_iou(valid_loader: Callable[[], Iterable],
                          num_classes: int, seed: int = 0) -> float:
    """The mIoU of uniform random predictions over the validation set (the
    reference's sanity baseline), on the CPU."""
    rng = np.random.default_rng(seed)
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64)
    for batch in valid_loader():
        label = np.asarray(batch["label"])
        pred = rng.integers(0, num_classes, label.shape)
        conf += losses.confusion_matrix(torch.as_tensor(pred),
                                        torch.as_tensor(label), num_classes)
    return float(losses.iou_from_confusion(conf)[1])
