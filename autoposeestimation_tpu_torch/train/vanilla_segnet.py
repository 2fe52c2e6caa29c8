"""The legacy vanilla-SegNet training loop and its file logger (port of
`autoposeestimation_tpu/train/vanilla_segnet.py`): Adam (lr 1e-4), one
cross-entropy log line per batch into `epoch_<N>_log.txt` /
`epoch_<N>_test_log.txt`, `model_current` saved every `save_every` batches,
a `model_<epoch>_<cost>` checkpoint whenever the test cost is at or below
the best, and `resume_model`, which loads a checkpoint and clears the old
logs. Checkpoints are in the JAX package's `.npz` format.

Batches are the Loader's: image (B, H, W, 3) f32 and label (B, H, W) int,
numpy or tensors."""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Iterable

import numpy as np
import torch

from .. import weights
from ..models import segnet as segnet_mod
from ..models.common import init_like_flax
from ..utils.device import resolve_device
from ..utils.timing import span
from . import checkpoints
from .segmentation import to_device


def setup_logger(logger_name: str, log_file: str,
                 level=logging.INFO) -> logging.Logger:
    """A logger writing `log_file` anew (the reference's lib/utils.py)."""
    logger = logging.getLogger(logger_name)
    logger.handlers.clear()
    formatter = logging.Formatter("%(asctime)s : %(message)s")
    fh = logging.FileHandler(log_file, mode="w")
    fh.setFormatter(formatter)
    logger.setLevel(level)
    logger.addHandler(fh)
    logger.propagate = False
    return logger


def train_step(model: segnet_mod.SegNet, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One step in train mode; the cross-entropy before the update. Spans
    (`utils/timing.py`): one unit 'step' (kind 'segnet') of 'step.forward'
    (the forward and the loss), 'step.backward' and 'step.optimizer'."""
    with span("step", unit=True, kind="segnet"):
        with span("step.forward"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            loss = segnet_mod.cross_entropy_loss(batch["label"],
                                                 model(batch["image"]))
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            optimizer.step()
        return loss.detach()


@torch.no_grad()
def eval_step(model: segnet_mod.SegNet,
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    model.eval()
    return segnet_mod.cross_entropy_loss(batch["label"],
                                         model(batch["image"]))


def train_vanilla_segnet(train_batches: Callable[[], Iterable],
                         test_batches: Callable[[], Iterable],
                         n_classes: int,
                         n_epochs: int = 600,
                         lr: float = 1e-4,
                         log_dir: str = "logs",
                         model_save_path: str = "trained_models",
                         resume_model: str = "",
                         save_every: int = 1000,
                         dtype: torch.dtype = torch.float32,
                         seed: int = 0, device=None) -> Dict[str, Any]:
    """Epochs 1 .. n_epochs - 1 on `device` (cuda by default). Returns
    {'variables' (the last epoch's flax tree), 'best_val_cost',
    'epochs_run'}."""
    dev = resolve_device(device)
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(model_save_path, exist_ok=True)
    model = segnet_mod.SegNet(classes=n_classes, dtype=dtype)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    plan = weights.segnet_plan()
    if resume_model:
        model.load_state_dict(weights.to_state_dict(
            checkpoints.load_checkpoint(os.path.join(
                model_save_path, resume_model))["variables"], plan))
        for f in os.listdir(log_dir):   # the reference clears old logs
            os.remove(os.path.join(log_dir, f))
    model.to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=float(np.float32(lr)),
                                 betas=(0.9, 0.999), eps=1e-8)

    def variables():
        return weights.to_variables(model.state_dict(), plan)

    best_val_cost = np.inf
    st_time = time.time()

    def stamp():
        return time.strftime("%Hh %Mm %Ss", time.gmtime(time.time() - st_time))

    for epoch in range(1, n_epochs):
        logger = setup_logger(
            f"epoch{epoch}", os.path.join(log_dir, f"epoch_{epoch}_log.txt"))
        logger.info(f"Train time {stamp()}, Training started")
        train_all_cost = 0.0
        train_time = 0
        for batch in train_batches():
            loss = float(train_step(model, optimizer, to_device(batch, dev)))
            train_all_cost += loss
            logger.info(f"Train time {stamp()} Batch {train_time} "
                        f"CEloss {loss}")
            if train_time != 0 and train_time % save_every == 0:
                checkpoints.save_checkpoint(
                    os.path.join(model_save_path, "model_current"),
                    variables())
            train_time += 1
        train_all_cost /= max(train_time, 1)
        logger.info(f"Train Finish Avg CEloss: {train_all_cost}")

        logger = setup_logger(
            f"epoch{epoch}_test",
            os.path.join(log_dir, f"epoch_{epoch}_test_log.txt"))
        logger.info(f"Test time {stamp()}, Testing started")
        test_all_cost = 0.0
        test_time = 0
        for batch in test_batches():
            loss = float(eval_step(model, to_device(batch, dev)))
            test_all_cost += loss
            test_time += 1
            logger.info(f"Test time {stamp()} Batch {test_time} "
                        f"CEloss {loss}")
        test_all_cost /= max(test_time, 1)
        logger.info(f"Test Finish Avg CEloss: {test_all_cost}")

        if test_all_cost <= best_val_cost:
            best_val_cost = test_all_cost
            checkpoints.save_checkpoint(
                os.path.join(model_save_path,
                             f"model_{epoch}_{test_all_cost}"), variables())

    return {"variables": variables(), "best_val_cost": best_val_cost,
            "epochs_run": n_epochs - 1}
