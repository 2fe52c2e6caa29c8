"""Rank bodies of `tests/test_torch_parallel.py`: module-level functions, so
that the ranks `parallel/dryrun.py::run_ranks` spawns find them by name.
Each runs on one rank of a gloo group (or, with no group, as the one-rank
reference in the test's own process) and returns numpy results. Nothing
here imports JAX."""
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.models import unet
from autoposeestimation_tpu_torch.models.common import (BatchNorm2d,
                                                        init_like_flax,
                                                        sync_batchnorm)
from autoposeestimation_tpu_torch.models.densefusion import (PoseNet,
                                                             PoseRefineNet)
from autoposeestimation_tpu_torch.parallel import mesh as pmesh
from autoposeestimation_tpu_torch.reconstruction import (
    create_pointcloud as rec)
from autoposeestimation_tpu_torch.train import checkpoints
from autoposeestimation_tpu_torch.train import densefusion as dft
from autoposeestimation_tpu_torch.train import segmentation as seg
from autoposeestimation_tpu_torch.utils import io
from autoposeestimation_tpu_torch.utils.timing import JsonCurveLog

SEG_STAGES = (2, 1, 1, 1)


def mesh_or_none(model_parallel: int = 1):
    return (pmesh.make_mesh(model_parallel=model_parallel)
            if dist.is_initialized() else None)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def synced_batchnorm(x: np.ndarray, cot: np.ndarray, scale: np.ndarray,
                     bias: np.ndarray):
    """A train-mode BatchNorm2d on this rank's rows of x, its statistics
    over the data group, backward from the rows' share of sum(y * cot)."""
    mesh = mesh_or_none()
    lo, hi = (0, len(x)) if mesh is None else pmesh.row_block(mesh, len(x))
    bn = BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    if mesh is not None:
        sync_batchnorm(bn, mesh.groups["data"])
    xr = torch.tensor(x[lo:hi], requires_grad=True)
    y = bn(xr)
    (y * torch.from_numpy(cot[lo:hi])).sum().backward()
    return _numpy({"y": y, "x_grad": xr.grad, "running_mean": bn.running_mean,
                   "running_var": bn.running_var, "weight_grad": bn.weight.grad,
                   "bias_grad": bn.bias.grad})


def _posenet(num_obj: int, pose_vars=None, seed: int = 0, dropout=True):
    net = PoseNet(num_obj)
    if pose_vars is None:
        init_like_flax(net, torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict(weights.posenet_state_dict(pose_vars))
    if not dropout:
        net.cnn.dropout_rates = (0.0, 0.0, 0.0)
    return net


def estimator_steps(num_obj: int, pose_vars, batches, lr: float, clip: float,
                    w: float):
    """One estimator step (dropout off) from `pose_vars` on each named
    batch, each from a fresh network: the metrics, the gradients the
    optimizer saw and the parameters after the step."""
    mesh = mesh_or_none()
    out = {}
    for name, batch in batches.items():
        net = _posenet(num_obj, pose_vars, dropout=False)
        opt = dft.make_optimizer(net.parameters(), lr, clip)
        metrics = dft.estimator_step(
            net, opt, dft.to_device(batch, "cpu"), w, with_sym=True,
            sym_bf16=False, generator=torch.Generator().manual_seed(0),
            mesh=mesh)
        out[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": weights.to_variables(
                {k: p.grad for k, p in net.named_parameters()},
                weights.posenet_plan())["params"],
            "vars": weights.posenet_variables(net)}
    return out


def dp_tp_steps(num_obj: int, batch, lr: float, w: float,
                model_parallel: int):
    """From seeded networks, with dropout: the evaluation of the batch, one
    estimator step, one refiner step, on a (data, model) mesh with the
    wide Linears column-sharded."""
    mesh = mesh_or_none(model_parallel)
    posenet = _posenet(num_obj, seed=3)
    refiner = PoseRefineNet(num_obj)
    init_like_flax(refiner, torch.Generator().manual_seed(4))
    opt = dft.make_optimizer(posenet.parameters(), lr)
    ropt = dft.make_optimizer(refiner.parameters(), lr)
    if mesh is not None:
        pmesh.shard_params_tp(mesh, posenet, opt.adam)
        pmesh.shard_params_tp(mesh, refiner, ropt.adam)
    t = dft.to_device(batch, "cpu")
    dis, quat, trans = dft.eval_step_full(posenet, refiner, t, w,
                                          refine_start=True, mesh=mesh)
    est = dft.estimator_step(posenet, opt, t, w, with_sym=True,
                             sym_bf16=False,
                             generator=torch.Generator().manual_seed(7),
                             mesh=mesh)
    ref = dft.refiner_step(posenet, refiner, ropt, t, w, iteration=2,
                           mesh=mesh)
    return {"eval": _numpy({"dis": dis, "quat": quat, "trans": trans}),
            "loss": float(est["loss"]), "dis": float(est["dis"]),
            "gnorm": float(est["gnorm"]), "refine_dis": float(ref["dis"]),
            "conv6_rows": posenet.feat.conv6.weight.shape[0],
            "pose_vars": weights.posenet_variables(posenet),
            "refine_vars": weights.refiner_variables(refiner)}


class WriteCounter(ExitStack):
    """Counts the trainers' file writes in this process: checkpoints, PNGs
    and curve logs with a path."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __enter__(self):
        super().__enter__()

        def counted(fn):
            def wrapper(*args, **kw):
                self.count += 1
                return fn(*args, **kw)
            return wrapper

        flush = JsonCurveLog.flush

        def log_flush(log):
            if log.path is not None:
                self.count += 1
            return flush(log)

        self.enter_context(mock.patch.object(
            checkpoints, "save_checkpoint",
            counted(checkpoints.save_checkpoint)))
        self.enter_context(mock.patch.object(io, "write_png",
                                             counted(io.write_png)))
        self.enter_context(mock.patch.object(JsonCurveLog, "flush",
                                             log_flush))
        return self


def train_pose(mode: str, num_obj: int, n: int, m: int, crop: int, batches,
               out_dir: str):
    """`train()` for one epoch at `data_parallel=mode` on every rank."""
    cfg = dft.DFConfig(num_points=n, num_points_mesh=m, batch_size=8,
                       data_parallel=mode, start_epoch=0)
    state = dft.create_trainer(num_obj, cfg, dtype=torch.float32,
                               device="cpu")
    with WriteCounter() as writes:
        state = dft.train(state, lambda: iter(batches),
                          lambda: iter(batches[:1]), out_dir=out_dir,
                          epochs=1)
    return {"best_test": state.best_test, "writes": writes.count,
            "vars": weights.posenet_variables(state.posenet)}


def train_segmentation(mode: str, batches, out_dir: str):
    """`segmentation_training` for one epoch at `data_parallel=mode` with
    SGD and a U-Net of encoder stages (2, 1, 1, 1)."""
    cfg = seg.SegConfig(classes=3, epochs=1, batch_size=8, lr=1e-3,
                        optimizer="sgd", data_parallel=mode)
    with WriteCounter() as writes, mock.patch.object(
            seg, "build_model", lambda c, dtype: unet.UNet(
                c.classes, encoder_stages=SEG_STAGES, dtype=dtype)), \
            mock.patch.object(seg, "model_plan",
                              lambda c: weights.unet_plan(SEG_STAGES)):
        out = seg.segmentation_training(
            lambda: iter(batches), lambda: iter(batches[:1]), cfg,
            out_dir=out_dir, dtype=torch.float32, device="cpu")
    return {"best_iou": out["best_iou"], "writes": writes.count,
            "vars": out["variables"]}


def reconstruct(views, surface_kw, root: str, settings):
    """The views' surfaces through `get_surfaces_batched`, then the ball's
    `load_point_cloud` of the dataset at `root`, on this group's mesh."""
    mesh = mesh_or_none()
    surfaces = rec.get_surfaces_batched(*views, **surface_kw, mesh=mesh,
                                        device="cpu")
    cloud = rec.load_point_cloud("ball", io.pc_dir(root), root, **settings,
                                 mesh=mesh, device="cpu")
    return {"surfaces": surfaces, "cloud": cloud}
