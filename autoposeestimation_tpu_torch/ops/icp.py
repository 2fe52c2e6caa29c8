"""Iterative closest point registration (port of
`autoposeestimation_tpu/ops/icp.py`): correspondences from the
nearest-neighbour op (on CUDA the kernel `csrc/nn.cu`), rejection beyond
`max_corr_dist`, a closed-form Kabsch/SVD update (point-to-point) or a 6x6
Gauss-Newton step (point-to-plane), and Open3D's convergence criteria.

The JAX package's `lax.while_loop` is a Python loop here that reads the
`converged` flag from the device once per iteration; the 6x6 solve runs on
the clouds' device. As in `ops/pointcloud.py`, the sums, the updates and
the transform of the points are computed in f64 and the moved points and
the transform rounded to f32 (the JAX package's types), so that the CPU
and CUDA take the same steps; the nearest-neighbour search is the same
function on both. The point-to-point step's weighted sums and 3x3 SVD run
on the host in numpy f64 for every device (`pointcloud.kabsch_np`): where
few inliers match one or two target points, as after a poor global
registration, the cross-covariance is zero or of rank 1, its rotation is
not unique, and LAPACK and cuSOLVER pick different ones (an H100's step
differed from the CPU's by 40 mm there).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import transforms as T
from . import global_registration as greg
from . import knn as knn_ops
from . import pointcloud as pc


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) source -> target
    fitness: torch.Tensor         # inlier fraction of the valid source points
    inlier_rmse: torch.Tensor     # rmse over the inliers
    num_iterations: int


_F64 = torch.float64


def _kabsch(src: torch.Tensor, tgt: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """`pointcloud.kabsch_np` of device tensors: the sums and the SVD run on
    the host, as a 4x4 f64 transform on the points' device."""
    args = (x.detach().cpu().numpy() for x in (src, tgt, weights))
    return torch.from_numpy(pc.kabsch_np(*args)).to(src.device)


def _point2plane_step(src: torch.Tensor, tgt: torch.Tensor,
                      normals: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """One linearized point-to-plane Gauss-Newton step: residual
    n_i . (R s_i + t - q_i) with R ~ I + [w]x, the 6x6 normal equations;
    a 4x4 f64 transform."""
    src, tgt, normals, weights = (x.to(_F64)
                                  for x in (src, tgt, normals, weights))
    jac = torch.cat([torch.cross(src, normals, dim=1), normals], 1)  # (N, 6)
    res = torch.sum((src - tgt) * normals, 1)
    jw = jac * weights[:, None]
    a = jw.T @ jac + torch.eye(6, dtype=jac.dtype, device=jac.device) * 1e-9
    x = torch.linalg.solve(a, -(jw.T @ res))
    return T.make_tf(T.euler_to_mat(x[0], x[1], x[2]), x[3:6])


def registration_icp(source: torch.Tensor, source_valid: torch.Tensor,
                     target: torch.Tensor, target_valid: torch.Tensor,
                     max_corr_dist: float,
                     init_tf: Optional[torch.Tensor] = None,
                     estimation: str = "point_to_point",
                     max_iterations: int = 100,
                     relative_fitness: float = 1e-2,
                     relative_rmse: float = 1e-2,
                     target_normals: Optional[torch.Tensor] = None
                     ) -> ICPResult:
    """Open3D-parity ICP of source (N, 3) onto target (M, 3), both with
    validity masks, on their device. Stops when both the fitness and the
    rmse change by less than `relative_fitness` / `relative_rmse` (absolute
    changes, as Open3D compares them) or after `max_iterations`."""
    if estimation not in ("point_to_point", "point_to_plane"):
        raise ValueError(f"unknown estimation {estimation!r}")
    src = source.to(torch.float32)
    tgt = target.to(torch.float32)
    dev = src.device
    tf = (torch.eye(4, dtype=torch.float32, device=dev) if init_tf is None
          else init_tf.to(device=dev, dtype=torch.float32))
    if estimation == "point_to_plane" and target_normals is None:
        target_normals = pc.estimate_normals(tgt, target_valid)

    max_d2 = float(torch.tensor(max_corr_dist, dtype=torch.float32) ** 2)
    n_src = torch.clamp(torch.sum(source_valid.to(_F64)), min=1.0)

    def correspondences(tf):
        moved = T.apply_tf(tf.to(_F64), src.to(_F64)).to(torch.float32)
        idx, d2 = knn_ops.nn(moved, tgt, target_valid)
        w = (source_valid & (d2 <= max_d2)).to(_F64)
        fitness = torch.sum(w) / n_src
        rmse = torch.sqrt(torch.sum(d2.to(_F64) * w)
                          / torch.clamp(torch.sum(w), min=1e-9))
        return moved, tgt[idx.long()], w, fitness, rmse

    prev_fitness = torch.tensor(-1.0, dtype=_F64, device=dev)
    prev_rmse = torch.tensor(torch.inf, dtype=_F64, device=dev)
    it = 0
    while it < max_iterations:
        moved, matched, w, fitness, rmse = correspondences(tf)
        if estimation == "point_to_point":
            delta = _kabsch(moved, matched, w)
        else:
            delta = _point2plane_step(moved, matched, target_normals, w)
        tf = (delta @ tf.to(_F64)).to(torch.float32)
        it += 1
        converged = ((torch.abs(prev_fitness - fitness) < relative_fitness)
                     & (torch.abs(prev_rmse - rmse) < relative_rmse))
        prev_fitness, prev_rmse = fitness, rmse
        if converged.item():
            break
    _, _, _, fitness, rmse = correspondences(tf)
    return ICPResult(tf, fitness.to(torch.float32), rmse.to(torch.float32),
                     it)


def icp_regression(target: torch.Tensor, target_valid: torch.Tensor,
                   source: torch.Tensor, source_valid: torch.Tensor,
                   voxel_size: float = 5.0, threshold: float = 100.0,
                   icp_point2point: bool = True, icp_point2plane: bool = True,
                   global_regression: bool = False):
    """Voxel-downsample both clouds, optionally take the FPFH + RANSAC
    global registration of the downsampled clouds as the initial transform
    (`ops/global_registration.py`), then point-to-point ICP followed by
    point-to-plane refinement, registering source onto target. Returns
    (downsampled target, tvalid, downsampled source, svalid, tf), tf
    moving the source into the target frame."""
    tgt, tvalid = pc.voxel_downsample(target, target_valid, voxel_size)
    src, svalid = pc.voxel_downsample(source, source_valid, voxel_size)
    tf = torch.eye(4, dtype=torch.float32, device=src.device)
    if global_regression:
        tf = greg.global_registration(src, svalid, tgt, tvalid,
                                      voxel_size).transformation
    for on, estimation in ((icp_point2point, "point_to_point"),
                           (icp_point2plane, "point_to_plane")):
        if on:
            tf = registration_icp(src, svalid, tgt, tvalid, threshold, tf,
                                  estimation).transformation
    return tgt, tvalid, src, svalid, tf
