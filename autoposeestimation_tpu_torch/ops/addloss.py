"""Symmetric ADD-S matched-distance moments and their gradient (counterpart
of `autoposeestimation_tpu/ops/pallas_addloss.py`).

For each candidate pose (R, t) of each sample, the M model points are
transformed, each is matched to its nearest target, and the mean `dis` and
the sample standard deviation (ddof=1, centered two-pass variance) of the
matched distances come back. Batched: one call, and on the card one kernel
launch, serves a whole batch.

Forward only (evaluation), two implementations of one function:
  * `moments_cuda`: the hand-written kernel `csrc/sym_moments.cu`, which
    replaces `_moments_kernel` (pallas_addloss.py:71); it counts its
    launches in `moments_cuda.launches`,
  * `moments_plain`: plain PyTorch mirroring `_dmin_candidate`
    (pallas_addloss.py:417), chunked over candidates so that one
    (chunk, M, M) distance tile is alive at a time.
Training, the moments plus the gradient precursors in one pass:
  * `moments_train_cuda`: the kernel `csrc/sym_moments_train.cu`, which
    replaces `_train_kernel` (pallas_addloss.py:209); launches counted in
    `moments_train_cuda.launches`,
  * `moments_train_plain`: plain PyTorch in the kernel's arithmetic,
  * `SymMoments`: the autograd Function whose backward is the linear
    combination of the precursors (`_sym_moments_bwd`, :480).
`moments` and `moments_train` pick by device: the kernel for CUDA tensors,
the plain version for CPU tensors. Their calls count in `utils/flops.py`
as `moments_flops` (and a backward of `SymMoments` as
`moments_grad_flops`) whichever implementation runs.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from ..utils import flops as flop_count
from ..utils import transforms as T
from . import kernel_build

KERNEL = "sym_moments"
TRAIN_KERNEL = "sym_moments_train"
# Largest M whose staged points fit the 227 KB of shared memory of a block
# (20 bytes a point in csrc/sym_moments.cu, 48 in csrc/sym_moments_train.cu;
# both pad their targets to a multiple of 16, and 6400 and 4800 are ones).
MAX_POINTS = 6400
MAX_TRAIN_POINTS = 4800
# Bound on the plain versions' (chunk, M, M) tile: 2^24 f32 elements.
_CHUNK_ELEMS = 1 << 24
# Columns of a training row (the JAX kernel's layout): A_t, B_t, A_r, B_r
# (row-major), dis, var; 26..31 are zero.
TRAIN_COLS = 32


def _chunk(n: int, m: int) -> int:
    return max(1, min(n, _CHUNK_ELEMS // max(m * m, 1)))


def moments_plain(rot: torch.Tensor, pred_t: torch.Tensor,
                  model: torch.Tensor, target: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rot (B, N, 3, 3), pred_t (B, N, 3), model/target (B, M, 3) ->
    (dis (B, N), var (B, N)), var the centered sample variance."""
    b, n = rot.shape[:2]
    m = model.shape[1]
    chunk = _chunk(n, m)
    dis = torch.empty((b, n), dtype=torch.float32, device=rot.device)
    var = torch.empty_like(dis)
    for i in range(b):
        tt = torch.sum(target[i] * target[i], dim=1)
        for c0 in range(0, n, chunk):
            r = rot[i, c0:c0 + chunk]
            pred = (torch.einsum("mj,cij->cmi", model[i], r)
                    + pred_t[i, c0:c0 + chunk, None, :])      # (c, M, 3)
            pp = torch.sum(pred * pred, dim=2)
            d2 = (pp[:, :, None] + tt[None, None, :]
                  - 2.0 * torch.matmul(pred, target[i].T))   # (c, M, M)
            dmin = torch.sqrt(torch.clamp(d2.amin(dim=2), min=0.0))
            mean = dmin.mean(dim=1)
            dis[i, c0:c0 + chunk] = mean
            var[i, c0:c0 + chunk] = (
                torch.sum((dmin - mean[:, None]) ** 2, dim=1) / max(m - 1, 1))
    return dis, var


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def moments_train_plain(rot: torch.Tensor, pred_t: torch.Tensor,
                        model: torch.Tensor, target: torch.Tensor,
                        bf16: bool = False) -> torch.Tensor:
    """rot (B, N, 3, 3), pred_t (B, N, 3), model/target (B, M, 3) -> (B, N,
    32) f32 rows [A_t, B_t, A_r, B_r, dis, var, 0...] (`_train_kernel`).

    f32 mode measures d2 in direct form (p - t)^2; bf16 mode in the JAX
    kernel's expansion form [p, 1, |p|^2] . [-2t, |t|^2, 1] over operands
    rounded to bf16, summed in that order in f32 (each product of two bf16
    values is exact in f32), and matches against the bf16-rounded targets.
    The candidate transform runs in the kernel's order,
    ((r0 m_x + r1 m_y) + r2 m_z) + t."""
    b, n = rot.shape[:2]
    m = model.shape[1]
    chunk = _chunk(n, m)
    out = torch.zeros((b, n, TRAIN_COLS), dtype=torch.float32,
                      device=rot.device)
    inv_m, inv_m1 = 1.0 / m, 1.0 / max(m - 1, 1)
    wcap = 1.0 / math.sqrt(max(m - 1, 1))
    for i in range(b):
        mx, my, mz = model[i].unbind(1)                          # (M,)
        tgt = target[i]
        if bf16:
            src = _bf16(tgt)                  # the matched targets (traw4)
            tcol = -2.0 * src                 # == bf16(-2 t), exactly
            tt = _bf16((tgt[:, 0] * tgt[:, 0] + tgt[:, 1] * tgt[:, 1])
                       + tgt[:, 2] * tgt[:, 2])
        else:
            src = tgt
        for c0 in range(0, n, chunk):
            r = rot[i, c0:c0 + chunk, :, :, None]                # (c, 3, 3, 1)
            t = pred_t[i, c0:c0 + chunk, :, None]                # (c, 3, 1)
            pred = ((r[:, :, 0] * mx + r[:, :, 1] * my) + r[:, :, 2] * mz
                    + t).transpose(1, 2)                         # (c, M, 3)
            px, py, pz = (v[:, :, None] for v in pred.unbind(2))
            if bf16:
                pb = _bf16(pred)
                pp = _bf16((pred[..., 0] * pred[..., 0]
                            + pred[..., 1] * pred[..., 1])
                           + pred[..., 2] * pred[..., 2])
                d2 = pb[..., 0, None] * tcol[:, 0]
                d2 = d2 + pb[..., 1, None] * tcol[:, 1]
                d2 = d2 + pb[..., 2, None] * tcol[:, 2]
                d2 = (d2 + tt) + pp[..., None]                   # (c, M, M)
            else:
                dx, dy, dz = px - tgt[:, 0], py - tgt[:, 1], pz - tgt[:, 2]
                d2 = dx * dx + dy * dy + dz * dz
            dmin2 = d2.amin(dim=2, keepdim=True)
            # every target at the minimum distance: ties average
            ind = (d2 <= dmin2).to(torch.float32)
            matched = torch.matmul(ind, src) / ind.sum(2)[..., None]
            dmin = torch.sqrt(torch.clamp(dmin2[..., 0], min=0.0))  # (c, M)
            dis = dmin.sum(1) * inv_m
            dd = dmin - dis[:, None]
            var = (dd * dd).sum(1) * inv_m1
            std = torch.clamp(torch.sqrt(var), min=1e-12)
            # u normalized by the direct |pred - matched|, not by dmin
            diff = pred - matched
            dn2 = (diff * diff).sum(2, keepdim=True)
            u = diff / torch.sqrt(torch.clamp(dn2, min=1e-24))
            wvec = torch.clamp(dd * inv_m1 / std[:, None], -wcap, wcap)
            wu = u * wvec[..., None]
            cols = [u.sum(1) * inv_m, wu.sum(1),
                    torch.einsum("cma,mb->cab", u, model[i]).flatten(1)
                    * inv_m,
                    torch.einsum("cma,mb->cab", wu, model[i]).flatten(1),
                    dis[:, None], var[:, None]]
            out[i, c0:c0 + chunk, :26] = torch.cat(cols, dim=1)
    return out


def _check_inputs(rot, pred_t, model, target, max_points: int,
                  name: str) -> Tuple[int, int, int]:
    """The kernels' contract: contiguous f32 CUDA tensors on one sm_90
    device, rot (B, N, 3, 3), pred_t (B, N, 3), model/target (B, M, 3)."""
    if rot.dim() != 4 or rot.shape[2:] != (3, 3):
        raise ValueError(f"rot must be (B, N, 3, 3): {tuple(rot.shape)}")
    b, n = rot.shape[:2]
    if pred_t.shape != (b, n, 3):
        raise ValueError(f"pred_t must be {(b, n, 3)}: {tuple(pred_t.shape)}")
    if model.dim() != 3 or model.shape[0] != b or model.shape[2] != 3:
        raise ValueError(f"model must be (B, M, 3): {tuple(model.shape)}")
    m = model.shape[1]
    if target.shape != model.shape:
        raise ValueError(f"target must be {tuple(model.shape)}: "
                         f"{tuple(target.shape)}")
    if not 1 <= m <= max_points:
        raise ValueError(f"M must be in [1, {max_points}]: {m}")
    for arg, t in (("rot", rot), ("pred_t", pred_t), ("model", model),
                   ("target", target)):
        if t.device != rot.device or t.device.type != "cuda":
            raise ValueError(f"{arg} must be on {rot.device} (CUDA)")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous float32")
    if torch.cuda.get_device_capability(rot.device) != (9, 0):
        raise RuntimeError(f"the {name} kernel is built for sm_90a")
    return b, n, m


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = kernel_build.load(name)
    if name == KERNEL:
        lib.sym_moments_fwd.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.sym_moments_fwd.restype = ctypes.c_int
    else:
        lib.sym_moments_train.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.sym_moments_train.restype = ctypes.c_int
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = getattr(_library(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def moments_cuda(rot: torch.Tensor, pred_t: torch.Tensor,
                 model: torch.Tensor, target: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel; same contract as `moments_plain`. Inputs must be
    contiguous f32 CUDA tensors on one sm_90 device."""
    b, n, m = _check_inputs(rot, pred_t, model, target, MAX_POINTS, KERNEL)
    dis = torch.empty((b, n), dtype=torch.float32, device=rot.device)
    var = torch.empty_like(dis)
    if b * n == 0:
        return dis, var
    with torch.cuda.device(rot.device):
        err = _library(KERNEL).sym_moments_fwd(
            rot.data_ptr(), pred_t.data_ptr(), model.data_ptr(),
            target.data_ptr(), dis.data_ptr(), var.data_ptr(), b, n, m,
            torch.cuda.current_stream(rot.device).cuda_stream)
    _raise_on(err, KERNEL)
    moments_cuda.launches += 1
    return dis, var


moments_cuda.launches = 0


def moments_train_cuda(rot: torch.Tensor, pred_t: torch.Tensor,
                       model: torch.Tensor, target: torch.Tensor,
                       bf16: bool = False) -> torch.Tensor:
    """The CUDA training kernel; same contract as `moments_train_plain`.
    Inputs must be contiguous f32 CUDA tensors on one sm_90 device."""
    b, n, m = _check_inputs(rot, pred_t, model, target, MAX_TRAIN_POINTS,
                            TRAIN_KERNEL)
    out = torch.empty((b, n, TRAIN_COLS), dtype=torch.float32,
                      device=rot.device)
    if b * n == 0:
        return out
    with torch.cuda.device(rot.device):
        err = _library(TRAIN_KERNEL).sym_moments_train(
            rot.data_ptr(), pred_t.data_ptr(), model.data_ptr(),
            target.data_ptr(), out.data_ptr(), b, n, m, int(bool(bf16)),
            torch.cuda.current_stream(rot.device).cuda_stream)
    _raise_on(err, TRAIN_KERNEL)
    moments_train_cuda.launches += 1
    return out


moments_train_cuda.launches = 0


def moments_flops(b: int, n: int, m: int) -> int:
    """The FLOPs of one forward call at (B, N, M): the JAX package's CPU
    count (XLA's cost analysis) of `sym_moments(use_pallas=False)` over a
    batch of B, N candidates and M points: per candidate the (M, M)
    expansion-form distances and their minimum (10 M^2), the transformed
    model points, norms, mean and std (33 M + 49); per sample the targets'
    norms (5 M). Equal to XLA's count where it reduces the minimum in
    pairs (M = 4 ... 32, 64, 96, 128); at other M XLA's reduction splits
    otherwise and counts up to 0.3 % more."""
    return b * (n * (10 * m * m + 33 * m + 49) + 5 * m)


def moments_grad_flops(b: int, n: int, m: int) -> int:
    """The FLOPs of the backward at (B, N, M): the JAX package's CPU count
    of the custom VJP's backward (`_sym_moments_bwd`, XLA path; its count
    of the VJP less that of the forward): the argmin recompute and the
    gradient of each candidate, 17 M^2 + 76 M + 184 a candidate, at the
    same M as `moments_flops`."""
    return b * n * (17 * m * m + 76 * m + 184)


def _by_device(cuda_fn, plain_fn, rot, *args):
    if rot.device.type == "cuda":
        fn = cuda_fn
    elif rot.device.type == "cpu":
        fn = plain_fn
    else:
        raise ValueError(f"unsupported device {rot.device}")
    b, n = rot.shape[:2]
    return flop_count.hand_kernel(moments_flops(b, n, args[1].shape[1]), fn,
                                  rot, *args)


def moments(rot, pred_t, model, target):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    return _by_device(moments_cuda, moments_plain, rot, pred_t, model,
                      target)


def moments_train(rot, pred_t, model, target, bf16: bool = False):
    """The training kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _by_device(moments_train_cuda, moments_train_plain, rot, pred_t,
                      model, target, bf16)


class SymMoments(torch.autograd.Function):
    """(rot (B, N, 3, 3), pred_t (B, N, 3), model, target (B, M, 3), bf16)
    -> (dis, std) (B, N), differentiable in rot and pred_t. The forward
    keeps the 24 precursors of one training-kernel pass; the backward is
    their linear combination (`_sym_moments_bwd`, pallas_addloss.py:480).
    `std` comes out of the Function because B_* already carry its 1/std."""

    @staticmethod
    def forward(ctx, rot, pred_t, model, target, bf16):
        out = moments_train(rot, pred_t, model, target, bf16)
        ctx.save_for_backward(out[..., :24])
        ctx.points = model.shape[1]
        return out[..., 24], torch.sqrt(torch.clamp(out[..., 25], min=0.0))

    @staticmethod
    def backward(ctx, g_dis, g_std):
        (pre,) = ctx.saved_tensors
        b, n = pre.shape[:2]
        flop_count.add(moments_grad_flops(b, n, ctx.points))
        a_t, b_t = pre[..., 0:3], pre[..., 3:6]
        a_r = pre[..., 6:15].unflatten(-1, (3, 3))
        b_r = pre[..., 15:24].unflatten(-1, (3, 3))
        g_rot = g_dis[..., None, None] * a_r + g_std[..., None, None] * b_r
        g_pred_t = g_dis[..., None] * a_t + g_std[..., None] * b_t
        return g_rot, g_pred_t, None, None, None


def sym_moments(quat: torch.Tensor, trans: torch.Tensor, points: torch.Tensor,
                model_points: torch.Tensor, target: torch.Tensor,
                bf16: bool = False):
    """quat (B, N, 4), trans/points (B, N, 3), model_points/target (B, M, 3)
    -> (dis (B, N), std (B, N)) of the matched distances of the candidate
    poses (quat, points + trans). Under grad (quat, trans or points
    requiring it) it runs the training kernel through `SymMoments`; else
    the forward kernel in f32 mode, and the training kernel's moments in
    bf16 mode (the same function as `_moments_fwd(cross_dtype=bf16)`)."""
    rot = T.quat_to_mat(quat).to(torch.float32).contiguous()
    pred_t = (points + trans).to(torch.float32).contiguous()
    model = model_points.to(torch.float32).contiguous()
    target = target.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and (quat.requires_grad or trans.requires_grad
                                    or points.requires_grad):
        return SymMoments.apply(rot, pred_t, model, target, bf16)
    if bf16:
        out = moments_train(rot, pred_t, model, target, True)
        return out[..., 24], torch.sqrt(torch.clamp(out[..., 25], min=0.0))
    dis, var = moments(rot, pred_t, model, target)
    return dis, torch.sqrt(torch.clamp(var, min=0.0))
