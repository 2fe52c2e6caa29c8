"""Symmetric ADD-S matched-distance moments, forward (counterpart of
`autoposeestimation_tpu/ops/pallas_addloss.py`'s primal path).

For each candidate pose (R, t) of each sample, the M model points are
transformed, each is matched to its nearest target, and the mean `dis` and
the sample standard deviation (ddof=1, centered two-pass variance) of the
matched distances come back. Batched: one call, and on the card one kernel
launch, serves a whole evaluation batch.

Two implementations of the same function:
  * `moments_cuda`: the hand-written kernel `csrc/sym_moments.cu`, which
    replaces `_moments_kernel` (pallas_addloss.py:71); it counts its
    launches in `moments_cuda.launches`,
  * `moments_plain`: plain PyTorch mirroring `_dmin_candidate`
    (pallas_addloss.py:417), chunked over candidates so that one
    (chunk, M, M) distance tile is alive at a time.
`moments` picks by device: the kernel for CUDA tensors, the plain version
for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils import transforms as T
from . import kernel_build

KERNEL = "sym_moments"
# Largest M whose staged points fit the 227 KB of shared memory of a block
# (36 bytes a point, csrc/sym_moments.cu).
MAX_POINTS = 6400
# Bound on the plain version's (chunk, M, M) tile: 2^24 f32 elements.
_CHUNK_ELEMS = 1 << 24


def moments_plain(rot: torch.Tensor, pred_t: torch.Tensor,
                  model: torch.Tensor, target: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rot (B, N, 3, 3), pred_t (B, N, 3), model/target (B, M, 3) ->
    (dis (B, N), var (B, N)), var the centered sample variance."""
    b, n = rot.shape[:2]
    m = model.shape[1]
    chunk = max(1, min(n, _CHUNK_ELEMS // max(m * m, 1)))
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load(KERNEL)
    lib.sym_moments_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.sym_moments_fwd.restype = ctypes.c_int
    lib.sym_moments_error_string.argtypes = [ctypes.c_int]
    lib.sym_moments_error_string.restype = ctypes.c_char_p
    return lib


def moments_cuda(rot: torch.Tensor, pred_t: torch.Tensor,
                 model: torch.Tensor, target: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel; same contract as `moments_plain`. Inputs must be
    contiguous f32 CUDA tensors on one sm_90 device."""
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
    if not 1 <= m <= MAX_POINTS:
        raise ValueError(f"M must be in [1, {MAX_POINTS}]: {m}")
    for name, t in (("rot", rot), ("pred_t", pred_t), ("model", model),
                    ("target", target)):
        if t.device != rot.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on {rot.device} (CUDA)")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if torch.cuda.get_device_capability(rot.device) != (9, 0):
        raise RuntimeError("the sym_moments kernel is built for sm_90a")
    dis = torch.empty((b, n), dtype=torch.float32, device=rot.device)
    var = torch.empty_like(dis)
    if b * n == 0:
        return dis, var
    lib = _library()
    with torch.cuda.device(rot.device):
        err = lib.sym_moments_fwd(
            rot.data_ptr(), pred_t.data_ptr(), model.data_ptr(),
            target.data_ptr(), dis.data_ptr(), var.data_ptr(), b, n, m,
            torch.cuda.current_stream(rot.device).cuda_stream)
    if err != 0:
        raise RuntimeError("sym_moments kernel launch failed: "
                           + lib.sym_moments_error_string(err).decode())
    moments_cuda.launches += 1
    return dis, var


moments_cuda.launches = 0


def moments(rot, pred_t, model, target):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if rot.device.type == "cuda":
        return moments_cuda(rot, pred_t, model, target)
    if rot.device.type == "cpu":
        return moments_plain(rot, pred_t, model, target)
    raise ValueError(f"unsupported device {rot.device}")


def sym_moments(quat: torch.Tensor, trans: torch.Tensor, points: torch.Tensor,
                model_points: torch.Tensor, target: torch.Tensor):
    """quat (B, N, 4), trans/points (B, N, 3), model_points/target (B, M, 3)
    -> (dis (B, N), std (B, N)) of the matched distances of the candidate
    poses (quat, points + trans)."""
    rot = T.quat_to_mat(quat).to(torch.float32).contiguous()
    pred_t = (points + trans).to(torch.float32).contiguous()
    dis, var = moments(rot, pred_t,
                       model_points.to(torch.float32).contiguous(),
                       target.to(torch.float32).contiguous())
    return dis, torch.sqrt(torch.clamp(var, min=0.0))
