"""Nearest-neighbour ops (port of `autoposeestimation_tpu/ops/knn.py`).

1-nearest neighbour, the function of the TPU kernel `_nn_kernel`
(knn.py:119, wrapper `nn_pallas`), in two implementations:
  * `nn_cuda`: the hand-written kernel `csrc/nn.cu` (a scan over S
    contiguous reference ranges, `nn_splits`, then a merge in range order);
    it counts its calls in `nn_cuda.launches`,
  * `nn_plain`: plain PyTorch in the same arithmetic, chunked over queries.
`nn` picks by device: the kernel for CUDA tensors, the plain version for
CPU tensors; its calls count in `utils/flops.py` as `nn_flops` either way.

The function, as `_nn_kernel` computes it (not as `nn_xla` does):
  * d2 = (|q|^2 + |r|^2) - 2 q.r in f32, with |v|^2 = (x x + y y) + z z
    (each product rounded) and q.r = fma(qz, rz, fma(qy, ry, qx rx)), the
    order in which XLA's CPU dot evaluates the interpret-mode kernel;
  * invalid references give d2 = +inf;
  * the minimum and its first index over the raw d2, then d2 clamped to
    >= 0. `nn_xla` clamps every d2 before its argmin, so where several
    references have d2 <= 0 it picks the first of them while this picks
    the most negative;
  * with every reference invalid: index 0 and d2 = +inf.

`knn_k` and `min_dists` are plain PyTorch, as they are XLA in the JAX
package. They measure distances in f64 from the differences of the f32
coordinates (`dist2_f64`), so the CPU and CUDA rank neighbours alike (see
`ops/pointcloud.py`); the JAX package's clamped f32 expansion
(`_dist2_block`) differs from it by its rounding.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils import flops as flop_count
from . import kernel_build

KERNEL = "nn"
# Candidates `knn_k` takes beyond k, to order exact ties by index.
_TIE_MARGIN = 16
# Bound on the plain version's (chunk, M) f64 temporaries.
_CHUNK_ELEMS = 1 << 22


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 fma(a, b, c) of f32 tensors. a*b is exact in
    f64; the f64 sum is rounded to odd (its error from TwoSum sets the last
    bit), so the final rounding to f32 is the single rounding of an fma."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).float()


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]


def nn_plain(query: torch.Tensor, ref: torch.Tensor,
             ref_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (N, 3), ref (M, 3), ref_valid (M,) bool -> (idx (N,) int32,
    d2 (N,) f32), the function of `_nn_kernel`."""
    query = query.to(torch.float32)
    ref = ref.to(torch.float32)
    n, m = query.shape[0], ref.shape[0]
    rr = _sq_norm(ref)
    if ref_valid is not None:
        rr = torch.where(ref_valid, rr, torch.inf)
    idx = torch.zeros(n, dtype=torch.int32, device=query.device)
    d2 = torch.full((n,), torch.inf, dtype=torch.float32, device=query.device)
    if m == 0:
        return idx, d2
    chunk = max(1, min(n, _CHUNK_ELEMS // m))
    rx, ry, rz = (ref[None, :, k] for k in range(3))
    for c0 in range(0, n, chunk):
        q = query[c0:c0 + chunk]
        qx, qy, qz = (q[:, k, None] for k in range(3))
        qr = _fma(qz, rz, _fma(qy, ry, qx * rx))
        dist = (_sq_norm(q)[:, None] + rr[None, :]) - 2.0 * qr
        best = torch.argmin(dist, dim=1)        # the first index of the min
        idx[c0:c0 + chunk] = best.to(torch.int32)
        d2[c0:c0 + chunk] = torch.clamp(
            torch.gather(dist, 1, best[:, None])[:, 0], min=0.0)
    return idx, d2


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load(KERNEL)
    lib.nn_splits.argtypes = [ctypes.c_int] * 3
    lib.nn_splits.restype = ctypes.c_int
    lib.nn_search.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.nn_search.restype = ctypes.c_int
    lib.nn_error_string.argtypes = [ctypes.c_int]
    lib.nn_error_string.restype = ctypes.c_char_p
    return lib


def _launch_error(err: int) -> RuntimeError:
    return RuntimeError("nn kernel launch failed: "
                        + _library().nn_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _is_sm90(device: torch.device) -> bool:
    return torch.cuda.get_device_capability(device) == (9, 0)


def nn_splits(n: int, m: int, device: torch.device) -> int:
    """S, the reference ranges of an (n, m) `nn_cuda` call on `device`
    (chosen by `csrc/nn.cu`): range s holds references [floor(s M / S),
    floor((s + 1) M / S)). `device` without an index is the current one."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    splits = _library().nn_splits(n, m, index)
    if splits < 0:
        raise _launch_error(-splits)
    return splits


def nn_cuda(query: torch.Tensor, ref: torch.Tensor,
            ref_valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel; same contract as `nn_plain`. query (N, 3) and ref
    (M, 3) must be contiguous f32 and ref_valid (M,) contiguous bool, all
    on one sm_90 CUDA device."""
    if query.dim() != 2 or query.shape[1] != 3:
        raise ValueError(f"query must be (N, 3): {tuple(query.shape)}")
    if ref.dim() != 2 or ref.shape[1] != 3:
        raise ValueError(f"ref must be (M, 3): {tuple(ref.shape)}")
    n, m = query.shape[0], ref.shape[0]
    device = query.device
    tensors = [("query", query, torch.float32), ("ref", ref, torch.float32)]
    if ref_valid is not None:
        if ref_valid.shape != (m,):
            raise ValueError(f"ref_valid must be ({m},): "
                             f"{tuple(ref_valid.shape)}")
        tensors.append(("ref_valid", ref_valid, torch.bool))
    for name, t, dtype in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name} must be on {device} (CUDA)")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    if not _is_sm90(device):
        raise RuntimeError("the nn kernel is built for sm_90a")
    idx = torch.empty(n, dtype=torch.int32, device=device)
    d2 = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return idx, d2
    # each range's (raw d2 bits, first index) per query, 8 bytes
    partial = torch.empty((nn_splits(n, m, device), n), dtype=torch.int64,
                          device=device)
    err = _library().nn_search(
        query.data_ptr(), ref.data_ptr(),
        None if ref_valid is None else ref_valid.data_ptr(),
        partial.data_ptr(), idx.data_ptr(), d2.data_ptr(), n, m,
        device.index, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise _launch_error(err)
    nn_cuda.launches += 1
    return idx, d2


nn_cuda.launches = 0


def nn_flops(n: int, m: int, masked: bool = False) -> int:
    """The FLOPs of one `nn` call of N queries and M references: the JAX
    package's CPU count (XLA's cost analysis) of `nn_xla`, 19 M - 4 a
    query and 5 M for the references' norms, plus N M for the validity
    mask. XLA counts one 2,048-query block (its padding, and its loop's
    body once), so its count equals this one at N = 2,048."""
    return n * (19 * m - 4) + 5 * m + (n * m if masked else 0)


def nn(query: torch.Tensor, ref: torch.Tensor,
       ref_valid: Optional[torch.Tensor] = None
       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest reference per query (idx (N,) int32, d2 (N,) f32): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    query = query.to(torch.float32).contiguous()
    ref = ref.to(torch.float32).contiguous()
    if ref_valid is not None:
        ref_valid = ref_valid.to(torch.bool).contiguous()
    if query.device.type == "cuda":
        fn = nn_cuda
    elif query.device.type == "cpu":
        fn = nn_plain
    else:
        raise ValueError(f"unsupported device {query.device}")
    flops = nn_flops(query.shape[0], ref.shape[0], ref_valid is not None)
    return flop_count.hand_kernel(flops, fn, query, ref, ref_valid)


def dist2_f64(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Q, R) squared distances in f64, ((dx dx + dy dy) + dz dz): the
    differences of f32 coordinates are exact in f64, and the fixed
    elementwise order gives the same bits on every device."""
    q = q.to(torch.float64)
    r = r.to(torch.float64)
    d2 = None
    for k in range(3):
        d = q[:, k, None] - r[None, :, k]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def _masked_dist2(query, ref, ref_valid, chunk):
    """(chunk, M) f64 d2 blocks, invalid references +inf."""
    for c0 in range(0, query.shape[0], chunk):
        d2 = dist2_f64(query[c0:c0 + chunk], ref)
        if ref_valid is not None:
            d2 = torch.where(ref_valid[None, :], d2, torch.inf)
        yield c0, d2


def min_dists(query: torch.Tensor, ref: torch.Tensor,
              ref_valid: Optional[torch.Tensor] = None,
              chunk: int = 1024) -> torch.Tensor:
    """Distance (N,) f32 from each query to its nearest valid reference
    (`min_dists_xla`)."""
    out = torch.empty(query.shape[0], dtype=torch.float32,
                      device=query.device)
    for c0, d2 in _masked_dist2(query, ref, ref_valid, chunk):
        out[c0:c0 + chunk] = torch.sqrt(d2.amin(dim=1))
    return out


def knn_k(query: torch.Tensor, ref: torch.Tensor, k: int,
          ref_valid: Optional[torch.Tensor] = None, chunk: int = 1024
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest references per query, nearest first: (idx (N, k) int32,
    dist (N, k) f32). Equal distances come lower index first, as
    `lax.top_k` orders them, on every device: `torch.topk` takes
    _TIE_MARGIN candidates more, which are then ordered by (distance,
    index). (Clouds backprojected from a pixel grid hold exact distance
    ties, and which of them a neighbourhood takes moves FPFH's bins.)"""
    n = query.shape[0]
    idx = torch.empty((n, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((n, k), dtype=torch.float32, device=query.device)
    for c0, d2 in _masked_dist2(query, ref, ref_valid, chunk):
        take = min(k + _TIE_MARGIN, d2.shape[1])
        vals, ind = torch.topk(d2, take, dim=1, largest=False, sorted=True)
        ind, order = torch.sort(ind, dim=1)
        vals, order = torch.sort(torch.gather(vals, 1, order), dim=1,
                                 stable=True)
        ind = torch.gather(ind, 1, order)
        idx[c0:c0 + chunk] = ind[:, :k].to(torch.int32)
        dist[c0:c0 + chunk] = torch.sqrt(vals[:, :k])
    return idx, dist
