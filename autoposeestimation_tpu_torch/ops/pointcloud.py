"""Point-cloud primitives on static shapes (port of
`autoposeestimation_tpu/ops/pointcloud.py`): voxel downsampling, radius and
statistical outlier removal, Mahalanobis distances, normals, AABB centres,
line triangulation.

Variable-size clouds are (N, 3) f32 tensors plus boolean validity masks;
every op returns the same padded shape plus an updated mask. `pad_bucket`,
`pad_cloud` and `compact` are the host (numpy) helpers around them.

The reconstruction chains these ops with ICP merges, and a merge amplifies
a last-bit difference into a different cloud (a voxel mean one ulp off
moves the next ICP result, which moves every later voxel). So every op
gives the same bits on the CPU and on CUDA:
  * `voxel_downsample` orders the points by voxel with successive stable
    sorts (the keys of `jnp.lexsort`, least significant first) and sums each
    voxel's points in that order with a sort-based segment reduce, one
    elementwise f32 add per rank within the voxels (as many steps as the
    fullest voxel holds points). That is the order of XLA's scatter behind
    `jax.ops.segment_sum` on the CPU, so the means also match the JAX
    package's bit for bit. `index_add_` was not taken: on CUDA it adds with
    atomics in a varying order.
  * distances, covariances and the statistics of the outlier tests are
    computed in f64, from differences of the f32 coordinates (exact in
    f64) in a fixed elementwise order; a decision (d2 <= r2, d <= thresh)
    then only differs between devices for a value within ~1e-16 of its
    threshold. The JAX package's f32 expansion |q|^2 + |r|^2 - 2 q.r is off
    by ~1e-2 mm^2 at 100 mm, so a point that close to a threshold may
    decide otherwise than there.
Outputs are f32, as the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import knn as knn_ops


def compact(points, valid) -> np.ndarray:
    """Host: the valid points as a dense numpy (K, 3) array."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    if isinstance(valid, torch.Tensor):
        valid = valid.detach().cpu().numpy()
    return np.asarray(points)[np.asarray(valid)]


def aabb_center(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Midpoint of the axis-aligned bounding box of the valid points."""
    lo = torch.where(valid[:, None], points, torch.inf).amin(0)
    hi = torch.where(valid[:, None], points, -torch.inf).amax(0)
    return lo + (hi - lo) / 2.0


def centroid(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = valid.to(points.dtype)[:, None]
    return torch.sum(points * w, 0) / torch.clamp(torch.sum(w), min=1.0)


def voxel_downsample(points: torch.Tensor, valid: torch.Tensor,
                     voxel_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-grid downsample (Open3D semantics: voxel ids floor((p -
    min_bound) / voxel_size), each voxel's mean). Returns (out (N, 3),
    out_valid (N,)): the first K entries are the voxel means in voxel-id
    order, K = out_valid.sum()."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    lo = torch.where(valid[:, None], pts, torch.inf).amin(0)
    ijk = torch.clamp(torch.floor((pts - lo) / voxel_size), 0, 2 ** 20 - 1
                      ).to(torch.int32)
    order = torch.arange(n, device=pts.device)
    for key in (ijk[:, 2], ijk[:, 1], ijk[:, 0], (~valid).to(torch.int32)):
        order = order[torch.sort(key[order], stable=True).indices]
    sijk, spts, svalid = ijk[order], pts[order], valid[order]

    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=pts.device),
                        (sijk[1:] != sijk[:-1]).any(1)]) & svalid
    # the valid entries come first, each voxel's points contiguous
    starts = torch.nonzero(is_new)[:, 0]
    k = starts.shape[0]
    out = torch.zeros_like(pts)
    if k:
        counts = torch.diff(torch.cat([starts, svalid.sum()[None]]))
        acc = torch.zeros((k, 3), dtype=torch.float32, device=pts.device)
        for j in range(int(counts.max())):
            rows = torch.clamp(starts + j, max=n - 1)
            acc = acc + torch.where((counts > j)[:, None], spts[rows], 0.0)
        out[:k] = acc / counts.to(torch.float32)[:, None]
    return out, torch.arange(n, device=pts.device) < k


def remove_radius_outliers(points: torch.Tensor, valid: torch.Tensor,
                           nb_points: int, radius) -> torch.Tensor:
    """Keep the valid points with at least `nb_points` valid points (itself
    included, as Open3D counts) within `radius`; returns the new mask."""
    n = points.shape[0]
    chunk = min(n, 1024)
    r2 = float(np.float32(radius) ** 2)
    counts = torch.empty(n, dtype=torch.int64, device=points.device)
    for c0 in range(0, n, chunk):
        d2 = knn_ops.dist2_f64(points[c0:c0 + chunk], points)
        counts[c0:c0 + chunk] = ((d2 <= r2) & valid[None, :]).sum(1)
    return valid & (counts >= nb_points)


def mean_knn_dists(points: torch.Tensor, valid: torch.Tensor,
                   nb_neighbors: int) -> torch.Tensor:
    """Mean distance from each point to its `nb_neighbors` nearest valid
    points, itself excluded."""
    _, dist = knn_ops.knn_k(points, points, nb_neighbors + 1,
                            ref_valid=valid)
    return torch.mean(dist[:, 1:].to(torch.float64), 1).to(torch.float32)


def remove_statistical_outliers(points: torch.Tensor, valid: torch.Tensor,
                                nb_neighbors: int, std_ratio
                                ) -> torch.Tensor:
    """Open3D remove_statistical_outlier: drop the points whose mean kNN
    distance exceeds mean + std_ratio * std over the valid cloud."""
    d = mean_knn_dists(points, valid, nb_neighbors).to(torch.float64)
    w = valid.to(torch.float64)
    n = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(d * w) / n
    var = torch.sum(w * (d - mu) ** 2) / n
    thresh = mu + std_ratio * torch.sqrt(torch.clamp(var, min=0.0))
    return valid & (d <= thresh)


def mahalanobis(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-point Mahalanobis distance to the valid cloud's own distribution
    (0 for invalid points)."""
    pts = points.to(torch.float64)
    w = valid.to(torch.float64)[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(pts * w, 0) / n
    centered = (pts - mu) * w
    cov = centered.T @ centered / n
    cov = cov + torch.eye(3, dtype=torch.float64, device=pts.device) * 1e-9
    d = pts - mu
    m2 = torch.sum((d @ torch.linalg.inv(cov)) * d, 1)
    return (torch.sqrt(torch.clamp(m2, min=0.0)) * w[:, 0]).to(torch.float32)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor,
                     k: int = 30) -> torch.Tensor:
    """Per-point normals: the eigenvector of the smallest eigenvalue of the
    k-NN neighbourhood covariance (sign not oriented, as in Open3D without
    orientation propagation)."""
    idx, _ = knn_ops.knn_k(points, points, k, ref_valid=valid)
    nbrs = points.to(torch.float64)[idx.long()]             # (N, k, 3)
    c = nbrs - torch.mean(nbrs, 1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c) / k
    _, vecs = torch.linalg.eigh(cov)                        # ascending
    return vecs[:, :, 0].to(torch.float32)


def kabsch_np(src: np.ndarray, tgt: np.ndarray,
              weights: np.ndarray) -> np.ndarray:
    """Weighted closed-form rigid alignment src -> tgt (Umeyama without
    scale) of (..., N, 3) points in numpy f64: (..., 4, 4) transforms."""
    s, t = src.astype(np.float64), tgt.astype(np.float64)
    w = weights.astype(np.float64)[..., None]
    wsum = np.maximum(w.sum(-2), 1e-9)
    mu_s = (s * w).sum(-2) / wsum
    mu_t = (t * w).sum(-2) / wsum
    # einsum, not BLAS: one thread, the same order of sums on every call
    h = np.einsum("...ni,...nj->...ij", (s - mu_s[..., None, :]) * w,
                  t - mu_t[..., None, :])
    u, _, vt = np.linalg.svd(h)
    v, ut = np.swapaxes(vt, -1, -2), np.swapaxes(u, -1, -2)
    diag = np.ones(h.shape[:-1])
    diag[..., 2] = np.sign(np.linalg.det(np.einsum("...ij,...jk->...ik", v,
                                                   ut)))
    r = np.einsum("...ij,...jk->...ik", v, diag[..., :, None] * ut)
    tf = np.zeros(h.shape[:-2] + (4, 4))
    tf[..., :3, :3] = r
    tf[..., :3, 3] = mu_t - np.einsum("...ij,...j->...i", r, mu_s)
    tf[..., 3, 3] = 1.0
    return tf


def intersect_line_line(p1, d1, p2, d2):
    """Closest points between lines (point, direction), (3,) or batched
    (..., 3): (point on line 1, point on line 2)."""
    d1 = d1 / torch.clamp(torch.linalg.vector_norm(d1, dim=-1, keepdim=True),
                          min=1e-12)
    d2 = d2 / torch.clamp(torch.linalg.vector_norm(d2, dim=-1, keepdim=True),
                          min=1e-12)
    r = p1 - p2
    a = torch.sum(d1 * d1, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d2 * d2, -1)
    d = torch.sum(d1 * r, -1)
    e = torch.sum(d2 * r, -1)
    denom = a * c - b * b
    ok = torch.abs(denom) > 1e-12
    t1 = torch.where(ok, (b * e - c * d) / denom, 0.0)
    t2 = torch.where(ok, (a * e - b * d) / denom, 0.0)
    return p1 + t1[..., None] * d1, p2 + t2[..., None] * d2


def triangulate_position(origins: torch.Tensor,
                         directions: torch.Tensor) -> torch.Tensor:
    """Mean of the midpoints of the closest points of every pair of lines
    (camera rays toward the object), origins/directions (V, 3)."""
    v = origins.shape[0]
    ii, jj = torch.triu_indices(v, v, offset=1, device=origins.device)
    a1, a2 = intersect_line_line(origins[ii], directions[ii],
                                 origins[jj], directions[jj])
    return torch.mean(a1 + (a2 - a1) / 2.0, 0)


def bucket_size(n: int, min_size: int = 1024) -> int:
    """The smallest min_size * 2^k >= n."""
    size = min_size
    while size < n:
        size *= 2
    return size


def pad_bucket(points, min_size: int = 1024):
    """Host: pad to `bucket_size`, so chains of cloud ops see a bounded set
    of shapes."""
    return pad_cloud(np.asarray(points, np.float32),
                     bucket_size(max(len(points), 1), min_size))


def pad_cloud(points, size: int):
    """Host: pad a (K, 3) array to (size, 3) plus a validity mask."""
    points = np.asarray(points, np.float32)
    k = len(points)
    if k > size:
        raise ValueError(f"cloud of {k} points exceeds static size {size}")
    out = np.zeros((size, 3), np.float32)
    out[:k] = points
    valid = np.zeros(size, bool)
    valid[:k] = True
    return out, valid


def to_device(points: np.ndarray, valid: np.ndarray, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host (points, valid) -> tensors on `device`."""
    return (torch.as_tensor(np.asarray(points, np.float32), device=device),
            torch.as_tensor(np.asarray(valid, bool), device=device))
