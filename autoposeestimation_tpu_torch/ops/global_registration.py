"""FPFH features and feature-matched RANSAC global registration (port of
`autoposeestimation_tpu/ops/global_registration.py`, whose docstring gives
the reference parameters): the initial transform of
`icp_regression(global_regression=True)` when two clouds start far apart.

As in the JAX package, a fixed batch of hypotheses is drawn, checked and
scored in parallel: 4 correspondences each, the edge-length (0.9) and
distance checks, a 4-point Kabsch, and the inliers of the whole
correspondence set within 1.5 voxels; the best is the first hypothesis
with the most inliers among those that pass. FPFH is Rusu et al.'s, as
Open3D computes it: three Darboux-frame angles binned 11 ways each, the
33-bin SPFH scaled by 100 / #neighbours, FPFH = SPFH + the 1/distance
weighted mean of the neighbours' SPFH.

What differs from the JAX package, so that the card and the CPU take the
same steps (the port's cloud ops and ICP do the same):
- Neighbourhoods break exact distance ties by index (`knn.knn_k`), and a
  normal whose outward direction is nearly tangent takes a canonical sign
  (`_orient_normals_outward`).
- The angles, the neighbour sums of FPFH, the feature distances, the
  hypotheses' Kabsch (on the host, as ICP's) and the inlier distances are
  computed in f64 from the f32 inputs, in fixed elementwise order, and the
  features and transforms rounded to f32 (the JAX package's types). JAX
  computes them in f32; the two agree to ~1e-6, and a bin differs only
  where an angle lies at a bin edge.
- The hypotheses are drawn uniformly over the valid correspondences from
  a `torch.Generator` on the CPU (seeded 0 by default, as JAX's default key
  is `PRNGKey(0)`) and then moved to the clouds' device, so both devices
  draw the same samples. `samples=` (H, 4) injects a draw, such as the one
  `jax.random.categorical` makes from a key.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import knn as knn_ops
from . import pointcloud as pc

_F32 = torch.float32
_F64 = torch.float64
_SCORE_CHUNK = 256      # hypotheses scored at a time


class GlobalRegResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) f32, source -> target
    fitness: torch.Tensor         # inlier share of the correspondence set
    inlier_rmse: torch.Tensor
    valid: torch.Tensor           # () bool: a hypothesis passed the checks


def _f32(x: float) -> float:
    """x rounded to f32, as a JAX f32 scalar holds it."""
    return float(torch.tensor(x, dtype=_F32))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot products over the last axis of 3, added in fixed order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _orient_normals_outward(points: torch.Tensor, valid: torch.Tensor,
                            normals: torch.Tensor) -> torch.Tensor:
    """Flip PCA normals to point away from the valid points' centroid (FPFH's
    angles are not sign invariant). Where the outward direction is nearly
    tangent, the JAX package keeps the eigen-solver's sign, which differs
    between LAPACK and cuSOLVER; the port takes the sign that makes the
    first nonzero component positive there."""
    first = torch.sign(normals[:, 0])
    for c in (1, 2):
        first = torch.where(first == 0, torch.sign(normals[:, c]), first)
    normals = normals * torch.where(first == 0, 1.0, first)[:, None]
    out = (points - pc.centroid(points, valid)).to(_F64)
    dot = _dot3(normals.to(_F64), out)
    scale = torch.sqrt(_dot3(out, out)) + 1e-9
    flip = torch.where(torch.abs(dot) > 1e-3 * scale, torch.sign(dot), 1.0)
    return normals * flip[:, None].to(normals.dtype)


def _hist11(x: torch.Tensor, lo: float, hi: float,
            weight: torch.Tensor) -> torch.Tensor:
    """Weighted 11-bin histogram over the last axis of x (N, K) -> (N, 11);
    the bin index is truncated toward zero, then clipped to [0, 10]."""
    b = torch.clamp(((x - lo) / (hi - lo) * 11.0).to(torch.int32), 0, 10)
    return torch.sum(F.one_hot(b.long(), 11).to(_F32) * weight[..., None],
                     dim=1)


def fpfh_angles(points: torch.Tensor, normals: torch.Tensor,
                idx: torch.Tensor, dist: torch.Tensor):
    """(alpha, phi, theta), each (N, K) f64: the Darboux-frame angles of
    every point against its K neighbours `idx` at distances `dist`."""
    p = points.to(_F64)
    n = normals.to(_F64)
    d = p[idx] - p[:, None, :]
    dhat = d / torch.clamp(dist.to(_F64), min=1e-9)[..., None]
    u = n[:, None, :].expand_as(dhat)
    n2 = n[idx]
    v = torch.linalg.cross(dhat, u, dim=-1)
    v = v / torch.clamp(torch.sqrt(_dot3(v, v)), min=1e-9)[..., None]
    w = torch.linalg.cross(u, v, dim=-1)
    return (_dot3(v, n2), _dot3(u, dhat),
            torch.atan2(_dot3(w, n2), _dot3(u, n2)))


def compute_fpfh(points: torch.Tensor, valid: torch.Tensor, radius: float,
                 k: int = 30, normals: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """33-d FPFH feature (N, 33) f32 of every point; points (N, 3), valid (N,)
    bool, `radius` the feature radius (5 voxels), `k` the neighbourhood
    bound. Invalid points get zeros."""
    pts = points.to(_F32)
    if normals is None:
        normals = pc.estimate_normals(pts, valid)
    normals = _orient_normals_outward(pts, valid, normals)
    idx, dist = knn_ops.knn_k(pts, pts, k + 1, ref_valid=valid)
    idx, dist = idx[:, 1:].long(), dist[:, 1:]          # drop self
    nbr_ok = (valid[idx] & valid[:, None] & (dist <= _f32(radius))
              & (dist > 1e-9))
    w = nbr_ok.to(_F32)

    alpha, phi, theta = fpfh_angles(pts, normals, idx, dist)
    spfh = torch.cat([_hist11(alpha, -1.0, 1.0, w),
                      _hist11(phi, -1.0, 1.0, w),
                      _hist11(theta, -torch.pi, torch.pi, w)], dim=1)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    spfh = spfh * (100.0 / cnt)[:, None]

    spfh64 = spfh.to(_F64)
    inv_d = torch.where(nbr_ok, 1.0 / torch.clamp(dist.to(_F64), min=1e-9),
                        0.0)
    acc = torch.zeros_like(spfh64)
    for j in range(idx.shape[1]):
        acc = acc + inv_d[:, j, None] * spfh64[idx[:, j]]
    fpfh = (spfh64 + acc / cnt.to(_F64)[:, None]).to(_F32)
    return torch.where(valid[:, None], fpfh, 0.0)


def feature_match(src_feat: torch.Tensor, tgt_feat: torch.Tensor,
                  tgt_valid: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Nearest valid target in feature space of every source point, (Ns,)
    int64; the first index wins a tie."""
    sf = src_feat.to(_F64)
    tf = tgt_feat.to(_F64)
    tt = torch.sum(tf * tf, dim=1)
    out = []
    for c0 in range(0, sf.shape[0], chunk):
        block = sf[c0:c0 + chunk]
        d2 = (torch.sum(block * block, dim=1, keepdim=True) + tt[None, :]
              - 2.0 * (block @ tf.T))
        d2 = torch.where(tgt_valid[None, :], d2, torch.inf)
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out)


def draw_samples(corr_ok: torch.Tensor, num_hypotheses: int, ransac_n: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(H, ransac_n) int64 correspondence indices on the CPU, uniform over
    the valid correspondences (over all of them if none is valid), with
    replacement."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    ok = corr_ok.cpu()
    cand = torch.nonzero(ok).reshape(-1)
    if cand.numel() == 0:
        cand = torch.arange(ok.shape[0])
    pick = torch.randint(cand.numel(), (num_hypotheses, ransac_n),
                         generator=generator)
    return cand[pick]


def _kabsch_batch(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Unweighted rigid alignment of each hypothesis' points s -> t, (H, n, 3)
    each: (H, 4, 4) f32 transforms on their device, computed on the host in
    f64 (`pointcloud.kabsch_np`: a degenerate sample has no unique
    rotation, and LAPACK and cuSOLVER would pick different ones)."""
    s_np, t_np = s.cpu().numpy(), t.cpu().numpy()
    tf = pc.kabsch_np(s_np, t_np, np.ones(s_np.shape[:2]))
    return torch.from_numpy(tf).to(device=s.device, dtype=_F32)


def _apply(tfs: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Each f32 transform (H, 4, 4) applied to the points (N, 3) or per
    hypothesis (H, N, 3), in f64 and fixed order: (H, N, 3)."""
    r = tfs[:, :3, :3].to(_F64)
    t = tfs[:, :3, 3].to(_F64)
    x = pts.to(_F64)
    if x.dim() == 2:
        x = x[None]
    return torch.stack([
        r[:, None, i, 0] * x[..., 0] + r[:, None, i, 1] * x[..., 1]
        + r[:, None, i, 2] * x[..., 2] + t[:, None, i] for i in range(3)],
        dim=-1)


def _distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sqrt(_dot3(d, d))


def ransac_feature_registration(source: torch.Tensor,
                                source_valid: torch.Tensor,
                                target: torch.Tensor,
                                target_valid: torch.Tensor,
                                src_feat: torch.Tensor, tgt_feat: torch.Tensor,
                                distance_threshold: float,
                                generator: Optional[torch.Generator] = None,
                                num_hypotheses: int = 2048,
                                ransac_n: int = 4,
                                edge_similarity: float = 0.9,
                                samples: Optional[torch.Tensor] = None
                                ) -> GlobalRegResult:
    """Parallel RANSAC over the feature-matched correspondences: the
    edge-length and distance checks, a point-to-point `ransac_n`-sample
    model, the inlier share of the correspondence set as fitness."""
    dev = source.device
    src = source.to(_F32)
    tgt = target.to(_F32)
    thr = _f32(distance_threshold)
    corr_idx = feature_match(src_feat, tgt_feat, target_valid)
    corr_tgt = tgt[corr_idx]
    corr_ok = source_valid & target_valid[corr_idx]
    n_corr = torch.clamp(torch.sum(corr_ok.to(_F32)), min=1.0)

    if samples is None:
        samples = draw_samples(corr_ok, num_hypotheses, ransac_n, generator)
    samples = samples.to(device=dev, dtype=torch.int64)
    s, t = src[samples], corr_tgt[samples]                 # (H, n, 3)

    es = _distances(s[:, :, None].to(_F64), s[:, None].to(_F64))
    et = _distances(t[:, :, None].to(_F64), t[:, None].to(_F64))
    eye = torch.eye(s.shape[1], dtype=torch.bool, device=dev)
    ok_edges = torch.all(((et > edge_similarity * es)
                          & (es > edge_similarity * et)) | eye, dim=2).all(1)
    tfs = _kabsch_batch(s, t)
    ok_dist = torch.all(_distances(_apply(tfs, s), t.to(_F64)) <= thr, dim=1)
    ok = ok_edges & ok_dist

    # every hypothesis against the whole correspondence set
    n_inl, sq = [], []
    for h0 in range(0, tfs.shape[0], _SCORE_CHUNK):
        d = _distances(_apply(tfs[h0:h0 + _SCORE_CHUNK], src),
                       corr_tgt.to(_F64)[None])
        inlier = corr_ok[None, :] & (d <= thr)
        n_inl.append(torch.sum(inlier, dim=1))
        sq.append(torch.sum(torch.where(inlier, d * d, 0.0), dim=1))
    n_inl, sq = torch.cat(n_inl), torch.cat(sq)
    rmse = torch.sqrt(sq / torch.clamp(n_inl.to(_F64), min=1e-9)).to(_F32)
    score = torch.where(ok, n_inl, -1)
    best = torch.argmax(score)                             # the first best
    any_ok = torch.any(ok)
    tf_best = torch.where(any_ok, tfs[best],
                          torch.eye(4, dtype=_F32, device=dev))
    return GlobalRegResult(tf_best, n_inl[best].to(_F32) / n_corr,
                           rmse[best], any_ok)


def global_registration(source: torch.Tensor, source_valid: torch.Tensor,
                        target: torch.Tensor, target_valid: torch.Tensor,
                        voxel_size: float,
                        generator: Optional[torch.Generator] = None,
                        num_hypotheses: int = 2048,
                        samples: Optional[torch.Tensor] = None
                        ) -> GlobalRegResult:
    """FPFH at 5 voxels and RANSAC at 1.5 voxels over already
    voxel-downsampled clouds, as the reference parameterizes them; the
    transformation maps the source into the target frame."""
    voxel = _f32(voxel_size)
    src_n = pc.estimate_normals(source, source_valid)
    tgt_n = pc.estimate_normals(target, target_valid)
    src_f = compute_fpfh(source, source_valid, _f32(5.0 * voxel),
                         normals=src_n)
    tgt_f = compute_fpfh(target, target_valid, _f32(5.0 * voxel),
                         normals=tgt_n)
    return ransac_feature_registration(
        source, source_valid, target, target_valid, src_f, tgt_f,
        _f32(1.5 * voxel), generator, num_hypotheses=num_hypotheses,
        samples=samples)
