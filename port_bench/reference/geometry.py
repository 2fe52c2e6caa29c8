"""Connected components, the zoom-window crop and the masked point
selection of the frame graph, and the quaternion algebra of the pose stage:
a frozen copy in plain PyTorch. Components by min-label propagation with a
fixed number of sweeps over an OR-pooled mask, the best one by its
probability mass; windows quantized to 40 pixels; one stratified draw per
chosen point."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) (..., 4) -> (..., 3, 3), normalized with a 1e-3
    floor."""
    q = quat_normalize(q, eps=1e-3)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                     2.0 * (w * y + x * z)], dim=-1),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - w * x)], dim=-1),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (w * x + y * z),
                     1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def compose_quat_poses(q1, t1, q2, t2):
    """pose1 @ pose2."""
    t = torch.einsum("...ij,...j->...i", quat_to_mat(q1), t2) + t1
    return quat_normalize(quat_multiply(q1, q2)), t


def _segmented_cummin(values: torch.Tensor, boundary: torch.Tensor,
                      big: int, dim: int, reverse: bool) -> torch.Tensor:
    """Running min along `dim` that restarts at every boundary element;
    `values` < `big`."""
    if reverse:
        values, boundary = values.flip(dim), boundary.flip(dim)
    offset = (values.shape[dim] + 1
              - torch.cumsum(boundary.to(torch.int64), dim)) * big
    out = torch.cummin(offset + values, dim).values - offset
    return out.flip(dim) if reverse else out


def _window_min(lbl: torch.Tensor, kernel) -> torch.Tensor:
    """Min over a stride-1 'SAME' window; the padding never wins. Labels
    are below 2^24, exact in f32."""
    pad = (kernel[0] // 2, kernel[1] // 2)
    x = -lbl.to(torch.float32).reshape((-1, 1) + lbl.shape[-2:])
    y = -F.max_pool2d(x, kernel, 1, pad)
    return y.reshape(lbl.shape).to(torch.int64)


def connected_components(mask: torch.Tensor, connectivity: int = 8,
                         max_iters: int = 64, fixed_sweeps: int = 0,
                         with_flag: bool = False):
    """int64 labels (..., H, W): masked pixels carry the min flat index of
    their component, background pixels H*W.

    `fixed_sweeps` > 0 runs that many sweeps (bounds the number of turns in
    a component's geometry it can follow); 0 sweeps to convergence, at most
    `max_iters`. `with_flag` also returns a bool `converged` (per mask with
    fixed sweeps: no masked pixel has a smaller label in its
    neighbourhood)."""
    h, w = mask.shape[-2:]
    big = h * w
    if big >= 1 << 24:
        raise ValueError(f"mask of {big} pixels exceeds the f32-exact range")
    flat_idx = torch.arange(big, device=mask.device).reshape(h, w)
    init = torch.where(mask, flat_idx, big)
    boundary = ~mask
    kernels = [(3, 3)] if connectivity == 8 else [(3, 1), (1, 3)]

    def neighborhood_min(lbl):
        nmin = _window_min(lbl, kernels[0])
        for k in kernels[1:]:
            nmin = torch.minimum(nmin, _window_min(lbl, k))
        return torch.where(mask, nmin, big)

    def sweep(lbl):
        lbl = neighborhood_min(lbl)
        for dim, reverse in ((-1, False), (-1, True), (-2, False),
                             (-2, True)):
            lbl = torch.where(
                mask, _segmented_cummin(lbl, boundary, big + 1, dim, reverse),
                big)
        return lbl

    lbl = init
    if fixed_sweeps:
        for _ in range(fixed_sweeps):
            lbl = sweep(lbl)
        if with_flag:
            stale = mask & (neighborhood_min(lbl) < lbl)
            return lbl, ~stale.flatten(-2).any(-1)
        return lbl

    changed = True
    for _ in range(max_iters):
        new = sweep(lbl)
        changed = bool((new != lbl).any())
        lbl = new
        if not changed:
            break
    if with_flag:
        return lbl, torch.tensor(not changed, device=mask.device)
    return lbl


def component_stats(labels: torch.Tensor, mask: torch.Tensor,
                    score: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """Per-root-label (counts, score sums), each (..., H*W + 1) indexed by
    root flat index; background falls into the last slot. `weights`
    replaces the per-pixel count of 1 (pooled CCA: per-cell pixel counts,
    with `score` already the per-cell sum)."""
    h, w = labels.shape[-2:]
    n = h * w
    lead = labels.shape[:-2]
    nb = math.prod(lead)
    seg = torch.where(mask, labels, n).reshape(nb, n)
    seg = (seg + torch.arange(nb, device=seg.device)[:, None] * (n + 1))
    valid = mask.reshape(nb, n).to(torch.float32)
    ones = valid if weights is None else (
        weights.reshape(nb, n).to(torch.float32) * valid)
    vals = score.reshape(nb, n).to(torch.float32) * valid
    counts = torch.zeros(nb * (n + 1), device=seg.device).index_add_(
        0, seg.reshape(-1), ones.reshape(-1))
    sums = torch.zeros(nb * (n + 1), device=seg.device).index_add_(
        0, seg.reshape(-1), vals.reshape(-1))
    return counts.reshape(lead + (n + 1,)), sums.reshape(lead + (n + 1,))


def _select_component(labels, mask, counts, sums, min_size: float, rule: str):
    eligible = counts > min_size
    if rule == "mean":
        values = torch.floor(sums / torch.clamp(counts, min=1.0))
    elif rule == "mean_float":
        values = sums / torch.clamp(counts, min=1.0)
    elif rule == "area":
        values = counts
    elif rule == "sum":
        values = sums
    else:
        raise ValueError(f"unknown rule {rule!r}")
    values = torch.where(eligible, values, -math.inf)
    best = torch.argmax(values, dim=-1)  # first max == lowest root label
    found = eligible.any(-1) & (values.amax(-1) > 0)
    comp = mask & (labels == best[..., None, None]) & found[..., None, None]
    return comp, found


def best_component_mask(mask: torch.Tensor, score: torch.Tensor,
                        min_size: float = 0.0, rule: str = "mean",
                        connectivity: int = 8, max_iters: int = 64,
                        scale: int = 1, fixed_sweeps: int = 0,
                        with_flag: bool = False):
    """The best connected component of `mask` by `rule` over `score`:
    'mean' (floored mean score), 'mean_float', 'area' or 'sum', among
    components larger than `min_size`. Returns (component mask, found[,
    converged]); `found` False gives an empty mask.

    `scale` > 1 labels a `scale`-x OR-pooled mask and selects on per-cell
    pixel counts and score sums (the full-resolution statistics), then
    intersects the upsampled winner with the mask; components closer than
    `scale` pixels may merge."""
    if scale <= 1:
        cc = connected_components(mask, connectivity, max_iters,
                                  fixed_sweeps, with_flag)
        labels, converged = cc if with_flag else (cc, None)
        counts, sums = component_stats(labels, mask, score)
        comp, found = _select_component(labels, mask, counts, sums, min_size,
                                        rule)
        return (comp, found, converged) if with_flag else (comp, found)

    h, w = mask.shape[-2:]
    ph, pw = (-h) % scale, (-w) % scale
    m = F.pad(mask.to(torch.float32), (0, pw, 0, ph))
    s = F.pad(torch.where(mask, score, 0.0).to(torch.float32),
              (0, pw, 0, ph))
    cells = m.shape[:-2] + ((h + ph) // scale, scale, (w + pw) // scale,
                            scale)
    cell_cnt = m.reshape(cells).sum((-3, -1))
    cell_sum = s.reshape(cells).sum((-3, -1))
    small_mask = cell_cnt > 0
    cc = connected_components(small_mask, connectivity, max_iters,
                              fixed_sweeps, with_flag)
    labels, converged = cc if with_flag else (cc, None)
    counts, sums = component_stats(labels, small_mask, cell_sum,
                                   weights=cell_cnt)
    comp_small, found = _select_component(labels, small_mask, counts, sums,
                                          min_size, rule)
    comp = comp_small.repeat_interleave(scale, -2).repeat_interleave(
        scale, -1)[..., :h, :w] & mask
    return (comp, found, converged) if with_flag else (comp, found)


BORDER_STEP = 40
BORDER_MAX = 680


def pixels_to_points(rows, cols, depth_vals, intr) -> torch.Tensor:
    """x = (col - ppx) * z / fx, y = (row - ppy) * z / fy, z = depth."""
    fx, fy, ppx, ppy = intr[0], intr[1], intr[2], intr[3]
    z = depth_vals
    x = (cols.to(z.dtype) - ppx) * z / fx
    y = (rows.to(z.dtype) - ppy) * z / fy
    return torch.stack([x, y, z], dim=-1)



def quantize_extent(extent: torch.Tensor) -> torch.Tensor:
    """Grow to the next multiple of 40 (unless already one), at most 680."""
    q = torch.div(extent + BORDER_STEP - 1, BORDER_STEP,
                  rounding_mode="floor") * BORDER_STEP
    return torch.clamp(q, max=BORDER_MAX)


def get_bbox(mask: torch.Tensor, img_h: int, img_w: int):
    """Quantized bbox (rmin, rmax, cmin, cmax) of masks (S, H, W): tight
    bbox, +1 on max, extent quantized, recentred, shifted inside the image.
    An empty mask gives the minimal bbox at the origin."""
    h, w = mask.shape[-2:]
    rows_any = mask.any(-1)
    cols_any = mask.any(-2)
    ridx = torch.arange(h, device=mask.device)
    cidx = torch.arange(w, device=mask.device)
    big = 10 ** 9
    rmin = torch.where(rows_any, ridx, big).amin(-1)
    rmax = torch.where(rows_any, ridx, -1).amax(-1) + 1
    cmin = torch.where(cols_any, cidx, big).amin(-1)
    cmax = torch.where(cols_any, cidx, -1).amax(-1) + 1
    empty = ~rows_any.any(-1)
    rmin = torch.where(empty, 0, rmin)
    rmax = torch.where(empty, 1, rmax)
    cmin = torch.where(empty, 0, cmin)
    cmax = torch.where(empty, 1, cmax)

    r_b = quantize_extent(rmax - rmin)
    c_b = quantize_extent(cmax - cmin)
    rc = torch.div(rmin + rmax, 2, rounding_mode="floor")
    cc = torch.div(cmin + cmax, 2, rounding_mode="floor")
    rmin, rmax = rc - r_b // 2, rc + r_b // 2
    cmin, cmax = cc - c_b // 2, cc + c_b // 2
    rshift = torch.clamp(-rmin, min=0) - torch.clamp(rmax - img_h, min=0)
    cshift = torch.clamp(-cmin, min=0) - torch.clamp(cmax - img_w, min=0)
    return rmin + rshift, rmax + rshift, cmin + cshift, cmax + cshift


def zoom_window_bbox(mask: torch.Tensor, crop: int, img_h: int, img_w: int):
    """(r0, c0, win): square window of side `win` >= crop covering the
    quantized bbox, clamped inside the image."""
    rmin, rmax, cmin, cmax = get_bbox(mask, img_h, img_w)
    ext = torch.maximum(rmax - rmin, cmax - cmin)
    win = torch.clamp(ext, crop, min(img_h, img_w))
    rc = torch.div(rmin + rmax, 2, rounding_mode="floor")
    cc = torch.div(cmin + cmax, 2, rounding_mode="floor")
    r0 = torch.minimum(torch.clamp(rc - win // 2, min=0), img_h - win)
    c0 = torch.minimum(torch.clamp(cc - win // 2, min=0), img_w - win)
    return r0, c0, win



def _lattice(start: torch.Tensor, win: torch.Tensor, crop: int):
    """Native pixel of each of the `crop` cells of a `win`-wide window."""
    ar = torch.arange(crop, device=start.device)
    return start[..., None] + torch.div(ar * win[..., None], crop,
                                        rounding_mode="floor")


def resample_window(img: torch.Tensor, r0, c0, win, crop: int,
                    frame: Optional[torch.Tensor] = None):
    """Nearest-neighbour gather of (C, H, W) windows onto static (crop, crop)
    grids: windows S -> (S..., C, crop, crop). `win == crop` is an exact
    slice. With `frame` (S,), `img` holds frames (F, C, H, W) and window s
    reads frame `frame[s]` (one gather for all of them)."""
    ii = _lattice(r0, win, crop)
    jj = _lattice(c0, win, crop)
    if frame is not None:
        chans = torch.arange(img.shape[1], device=img.device)
        return img[frame[:, None, None, None], chans[None, :, None, None],
                   ii[:, None, :, None], jj[:, None, None, :]]
    rows = img[:, ii]                                    # (C, S.., crop, W)
    cols = jj[None, ..., None, :].expand(rows.shape[:-1] + (crop,))
    return torch.gather(rows, -1, cols).movedim(0, -3)


def choose_masked_indices(window_mask: torch.Tensor, num_pt: int,
                          uniforms: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`num_pt` flat indices of True pixels of windows (S, Hs, Ws), and the
    valid count per window.

    Above `num_pt` valid pixels: one rank per stratum
    [j*count/num_pt, (j+1)*count/num_pt), picked by `uniforms` (S, num_pt)
    in [0, 1) (distinct, ascending). Otherwise the valid pixels in raster
    order, cycled. Ranks map to indices by binary search over the inclusive
    cumsum; an empty window gives indices 0 and count 0."""
    flat = window_mask.flatten(-2)
    n = flat.shape[-1]
    csum = torch.cumsum(flat.to(torch.int64), -1)
    count = csum[..., -1]
    cnt = count[..., None]
    j = torch.arange(num_pt, device=flat.device)
    lo = torch.div(j * cnt, num_pt, rounding_mode="floor")
    hi = torch.div((j + 1) * cnt, num_pt, rounding_mode="floor")
    r_strat = lo + (uniforms.to(torch.float32)
                    * (hi - lo).to(torch.float32)).to(torch.int64)
    r_wrap = j % torch.clamp(cnt, min=1)
    ranks = torch.where(cnt > num_pt, r_strat, r_wrap)
    idx = torch.searchsorted(csum, ranks + 1, right=False)
    idx = torch.clamp(idx, max=n - 1)
    return torch.where(cnt > 0, idx, 0), count


def backproject_choose_zoom(depth: torch.Tensor, mask: torch.Tensor, intr,
                            depth_scale, r0, c0, win, crop: int, num_pt: int,
                            uniforms: torch.Tensor,
                            frame: Optional[torch.Tensor] = None):
    """Crop -> choose -> backproject for the zoom windows of masks
    (S, H, W) over one depth image (H, W), or, with `frame` (S,), over
    depth frames (F, H, W) of which mask s belongs to frame `frame[s]`.

    Pixels are chosen on the (crop, crop) lattice of each window (one native
    pixel per cell), so `choose` addresses the resampled colour crop and the
    cloud backprojects native coordinates. Returns (cloud (S, num_pt, 3),
    choose (S, num_pt), count (S,)); `count` is the number of valid native
    mask pixels inside the window, 0 when the lattice holds none."""
    if frame is not None:
        depth = depth[frame]
    h, w = depth.shape[-2:]
    depth = depth.to(torch.float32)
    masked_depth = torch.where(mask & (depth > 0), depth, 0.0)
    rows_i = torch.arange(h, device=depth.device)[:, None]
    cols_i = torch.arange(w, device=depth.device)[None, :]
    e = (...,) + (None, None)
    inside = ((rows_i >= r0[e]) & (rows_i < (r0 + win)[e])
              & (cols_i >= c0[e]) & (cols_i < (c0 + win)[e]))
    count = (inside & (masked_depth > 0)).sum((-2, -1))

    ii = _lattice(r0, win, crop)                          # (S, crop)
    jj = _lattice(c0, win, crop)
    wdepth = torch.gather(masked_depth, -2,
                          ii[..., None].expand(ii.shape + (w,)))
    wdepth = torch.gather(wdepth, -1,
                          jj[..., None, :].expand(ii.shape + (crop,)))
    choose, lat_count = choose_masked_indices(wdepth > 0, num_pt, uniforms)

    rows = torch.gather(ii, -1, torch.div(choose, crop, rounding_mode="floor"))
    cols = torch.gather(jj, -1, choose % crop)
    scale = torch.as_tensor(depth_scale, dtype=torch.float32,
                            device=depth.device)
    z = torch.gather(wdepth.flatten(-2), -1, choose) * scale
    cloud = pixels_to_points(rows, cols, z, intr)
    return cloud, choose, torch.where(lat_count > 0, count, 0)
