"""Camera projection and masked point selection (port of the serving and
dataset parts of `autoposeestimation_tpu/ops/projection.py`). Masks and
windows carry any leading batch dimensions S (one window per class in the
serving path); intrinsics are a (4,) tensor (fx, fy, ppx, ppy).
`zoom_window_bbox_np` is the dataset's numpy twin of `zoom_window_bbox`."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

BORDER_STEP = 40
BORDER_MAX = 680


def pixels_to_points(rows, cols, depth_vals, intr) -> torch.Tensor:
    """x = (col - ppx) * z / fx, y = (row - ppy) * z / fy, z = depth."""
    fx, fy, ppx, ppy = intr[0], intr[1], intr[2], intr[3]
    z = depth_vals
    x = (cols.to(z.dtype) - ppx) * z / fx
    y = (rows.to(z.dtype) - ppy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def points_to_pixels(points: torch.Tensor, intr) -> torch.Tensor:
    """Camera-frame points (..., 3) -> integer (row, col) pixels (..., 2),
    int32: floor(x / (z / fx) + ppx + 1e-3) in f32, the reference's int()
    truncation made robust to f32 rounding just below a pixel centre."""
    points = torch.as_tensor(points, dtype=torch.float32)
    intr = torch.as_tensor(intr, dtype=torch.float32, device=points.device)
    fx, fy, ppx, ppy = intr[0], intr[1], intr[2], intr[3]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    col = torch.floor(x / (z / fx) + ppx + 1e-3).to(torch.int32)
    row = torch.floor(y / (z / fy) + ppy + 1e-3).to(torch.int32)
    return torch.stack([row, col], dim=-1)


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


def zoom_window_bbox_np(mask: np.ndarray, crop: int, img_h: int,
                        img_w: int) -> Tuple[int, int, int]:
    """`zoom_window_bbox` of one (H, W) mask in numpy with the same integer
    math, for the dataset: training and serving crops are the same
    function of the mask."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        rmin, rmax, cmin, cmax = 0, 1, 0, 1
    else:
        rw = np.where(rows)[0]
        cw = np.where(cols)[0]
        rmin, rmax = int(rw[0]), int(rw[-1]) + 1
        cmin, cmax = int(cw[0]), int(cw[-1]) + 1

    def quant(e):
        return min(-(-e // BORDER_STEP) * BORDER_STEP, BORDER_MAX)

    r_b, c_b = quant(rmax - rmin), quant(cmax - cmin)
    rc, cc = (rmin + rmax) // 2, (cmin + cmax) // 2
    rmin, rmax = rc - r_b // 2, rc + r_b // 2
    cmin, cmax = cc - c_b // 2, cc + c_b // 2
    rshift = max(-rmin, 0) - max(rmax - img_h, 0)
    cshift = max(-cmin, 0) - max(cmax - img_w, 0)
    rmin, rmax = rmin + rshift, rmax + rshift
    cmin, cmax = cmin + cshift, cmax + cshift

    ext = max(rmax - rmin, cmax - cmin)
    win = int(np.clip(ext, crop, min(img_h, img_w)))
    rc2, cc2 = (rmin + rmax) // 2, (cmin + cmax) // 2
    r0 = int(np.clip(rc2 - win // 2, 0, img_h - win))
    c0 = int(np.clip(cc2 - win // 2, 0, img_w - win))
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
