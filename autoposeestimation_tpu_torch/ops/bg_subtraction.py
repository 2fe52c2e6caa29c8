"""Classical RGB-D background subtraction and the learned model's input
(port of `autoposeestimation_tpu/ops/bg_subtraction.py`).

`create_label_rgbd(bg_rgb, fg_rgb, bg_depth, fg_depth, measure_dist)`
scores every pixel by weighted absolute colour differences (HSV, HSV and
RGB, or RGB; hue rescaled by 256/180, each channel clipped at 100) and a
weighted depth difference against a table-plane fill of the background's
centre, thresholds, opens and closes the score, keeps the best-mean
component above `min_size`, optionally drops the pixels below mean - std,
opens and closes again and keeps the largest component. The final mask
keeps the pre-morphology pixels inside the winning component, as the
reference's numpy aliasing does. As in the JAX package, any nonzero score
is foreground: the reference's uint8 wrap before its connected components
(scores that are multiples of 256 become background) is not reproduced.

`build_bs_input` is the 7-channel input of the learned background
subtraction U-Net: |dRGB|, |dHSV| (Pillow's HSV in float form), |ddepth|,
floored and wrapped mod 256 as the reference's uint8 cast does, /255,
normalized with the fixed BS_MEAN / BS_STD. HWC f32.

Every op runs on the inputs' device; the only host reads are the
connected components' convergence checks (`ops/cca.py`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import cca as cca_ops
from . import morphology as morph

# default channel weights of the three colour modes
P_HSV = (0.08026211175912534, 1.2577782150904344, 1.9483549172969372,
         1.392821046939864)
P_BOTH = (0.8, 0.6, 0.1, 0.3, 0.3, 0.5, 0.5)
P_RGB = (0.5, 0.5, 0.5, 1.0)

# the learned 7-channel model's fixed normalization
BS_MEAN = (0.040278014, 0.04060352, 0.038310923, 0.0381776, 0.03656849,
           0.03636289, 0.03556486)
BS_STD = (0.059689723, 0.05965291, 0.056203008, 0.05619316, 0.054657422,
          0.054514673, 0.05377024)

_F32 = torch.float32


def rgb_to_hsv_cv2(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2HSV of uint8-range f32 input in float form: H in
    [0, 180), S and V in [0, 255], H and S rounded half to even."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    safe = torch.clamp(diff, min=1e-9)
    h = torch.where(
        v == r, 30.0 * (g - b) / safe,
        torch.where(v == g, 60.0 + 30.0 * (b - r) / safe,
                    120.0 + 30.0 * (r - g) / safe))
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 180.0, h)
    s = torch.where(v == 0, 0.0, diff * 255.0 / torch.clamp(v, min=1e-9))
    return torch.stack([torch.round(h), torch.round(s), v], dim=-1)


def rgb_to_hsv_pil(rgb: torch.Tensor) -> torch.Tensor:
    """Pillow's convert('HSV') in float form (colorsys' hue, floored): H, S,
    V in [0, 255]. The learned model's dataset (`data/bs_dataset.py`)
    uses Pillow's exact integer conversion instead, as the JAX package
    does."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    diff = maxc - minc
    safe = torch.clamp(diff, min=1e-9)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)       # floor modulo, as Python's %
    h = torch.where(diff == 0, 0.0, h)
    s = torch.where(maxc == 0, 0.0, diff / torch.clamp(maxc, min=1e-9))
    return torch.stack([torch.floor(h * 255.0), torch.floor(s * 255.0),
                        maxc], dim=-1)


def _kth_true_flat_index(mask_flat: torch.Tensor, k) -> torch.Tensor:
    """Flat index of the (k+1)-th True element in raster order (0 if there
    is none)."""
    c = torch.cumsum(mask_flat.to(torch.int32), 0)
    return torch.argmax(((c == k + 1) & mask_flat).to(torch.int32))


def _plane_fill(bg_depth: torch.Tensor, h_p: float = 0.3,
                w_p: float = 0.3) -> torch.Tensor:
    """Fill the background depth's centre crop from a plane through three
    extreme valid points (the reference's table-plane fill), then box-smooth
    it; a crop with no valid pixel is left as it is."""
    h, w = bg_depth.shape
    r0, r1 = int(h / 2 - h * h_p), int(h / 2 + h * h_p)
    c0, c1 = int(w / 2 - w * w_p), int(w / 2 + w * w_p)
    center = bg_depth[r0:r1, c0:c1]
    ch, cw = center.shape
    dev = bg_depth.device
    valid = center != 0
    rows = torch.arange(ch, device=dev, dtype=_F32)[:, None].expand(ch, cw)
    cols = torch.arange(cw, device=dev, dtype=_F32)[None, :].expand(ch, cw)

    vflat = valid.reshape(-1)
    rflat = rows.reshape(-1)
    cflat = cols.reshape(-1)
    dflat = center.reshape(-1)

    any_valid = torch.any(vflat)
    rmax = torch.max(torch.where(vflat, rflat, -1.0))
    rmin = torch.min(torch.where(vflat, rflat, 1e9))
    cmax = torch.max(torch.where(vflat, cflat, -1.0))
    lowest = vflat & (rflat == rmax)
    uppest = vflat & (rflat == rmin)
    rightest = vflat & (cflat == cmax)
    n_low = torch.sum(lowest.to(torch.int32))
    n_up = torch.sum(uppest.to(torch.int32))
    n_right = torch.sum(rightest.to(torch.int32))

    up_idx = _kth_true_flat_index(uppest, n_up // 2)
    # more than 100 pixels on the lowest row: its first and last pixel, else
    # its middle pixel and the middle one of the rightmost column (both
    # branches computed, one selected: no host read)
    many = n_low > 100
    ia = torch.where(many, _kth_true_flat_index(lowest, 0),
                     _kth_true_flat_index(lowest, n_low // 2))
    ic = torch.where(many, _kth_true_flat_index(lowest, n_low - 1),
                     _kth_true_flat_index(rightest, n_right // 2))

    def pt(i):
        return torch.stack([rflat[i], cflat[i], dflat[i]])

    p1, p2, p3 = pt(ia), pt(up_idx), pt(ic)
    cp = torch.linalg.cross(p3 - p1, p2 - p1)
    d = cp[0] * p3[0] + cp[1] * p3[1] + cp[2] * p3[2]
    a, b, c = cp[0], cp[1], cp[2]
    z = (d - a * rows - b * cols) / torch.where(torch.abs(c) > 1e-9, c, 1e-9)
    dist_plane = torch.sqrt(rows ** 2 + cols ** 2 + z ** 2)
    dist_plane = torch.where(valid, center, dist_plane)
    dist_plane = morph.box_smooth(dist_plane, 5)
    new_center = torch.where(any_valid, dist_plane, center)
    out = bg_depth.clone()
    out[r0:r1, c0:c1] = new_center
    return out


def _opened_closed(x: torch.Tensor, open_k: int, close_k: int
                   ) -> torch.Tensor:
    if open_k > 0:
        x = morph.opening(x, open_k)
    if close_k > 0:
        x = morph.closing(x, close_k)
    return x


def _weighted_sum(x: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """sum_c x[..., c] * w_c, added in channel order (the same bits on
    every device)."""
    out = x[..., 0] * weights[0]
    for c in range(1, x.shape[-1]):
        out = out + x[..., c] * weights[c]
    return out


def _masked_depths(bg_depth: torch.Tensor, fg_depth: torch.Tensor,
                   measure_dist: float, plane_fill: bool):
    """Both depths cleared beyond measure_dist +- 150 mm (f32 bounds), the
    background's centre optionally plane-filled, then each cleared where
    the other has no measurement."""
    md = torch.tensor(measure_dist, dtype=_F32)
    lo, hi = float(md - 150.0), float(md + 150.0)
    fg_depth = torch.where((fg_depth > hi) | (fg_depth < lo), 0.0, fg_depth)
    bg_depth = torch.where((bg_depth > hi) | (bg_depth < lo), 0.0, bg_depth)
    if plane_fill:
        bg_depth = _plane_fill(bg_depth)
    fg_depth = torch.where(bg_depth == 0, 0.0, fg_depth)
    bg_depth = torch.where(fg_depth == 0, 0.0, bg_depth)
    return bg_depth, fg_depth


def label_scores(bg_rgb: torch.Tensor, fg_rgb: torch.Tensor,
                 bg_depth: torch.Tensor, fg_depth: torch.Tensor,
                 measure_dist: float, p: Sequence[float], hsv: bool,
                 both: bool):
    """(colour score, colour + depth score), f32 (H, W): the per-pixel
    scores `create_label_rgbd` thresholds."""
    bg_rgb = bg_rgb.to(_F32)
    fg_rgb = fg_rgb.to(_F32)
    if hsv:
        bg, fg = rgb_to_hsv_cv2(bg_rgb), rgb_to_hsv_cv2(fg_rgb)
    elif both:
        bg = torch.cat([rgb_to_hsv_cv2(bg_rgb), bg_rgb], dim=2)
        fg = torch.cat([rgb_to_hsv_cv2(fg_rgb), fg_rgb], dim=2)
    else:
        bg, fg = bg_rgb, fg_rgb
    diff = torch.abs(fg - bg)
    if hsv or both:
        diff = torch.cat([diff[:, :, :1] * (256.0 / 180.0), diff[:, :, 1:]],
                         dim=2)
    diff = torch.clamp(diff, max=100.0)
    score_color = _weighted_sum(diff, p[: diff.shape[2]])
    if p[-1] <= 0:
        return score_color, score_color
    bg_d, fg_d = _masked_depths(bg_depth.to(_F32), fg_depth.to(_F32),
                                measure_dist, plane_fill=True)
    depth_mask = torch.clamp(torch.abs(fg_d - bg_d), max=100.0)
    return score_color, score_color + depth_mask * p[-1]


def _opened_closed(x: torch.Tensor, open_k: int, close_k: int
                   ) -> torch.Tensor:
    if open_k > 0:
        x = morph.opening(x, open_k)
    if close_k > 0:
        x = morph.closing(x, close_k)
    return x


def create_label_rgbd(bg_rgb: torch.Tensor, fg_rgb: torch.Tensor,
                      bg_depth: torch.Tensor, fg_depth: torch.Tensor,
                      measure_dist: float,
                      threshold: float = 100.0,
                      p: Optional[Sequence[float]] = None,
                      min_size: int = 100,
                      open_k: int = 3,
                      close_k: int = 9,
                      hsv: bool = True,
                      both: bool = False,
                      do_cca: bool = True,
                      remove_one_std: bool = False) -> torch.Tensor:
    """The classical label of one view. Inputs: uint8-range RGB (H, W, 3) and
    depth (H, W) in mm, any dtype, on one device; `measure_dist` is the
    camera-to-reference distance in mm. Returns a uint8 (H, W) mask of
    {0, 255} on that device."""
    if p is None:
        p = P_HSV if hsv else (P_BOTH if both else P_RGB)
    p = tuple(float(v) for v in p)
    score_color, score = label_scores(bg_rgb, fg_rgb, bg_depth, fg_depth,
                                      measure_dist, p, hsv, both)
    score = torch.where(score < threshold, 0.0, score)
    score = _opened_closed(score, open_k, close_k)
    if not do_cca:
        return (score != 0).to(torch.uint8) * 255

    # the best floored-mean component above min_size; where none is
    # found, the background component (the reference's label-0 fallback)
    comp1, found1 = cca_ops.best_component_mask(
        score > 0, score, min_size=min_size, rule="mean")
    keep1 = torch.where(found1, comp1, ~(score > 0))
    m = torch.where(keep1, score_color, 0.0)

    if remove_one_std:
        # the image-wide sums in f64, rounded to f32: the same cut on every
        # device
        nz = m != 0
        m64 = m.to(torch.float64)
        cnt = torch.clamp(torch.sum(nz.to(torch.float64)), min=1.0)
        mean = (torch.sum(m64) / cnt).to(_F32)
        var = (torch.sum(torch.where(nz, (m - mean).to(torch.float64) ** 2,
                                     0.0)) / cnt).to(_F32)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        m = torch.where(m < mean - std, 0.0, m)

    # the largest component of the re-opened and closed image; the final
    # mask keeps the pre-morphology pixels inside it
    morphed = _opened_closed(m, open_k, close_k)
    comp2, found2 = cca_ops.best_component_mask(
        morphed > 0, morphed, min_size=min_size, rule="area")
    keep2 = torch.where(found2, comp2, ~(morphed > 0))
    final = torch.where(keep2, m, 0.0)
    return (final != 0).to(torch.uint8) * 255


def build_bs_input(bg_rgb: torch.Tensor, fg_rgb: torch.Tensor,
                   bg_depth: torch.Tensor, fg_depth: torch.Tensor,
                   measure_dist: float) -> torch.Tensor:
    """The learned background subtraction model's (H, W, 7) f32 input,
    channels last."""
    bg_rgb = bg_rgb.to(_F32)
    fg_rgb = fg_rgb.to(_F32)
    bg_depth, fg_depth = _masked_depths(bg_depth.to(_F32),
                                        fg_depth.to(_F32), measure_dist,
                                        plane_fill=False)

    x = torch.cat([torch.abs(fg_rgb - bg_rgb),
                   torch.abs(rgb_to_hsv_pil(fg_rgb) - rgb_to_hsv_pil(bg_rgb)),
                   torch.abs(fg_depth - bg_depth)[..., None]], dim=2)
    # the reference's uint8 cast wraps mod 256 (depth differences reach
    # 300); ToTensor then scales by 1/255
    x = torch.remainder(torch.floor(x), 256.0) / 255.0
    stats = torch.tensor((BS_MEAN, BS_STD), dtype=_F32, device=x.device)
    return (x - stats[0]) / stats[1]
