"""Host-side image augmentations of the pose and segmentation datasets in
numpy (port of `autoposeestimation_tpu/data/augment.py`, which calls
Pillow).

Each function gives the arrays that the Pillow call there gives, bit for
bit, so the port's dataset equals the JAX package's from the same seed
without Pillow installed. Images are numpy arrays: colour (H, W, 3) uint8
("RGB"), labels (H, W) uint8 ("L"), depth (H, W) uint16 (Pillow opens a
16-bit PNG as "I;16").

What is reproduced of Pillow (12.x):
  * `Image.blend`, the core of `ImageEnhance`: `in1 + alpha * (in2 - in1)`
    in C float with alpha cast to float, truncated toward zero; outside
    0 <= alpha <= 1 the result is clipped to 0..255 first.
  * `ImageFilter.GaussianBlur(radius)`: three passes of the extended box
    blur of BoxBlur.c in 24-bit fixed point along each axis
    (`gaussian_blur`).
  * `convert("L")`: fixed-point luma (r*19595 + g*38470 + b*7471 +
    0x8000) >> 16.
  * `convert("HSV")` and back: Pillow's own float/double mix, rounding and
    truncation (`rgb_to_hsv`, `hsv_to_rgb`).
  * `Image.crop`, and `Image.resize` with its default BICUBIC (22-bit
    fixed-point separable resampling, a uint8 image between the two
    passes) and with NEAREST, which runs as an affine transform: the
    scale-only loop for "L", the generic transform for "I;16", as in
    the rotation below.
  * `Image.rotate(angle)` with NEAREST, no expand, centre (w/2, h/2): the
    matrix rounded to 15 digits, the transpose shortcuts at 0 and 180 (90
    and 270 only for square images), and two resampling paths: "RGB" and
    "L" go through the 16.16 fixed-point affine loop (or the scale-only
    loop when the matrix has no shear terms), "I;16" through the generic
    transform, which samples at pixel centres in double. The two pick
    different source pixels for tens of thousands of pixels of a 640x480
    frame, so depth is rotated by its own path.
"""
from __future__ import annotations

import math
import random
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(im1, im2, alpha)` on uint8 arrays."""
    a = np.float32(alpha)
    lo = np.asarray(im1).astype(np.float32)
    temp = lo + a * (np.asarray(im2).astype(np.float32) - lo)
    if 0.0 <= a <= 1.0:
        return temp.astype(np.uint8)
    return np.where(temp <= 0, 0, np.where(temp >= 255, 255, temp)).astype(
        np.uint8)


def to_luma(rgb: np.ndarray) -> np.ndarray:
    """`convert("L")` of an RGB uint8 array."""
    c = rgb.astype(np.int32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def adjust_brightness(rgb: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Brightness(img).enhance(factor)`."""
    return blend(np.zeros_like(rgb), rgb, factor)


def adjust_contrast(rgb: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Contrast(img).enhance(factor)`: blend with the grey
    `int(mean(L) + 0.5)`, the mean taken as Pillow's `ImageStat` takes it
    (the histogram's float sum over the pixel count)."""
    luma = to_luma(rgb)
    total = float(np.dot(np.bincount(luma.ravel(), minlength=256),
                         np.arange(256)))
    mean = int(total / luma.size + 0.5) if luma.size else 0
    return blend(np.full_like(rgb, mean), rgb, factor)


def adjust_saturation(rgb: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Color(img).enhance(factor)`: blend with
    `convert("L").convert("RGB")`."""
    grey = np.repeat(to_luma(rgb)[..., None], 3, axis=-1)
    return blend(grey, rgb, factor)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """`convert("HSV")` of an RGB uint8 array (Pillow's `rgb2hsv_row`:
    float ratios, hue offsets added in double, truncation to 0..255)."""
    c = rgb.astype(np.int32)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    f32 = np.float32
    cr = np.where(grey, 1, maxc - minc).astype(f32)
    s = (maxc - minc).astype(f32) / np.where(grey, 1, maxc).astype(f32)
    rc = (maxc - r).astype(f32) / cr
    gc = (maxc - g).astype(f32) / cr
    bc = (maxc - b).astype(f32) / cr
    h = np.where(
        r == maxc, (bc - gc).astype(np.float64),
        np.where(g == maxc,
                 (2.0 + rc.astype(np.float64)) - bc.astype(np.float64),
                 (4.0 + gc.astype(np.float64)) - rc.astype(np.float64)))
    h = h.astype(f32)          # assigned to a float in C
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(f32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    out = np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc],
                   axis=-1)
    return out.astype(np.uint8)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C `round` (halves away from zero) of float64."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """`convert("RGB")` of an HSV uint8 array (Pillow's `hsv2rgb`)."""
    c = hsv.astype(np.int32)
    h, s, v = c[..., 0], c[..., 1], c[..., 2]
    f32 = np.float32
    h6 = h.astype(f32).astype(np.float64) * 6.0 / 255.0
    i = np.floor(h6).astype(np.int64)
    f = (h6 - i.astype(f32).astype(np.float64)).astype(f32)
    fs = (s.astype(f32).astype(np.float64) / 255.0).astype(f32)
    vd = v.astype(f32).astype(np.float64)
    fs_d, f_d = fs.astype(np.float64), f.astype(np.float64)
    p = _round_half_away(vd * (1.0 - fs_d))
    q = _round_half_away(vd * (1.0 - (fs * f).astype(np.float64)))
    t = _round_half_away(vd * (1.0 - fs_d * (1.0 - f_d)))
    up, uq, ut = (np.clip(x, 0, 255).astype(np.int32) for x in (p, q, t))
    sector = i % 6
    table = [(v, ut, up), (uq, v, up), (up, v, ut), (up, uq, v),
             (ut, up, v), (v, up, uq)]
    out = np.stack([np.select([sector == k for k in range(6)],
                              [row[ch] for row in table])
                    for ch in range(3)], axis=-1)
    out = np.where((s == 0)[..., None], v[..., None], out)
    return out.astype(np.uint8)


def hue_shift(rgb: np.ndarray, shift: int) -> np.ndarray:
    """The JAX `color_jitter`'s hue op: `convert("HSV")`, hue + shift mod
    256, back to RGB."""
    hsv = rgb_to_hsv(rgb)
    hsv[..., 0] = ((hsv[..., 0].astype(np.int16) + shift) % 256).astype(
        np.uint8)
    return hsv_to_rgb(hsv)


def color_jitter(img: np.ndarray, brightness: float = 0.2,
                 contrast: float = 0.2, saturation: float = 0.2,
                 hue: float = 0.05,
                 rng: Optional[random.Random] = None) -> np.ndarray:
    """torchvision-style ColorJitter on an RGB uint8 array, drawing from
    `rng` in the JAX version's order: the brightness, contrast, saturation
    and hue factors, then a shuffle of the order the ops run in."""
    rng = rng or random
    ops = []
    if brightness:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: adjust_brightness(im, f))
    if contrast:
        f2 = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: adjust_contrast(im, f2))
    if saturation:
        f3 = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: adjust_saturation(im, f3))
    if hue:
        sh = rng.uniform(-hue, hue)
        ops.append(lambda im: hue_shift(im, int(sh * 255)))
    idx = list(range(len(ops)))
    rng.shuffle(idx)
    for i in idx:
        img = ops[i](img)
    return img


# ---------------------------------------------------------------------------
# Gaussian blur
# ---------------------------------------------------------------------------

def _f32(v) -> np.float32:
    return np.float32(v)


def box_blur_radius(sigma: float, passes: int = 3) -> np.float32:
    """Pillow's `_gaussian_blur_radius` (BoxBlur.c): the extended box
    radius whose `passes` box blurs approximate a Gaussian of standard
    deviation `sigma`, in C's float and double steps (Gwosdek et al. 2011,
    eqs. 7, 11, 14)."""
    sigma2 = _f32(_f32(_f32(sigma) * _f32(sigma)) / _f32(passes))
    big_l = _f32(np.sqrt(12.0 * np.float64(sigma2) + 1.0))
    small_l = _f32(np.floor((np.float64(big_l) - 1.0) / 2.0))
    a = _f32(_f32(_f32(2) * small_l) + _f32(1)) * _f32(
        small_l * _f32(small_l + _f32(1)) - _f32(_f32(3) * sigma2))
    a = _f32(a / _f32(_f32(6) * _f32(
        sigma2 - _f32(_f32(small_l + 1) * _f32(small_l + 1)))))
    return _f32(small_l + a)


def _box_blur_pass(img: np.ndarray, radius: np.float32, axis: int
                   ) -> np.ndarray:
    """One pass of Pillow's `ImagingHorizontalBoxBlur` along `axis` of a
    uint8 array: the 2r+1 pixels around x (edges repeated) weigh ww and the
    two beyond them fw, both 24-bit fixed point, and the sum rounds to
    uint8 as (sum + 2^23) >> 24."""
    r = int(radius)
    ww = np.uint64(_f32(_f32(16777216) / _f32(_f32(radius * _f32(2))
                                              + _f32(1))))
    fw = (np.uint64(1 << 24) - np.uint64(2 * r + 1) * ww) // np.uint64(2)
    n = img.shape[axis]
    src = np.take(img, np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1),
                  axis=axis).astype(np.uint64)
    csum = np.cumsum(src, axis=axis)
    zero = np.zeros_like(np.take(csum, [0], axis=axis))
    csum = np.concatenate([zero, csum], axis=axis)
    x = np.arange(n)
    window = (np.take(csum, x + 2 * r + 2, axis=axis)
              - np.take(csum, x + 1, axis=axis))
    far = np.take(src, x, axis=axis) + np.take(src, x + 2 * r + 2, axis=axis)
    bulk = window * ww + far * fw
    return ((bulk + np.uint64(1 << 23)) >> np.uint64(24)).astype(np.uint8)


def gaussian_blur(img: np.ndarray, sigma: float, passes: int = 3
                  ) -> np.ndarray:
    """`img.filter(ImageFilter.GaussianBlur(radius=sigma))` of a uint8
    image (H, W) or (H, W, C): Pillow's extended box blur, `passes`
    horizontal passes, then `passes` vertical passes over their result, each
    rounded to uint8."""
    if sigma == 0:
        return img.copy()
    radius = box_blur_radius(sigma, passes)
    out = img
    for axis in (1, 0):
        if radius != 0:
            for _ in range(passes):
                out = _box_blur_pass(out, radius, axis)
    return out


# ---------------------------------------------------------------------------
# rotation
# ---------------------------------------------------------------------------

def rotation_matrix(angle: float, w: int, h: int) -> List[float]:
    """The inverse affine matrix (a, b, c, d, e, f) `Image.rotate` builds
    for a rotation by `angle` degrees about (w/2, h/2)."""
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    cx, cy = w / 2, h / 2
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return m


def _fix(v: float) -> int:
    """Pillow's 16.16 fixed-point FIX: floor(v * 65536 + 0.5)."""
    return math.floor(v * 65536.0 + 0.5)


def _coord(v: np.ndarray) -> np.ndarray:
    """Pillow's COORD: -1 below zero, else truncation."""
    return np.where(v < 0.0, -1, np.trunc(np.maximum(v, 0.0))).astype(
        np.int64)


def _gather(img: np.ndarray, rows: np.ndarray, cols: np.ndarray
            ) -> np.ndarray:
    """img[rows, cols] where both are in range, zero elsewhere."""
    h, w = img.shape[:2]
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    out = img[np.where(ok, rows, 0), np.where(ok, cols, 0)]
    out[~ok] = 0
    return out


def _affine_fixed(img: np.ndarray, a: List[float]) -> np.ndarray:
    h, w = img.shape[:2]
    a0, a1, a3, a4 = _fix(a[0]), _fix(a[1]), _fix(a[3]), _fix(a[4])
    a2 = _fix(a[2] + a[0] * 0.5 + a[1] * 0.5)
    a5 = _fix(a[5] + a[3] * 0.5 + a[4] * 0.5)
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    xx = a2 + y * a1 + x * a0
    yy = a5 + y * a4 + x * a3
    return _gather(img, yy >> 16, xx >> 16)


def _scale_affine(img: np.ndarray, a: List[float],
                  out_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Pillow's `ImagingScaleAffine` (nearest, no shear) into an image of
    `out_hw` (default: the input's size)."""
    h, w = img.shape[:2]
    oh, ow = out_hw or (h, w)
    xin = np.empty(ow, np.int64)
    xo = a[2] + a[0] * 0.5
    for x in range(ow):              # the C loop's running double sum
        xin[x] = -1 if xo < 0.0 else int(xo)
        xo += a[0]
    valid = np.flatnonzero((xin >= 0) & (xin < w))
    yin = np.empty(oh, np.int64)
    yo = a[5] + a[4] * 0.5
    for y in range(oh):
        yin[y] = -1 if yo < 0.0 else int(yo)
        yo += a[4]
    out = np.zeros((oh, ow) + img.shape[2:], img.dtype)
    if len(valid):
        xmin, xmax = valid[0], valid[-1] + 1
        xtab = np.where((xin >= 0) & (xin < w), xin, 0)[xmin:xmax]
        rows = np.flatnonzero((yin >= 0) & (yin < h))
        out[rows[:, None], np.arange(xmin, xmax)[None, :]] = \
            img[yin[rows][:, None], xtab[None, :]]
    return out


def _generic_affine(img: np.ndarray, a: List[float],
                    out_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Pillow's `ImagingGenericTransform` with the affine map and nearest
    sampling at pixel centres, into an image of `out_hw` (default: the
    input's size)."""
    oh, ow = out_hw or img.shape[:2]
    yc = np.arange(oh, dtype=np.float64)[:, None] + 0.5
    xc = np.arange(ow, dtype=np.float64)[None, :] + 0.5
    xx = a[0] * xc + a[1] * yc + a[2]
    yy = a[3] * xc + a[4] * yc + a[5]
    return _gather(img, _coord(yy), _coord(xx))


def _affine_nearest(img: np.ndarray, a: List[float]) -> np.ndarray:
    """The affine NEAREST transform of Pillow's "RGB" and "L" images."""
    h, w = img.shape[:2]
    if a[1] == 0 and a[3] == 0:
        return _scale_affine(img, a)

    def fits(x, y):
        return (abs(x * a[0] + y * a[1] + a[2]) < 32768.0
                and abs(x * a[3] + y * a[4] + a[5]) < 32768.0)

    if not all(fits(x, y) for x in (0, w) for y in (0, h)):
        raise ValueError(f"image of {w}x{h} is beyond Pillow's fixed-point "
                         "rotation range")
    return _affine_fixed(img, a)


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """`Image.rotate(angle)` (NEAREST, no expand) of the image whose array
    `img` is: uint16 is a 16-bit PNG as Pillow opens it ("I;16", a special
    mode: the generic transform), uint8 an "RGB" or "L" image."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    a = rotation_matrix(angle, w, h)
    if img.dtype == np.uint16:
        return _generic_affine(img, a)
    return _affine_nearest(img, a)


def rotate_joint(angle: float, img: np.ndarray, label: np.ndarray,
                 depth: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Rotate the colour image and label (and the depth) about the centre,
    as the JAX version's `rotate_joint` does."""
    out = [rotate(img, angle), rotate(label, angle)]
    if depth is not None:
        out.append(rotate(depth, angle))
    return out


# ---------------------------------------------------------------------------
# crop and resize
# ---------------------------------------------------------------------------

def crop(img: np.ndarray, box) -> np.ndarray:
    """`Image.crop(box)`, box (left, upper, right, lower) rounded to
    integers; the parts outside the image are zero."""
    left, upper, right, lower = (int(round(v)) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((lower - upper, right - left) + img.shape[2:], img.dtype)
    r0, r1 = max(upper, 0), min(lower, h)
    c0, c1 = max(left, 0), min(right, w)
    if r1 > r0 and c1 > c0:
        out[r0 - upper:r1 - upper, c0 - left:c1 - left] = img[r0:r1, c0:c1]
    return out


_PRECISION_BITS = 22     # Pillow's 8-bit resampling: 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's `bicubic_filter` (a = -0.5), in double."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _bicubic_coeffs(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` for BICUBIC over the whole axis and
    `normalize_coeffs_8bpc`: (first source index (out,), taps (out, ksize)
    int64 in 22-bit fixed point, zero past each output's window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int) truncates toward zero before the clamp
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)[None, :]
    inside = x < xmax[:, None]
    w = np.where(inside, _bicubic(((x + xmin[:, None]) - center[:, None]
                                   + 0.5) * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):           # the C loop's running double sum
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * (1 << _PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, kk.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along `axis` (1: horizontal,
    0: vertical): the int32 accumulator starts at 1 << 21, each tap adds
    pixel * coefficient, and the sum is shifted down and clipped to uint8."""
    xmin, kk = _bicubic_coeffs(img.shape[axis], out_size)
    kk = kk.astype(np.int32)
    last = img.shape[axis] - 1
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for t in range(kk.shape[1]):
        acc += src[np.minimum(xmin + t, last)] * kk[:, t].reshape(shape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`Image.resize(size)` of an "RGB" or "L" image (Pillow's default
    BICUBIC; size (width, height)): `ImagingResample`, a horizontal pass
    into a uint8 image, then a vertical pass; an axis whose size stays is
    not resampled, and an equal size is a copy."""
    ow, oh = size
    out = img
    if img.shape[1] != ow:
        out = _resample_axis(out, ow, 1)
    if img.shape[0] != oh:
        out = _resample_axis(out, oh, 0)
    return out.copy() if out is img else out


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`Image.resize(size, Image.NEAREST)` (size (width, height)) of the
    image whose array `img` is: Pillow runs it as the affine transform
    (w_in / w_out, 0, 0, 0, h_in / h_out, 0), which takes the scale-only
    loop for uint8 ("L", "RGB") and the generic transform for uint16
    ("I;16"); an equal size is a copy."""
    ow, oh = size
    h, w = img.shape[:2]
    if (h, w) == (oh, ow):
        return img.copy()
    a = [w / ow, 0.0, 0.0, 0.0, h / oh, 0.0]
    if img.dtype == np.uint16:
        return _generic_affine(img, a, (oh, ow))
    return _scale_affine(img, a, (oh, ow))


# ---------------------------------------------------------------------------
# crop and zoom
# ---------------------------------------------------------------------------

class CropAndZoom:
    """Label-driven random square crop, resized to `output_size` (the JAX
    `CropAndZoom`)."""

    def __init__(self, output_size: int = 480, bbox_increase: float = 1.1,
                 to_small: float = 0.8, to_big: float = 1.2,
                 max_zoom: float = 2.0,
                 rng: Optional[random.Random] = None):
        self.output_size = output_size
        self.bbox_increase = bbox_increase
        self.to_small = to_small
        self.to_big = to_big
        self.max_l = output_size
        self.min_l = int(float(output_size) / max_zoom)
        self.rng = rng or random

    @staticmethod
    def _extremes(label: np.ndarray) -> np.ndarray:
        pos = np.where(label == 255)
        if len(pos[0]) == 0:
            h, w = label.shape[:2]
            return np.asarray([0, h - 1, 0, w - 1])
        return np.asarray([pos[0].min(), pos[0].max(),
                           pos[1].min(), pos[1].max()])

    @staticmethod
    def _size(ext) -> Tuple[int, int, List[int]]:
        h = ext[1] - ext[0]
        w = ext[3] - ext[2]
        return h, w, [ext[0] + int(h / 2), ext[2] + int(w / 2)]

    @staticmethod
    def _bbox(c, l) -> List[int]:
        half = int(l / 2)
        return [c[0] - half, c[0] + half, c[1] - half, c[1] + half]

    def _inside(self, bbox, size) -> List[int]:
        move = [0, 0]
        if bbox[0] < 0:
            move[0] = bbox[0]
        elif bbox[1] > size[0]:
            move[0] = bbox[1] - size[0]
        if bbox[2] < 0:
            move[1] = bbox[2]
        elif bbox[3] > size[1]:
            move[1] = bbox[3] - size[1]
        return [bbox[0] - move[0], bbox[1] - move[0],
                bbox[2] - move[1], bbox[3] - move[1]]

    def compute_box(self, label_np: np.ndarray):
        """The crop box as a (left, upper, right, lower) tuple."""
        size = label_np.shape  # (h, w)
        ext = self._extremes(label_np)
        h, w, c = self._size(ext)
        h_ratio = float(max(h, 1)) / self.output_size
        w_ratio = float(max(w, 1)) / self.output_size
        h_w_ratio = h_ratio / max(w_ratio, 1e-9)
        ls = [h, w]
        bigger = 1 if w_ratio > h_ratio else 0

        bbox = self._bbox(c, ls[bigger] * self.bbox_increase)
        zoom = int(self.rng.uniform(self.min_l, self.max_l))
        _, _, bc = self._size(bbox)
        bbox = self._bbox(bc, zoom)
        bh, bw, bc = self._size(bbox)

        if self.to_small <= h_w_ratio <= self.to_big:
            if bh <= size[0] and bw <= size[0]:
                bbox = self._inside(bbox, size)
            else:
                bc[1] = int(bc[1] - w / 2) + self.rng.randint(0, max(w, 1))
                bbox = self._bbox(bc, size[0] - 2)
                bbox = self._inside(bbox, size)
        else:
            bc[bigger] = (int(bc[bigger] - ls[bigger] / 2)
                          + self.rng.randint(0, max(ls[bigger], 1)))
            bbox = self._bbox(bc, bh)
            bh, bw, bc = self._size(bbox)
            if bh <= size[0] and bw <= size[0]:
                bbox = self._inside(bbox, size)
            else:
                bbox = self._bbox(bc, size[0] - 2)
                bbox = self._inside(bbox, size)

        return [bbox[2], bbox[0], bbox[3], bbox[1]]  # (l, u, r, d)

    def __call__(self, img: np.ndarray, label: np.ndarray):
        """(img, label) cropped to the box and resized to output_size:
        the image bicubic, the label nearest."""
        box = self.compute_box(label)
        size = (self.output_size, self.output_size)
        return (resize_bicubic(crop(img, box), size),
                resize_nearest(crop(label, box), size))
