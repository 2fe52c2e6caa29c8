"""The port's numpy augmentations (`data/augment.py`) against the JAX
package's Pillow ones, bit for bit: colour jitter over many seeds and
extrapolating factors, Pillow's HSV conversions on every RGB colour and
every HSV triple, the joint rotation of PIL-written RGB, L and I;16 PNGs
(including the case where the "L" resampling path applied to depth would
be wrong), the crop box of `CropAndZoom` and `zoom_window_bbox_np`."""
import random

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance

from autoposeestimation_tpu.data import augment as jaug
from autoposeestimation_tpu.ops import projection as jproj
from autoposeestimation_tpu_torch.data import augment as aug
from autoposeestimation_tpu_torch.ops import projection as proj
from autoposeestimation_tpu_torch.utils import png


def textured(rng, h=48, w=64):
    """An RGB frame with smooth regions, grey pixels and noise, so every
    HSV branch and both blend branches are reached."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
    img = (base + rng.integers(-40, 40, (h, w, 3))).clip(0, 255)
    img[: h // 4, : w // 4] = rng.integers(0, 256, (1, 1, 1))   # grey block
    return img.astype(np.uint8)


@pytest.mark.parametrize("first_seed", range(0, 60, 10))
@pytest.mark.parametrize("strength", [0.2, 0.9])
def test_color_jitter_equals_pillow(first_seed, strength):
    """Ten seeds per case; strength 0.9 draws factors in [0.1, 1.9], both
    sides of 1 (blend interpolates below 1, extrapolates and clips above)."""
    for seed in range(first_seed, first_seed + 10):
        img = textured(np.random.default_rng(seed))
        jr, pr = random.Random(seed), random.Random(seed)
        want = np.asarray(jaug.color_jitter(
            Image.fromarray(img), strength, strength, strength, 0.05,
            rng=jr))
        got = aug.color_jitter(img, strength, strength, strength, 0.05,
                               rng=pr)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert jr.getstate() == pr.getstate()


@pytest.mark.parametrize("factor", [0.0, 0.3, 0.85, 0.999, 1.0, 1.15,
                                    1.7, 2.5])
def test_enhance_ops_equal_pillow(factor):
    img = textured(np.random.default_rng(7), 96, 128)
    pil = Image.fromarray(img)
    for ours, theirs in ((aug.adjust_brightness, ImageEnhance.Brightness),
                         (aug.adjust_contrast, ImageEnhance.Contrast),
                         (aug.adjust_saturation, ImageEnhance.Color)):
        np.testing.assert_array_equal(
            ours(img, factor), np.asarray(theirs(pil).enhance(factor)),
            err_msg=f"{ours.__name__} {factor}")


def test_blend_truncates_in_float():
    """Pillow's C-float blend truncates toward zero (101 * 0.85 = 85.85 ->
    85) and clips when extrapolating (101 * 1.15 = 116.15 -> 116)."""
    zero, px = np.zeros((1, 1), np.uint8), np.full((1, 1), 101, np.uint8)
    assert aug.blend(zero, px, 0.85)[0, 0] == 85
    assert aug.blend(zero, px, 1.15)[0, 0] == 116
    assert aug.blend(zero, np.full((1, 1), 250, np.uint8), 1.15)[0, 0] == 255
    for f in (0.85, 1.15):
        want = Image.blend(Image.fromarray(zero), Image.fromarray(px), f)
        assert np.asarray(want)[0, 0] == aug.blend(zero, px, f)[0, 0]


def all_triples(rows):
    """The 2^24 byte triples as a (4096, 4096, 3) image, rows [a, b)."""
    k = np.arange(rows.start * 4096, rows.stop * 4096, dtype=np.uint32)
    return np.stack([(k >> 16) & 255, (k >> 8) & 255, k & 255],
                    -1).astype(np.uint8).reshape(-1, 4096, 3)


@pytest.mark.parametrize("direction", ["rgb_to_hsv", "hsv_to_rgb"])
def test_hsv_conversions_every_triple(direction):
    """Both of Pillow's HSV conversions on all 2^24 inputs (a hue shift
    only changes which HSV triple is converted back, so this covers the
    round trip of every colour at every shift)."""
    for start in range(0, 4096, 1024):
        block = all_triples(range(start, start + 1024))
        if direction == "rgb_to_hsv":
            want = np.asarray(Image.fromarray(block).convert("HSV"))
            got = aug.rgb_to_hsv(block)
        else:
            want = np.asarray(Image.fromarray(block, "HSV").convert("RGB"))
            got = aug.hsv_to_rgb(block)
        bad = np.flatnonzero((got != want).any(-1))
        assert bad.size == 0, (start, bad[:5])


def test_hue_shift_round_trip_every_shift():
    """The JAX jitter's hue op (PIL `convert("HSV")`, shift, back) against
    `hue_shift` for every shift int(sh * 255) with |sh| <= 0.05, on every
    61st colour."""
    k = np.arange(0, 1 << 24, 61, dtype=np.uint32)
    k = k[: (k.size // 1000) * 1000]
    rgb = np.stack([(k >> 16) & 255, (k >> 8) & 255, k & 255],
                   -1).astype(np.uint8).reshape(-1, 1000, 3)
    hsv = np.array(Image.fromarray(rgb).convert("HSV"), dtype=np.int16)
    for shift in range(-12, 13):
        h = hsv.copy()
        h[..., 0] = (h[..., 0] + shift) % 256
        want = np.asarray(Image.fromarray(h.astype(np.uint8), "HSV")
                          .convert("RGB"))
        np.testing.assert_array_equal(aug.hue_shift(rgb, shift), want,
                                      err_msg=f"shift {shift}")


def written(tmp_path, arr, name):
    """`arr` written by PIL and read back both ways: (PIL image, array
    from the port's codec)."""
    path = str(tmp_path / f"{name}.png")
    Image.fromarray(arr).save(path)
    return Image.open(path), png.read(path)


def frames(tmp_path, h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = textured(rng, h, w)
    label = (rng.random((h, w)) < 0.3).astype(np.uint8) * 255
    depth = rng.integers(300, 4000, (h, w)).astype(np.uint16)
    out = [written(tmp_path, a, n) for a, n in ((img, "c"), (label, "l"),
                                               (depth, "d"))]
    assert [p.mode for p, _ in out] == ["RGB", "L", "I;16"]
    return out


EXACT_ANGLES = [0.0, 90.0, 180.0, 270.0, -180.0, 180.0 + 360.0, -90.0,
                1e-15, 360.0 - 1e-13]


@pytest.mark.parametrize("hw", [(48, 64), (40, 40)])
def test_rotate_joint_equals_pillow(tmp_path, hw):
    """RGB, L and I;16 rotated together at 60 random angles and the
    special ones: the transpose shortcuts (90/270 only for the square
    frame) and matrices whose shear rounds to zero (scale-only path)."""
    (pc, c), (pl, l_), (pd, d) = frames(tmp_path, *hw)
    angles = EXACT_ANGLES + list(
        np.random.default_rng(1).uniform(-180, 180, 60))
    for angle in angles:
        want = [np.asarray(x) for x in jaug.rotate_joint(angle, pc, pl, pd)]
        got = aug.rotate_joint(angle, c, l_, d)
        for name, g, w_ in zip(("rgb", "label", "depth"), got, want):
            assert g.dtype == w_.dtype
            np.testing.assert_array_equal(g, w_, err_msg=f"{name} {angle}")


def test_depth_needs_its_own_rotation_path(tmp_path):
    """At 640x480 Pillow's I;16 path (generic transform, double
    coordinates) and its L/RGB path (16.16 fixed point) pick different
    source pixels for many pixels: rotating depth as an "L" image would be
    wrong, and the port's depth rotation is right."""
    (_, _), (_, _), (pd, d) = frames(tmp_path, 480, 640, seed=3)
    wrong = 0
    for angle in np.random.default_rng(2).uniform(-180, 180, 5):
        want = np.asarray(pd.rotate(angle))
        np.testing.assert_array_equal(aug.rotate(d, angle), want)
        as_l = aug._affine_nearest(d, aug.rotation_matrix(angle, 640, 480))
        wrong += int((as_l != want).sum())
    assert wrong > 1000, wrong


def test_crop_and_zoom_box_equals_jax():
    rng = np.random.default_rng(4)
    labels = [np.zeros((120, 160), np.uint8)]
    for h0, w0, hh, ww in ((10, 20, 30, 40), (0, 0, 119, 20),
                           (50, 5, 8, 150), (60, 100, 59, 59)):
        lab = np.zeros((120, 160), np.uint8)
        lab[h0:h0 + hh, w0:w0 + ww] = 255
        labels.append(lab)
    labels.append((rng.random((120, 160)) < 0.01).astype(np.uint8) * 255)
    for i, lab in enumerate(labels):
        for seed in range(5):
            for size in (64, 100):
                want = jaug.CropAndZoom(size, rng=random.Random(seed)
                                        ).compute_box(lab)
                got = aug.CropAndZoom(size, rng=random.Random(seed)
                                      ).compute_box(lab)
                assert [int(v) for v in got] == [int(v) for v in want], \
                    (i, seed, size)


def test_zoom_window_bbox_np_equals_jax_and_serving():
    rng = np.random.default_rng(5)
    h, w = 120, 160
    masks = [np.zeros((h, w), bool), np.ones((h, w), bool)]
    for _ in range(30):
        m = np.zeros((h, w), bool)
        r, c = rng.integers(0, h), rng.integers(0, w)
        m[r:r + rng.integers(1, 90), c:c + rng.integers(1, 130)] = True
        masks.append(m)
    masks.append(rng.random((h, w)) < 0.002)
    for crop in (32, 64, 120):
        for m in masks:
            want = jproj.zoom_window_bbox_np(m, crop, h, w)
            got = proj.zoom_window_bbox_np(m, crop, h, w)
            assert got == tuple(int(v) for v in want)
            serving = proj.zoom_window_bbox(torch.from_numpy(m)[None], crop,
                                            h, w)
            assert got == tuple(int(v) for v in serving)
