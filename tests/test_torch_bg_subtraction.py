"""The port's classical background subtraction against the JAX package on
the CPU: the morphology (equal), both HSV conversions (equal), the
table-plane fill (within 1e-4 mm), `create_label_rgbd` in every colour
mode with and without `remove_one_std` and the connected components (masks
equal but for pixels whose score lies within 1e-4 of the threshold), and
`build_bs_input` with depth differences above 255 (within 1e-6, or one
f32 ulp of values above 8: XLA fuses the /255 and the normalization and
rounds the last bit otherwise)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.ops import bg_subtraction as jbgs
from autoposeestimation_tpu.ops import morphology as jmorph
from autoposeestimation_tpu_torch.ops import bg_subtraction as bgs
from autoposeestimation_tpu_torch.ops import morphology as morph
from autoposeestimation_tpu_torch.utils import synthetic
from test_torch_seg_models import two_threads  # noqa: F401

SCORE_TIE = 1e-4    # score this close to the threshold: either side is right
PLANE_ATOL = 1e-4   # mm
BS_ATOL = 1e-6
BS_RTOL = 2.0 ** -23   # one f32 ulp, relative


def morph_input(dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((37, 53)) * 255).astype(dtype)
    x[rng.random(x.shape) < 0.3] = 0
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("k", [3, 5, 6, 9])
def test_morphology(k, dtype):
    """Erode, dilate, opening and closing equal the JAX ones at odd and even
    kernels (OpenCV's asymmetric anchor at 6), in f32 and uint8; the box
    filter in f32, equal. The JAX functions reject a uint8 image (their
    integer border value is an int32 scalar), so the uint8 case is held
    against them on the same values as int32."""
    x = morph_input(dtype, k)
    jx = jnp.asarray(x if dtype == np.float32 else x.astype(np.int32))
    for name in ("erode", "dilate", "opening", "closing"):
        want = np.asarray(getattr(jmorph, name)(jx, k))
        got = getattr(morph, name)(torch.from_numpy(x), k).numpy()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want.astype(dtype), err_msg=name)
    if dtype == np.float32:
        depth = (np.random.default_rng(k).random((40, 50)) * 1000).astype(
            np.float32)
        np.testing.assert_array_equal(
            morph.box_smooth(torch.from_numpy(depth), k).numpy(),
            np.asarray(jmorph.box_smooth(jnp.asarray(depth), k)))


def hsv_inputs():
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 256, (100_000, 3))
    grey = np.repeat(np.arange(256)[:, None], 3, axis=1)
    # two or three channels sharing the maximum, in every position
    v = rng.integers(1, 256, 3000)
    lo = rng.integers(0, 256, 3000) % v
    ties = np.concatenate([np.stack([v, v, lo], 1), np.stack([v, lo, v], 1),
                           np.stack([lo, v, v], 1)])
    return np.concatenate([rand, grey, ties]).astype(np.float32)


@pytest.mark.parametrize("name", ["rgb_to_hsv_cv2", "rgb_to_hsv_pil"])
def test_hsv_conversions(name):
    rgb = hsv_inputs()
    got = getattr(bgs, name)(torch.from_numpy(rgb)).numpy()
    want = np.asarray(getattr(jbgs, name)(jnp.asarray(rgb)))
    np.testing.assert_array_equal(got, want)


def plane_case(kind):
    """A 100x120 background depth: a tilted table everywhere ('many': the
    crop's lowest valid row has >100 pixels), a diamond of valid pixels
    ('few': its lowest row has one), or no valid pixel."""
    rows, cols = np.mgrid[:100, :120].astype(np.float32)
    depth = np.round(900.0 + 1.5 * rows - 0.7 * cols).astype(np.float32)
    if kind == "few":
        diamond = np.abs(rows - 50) + np.abs(cols - 60) <= 25
        depth = np.where(diamond, depth, 0.0).astype(np.float32)
    elif kind == "none":
        depth[:] = 0.0
    return depth


@pytest.mark.parametrize("kind", ["many", "few", "none"])
def test_plane_fill(kind):
    depth = plane_case(kind)
    got = bgs._plane_fill(torch.from_numpy(depth)).numpy()
    want = np.asarray(jax.jit(jbgs._plane_fill)(jnp.asarray(depth)))
    np.testing.assert_allclose(got, want, atol=PLANE_ATOL, rtol=0)
    if kind == "none":
        np.testing.assert_array_equal(got, depth)
    else:
        assert not np.array_equal(got, depth)


def scene(view: int):
    """A 128x160 tabletop view with and without a two-colour object, depth
    noise of 1 mm, and its camera distance (mm)."""
    cfg = synthetic.SynthConfig(noise=1.0)
    obj = synthetic.SphereObject(
        "a", np.asarray([20.0, 0.0, 35.0]), 35.0, (200, 40, 40),
        parts=(((0.0, 35.0, 10.0), 15.0, (230, 200, 30)),))
    cam = synthetic.ring_cameras(cfg, np.zeros(3))[view]
    bg_rgb, bg_d, _ = synthetic.render(cfg, cam, [])
    fg_rgb, fg_d, owner = synthetic.render(cfg, cam, [obj])
    return (bg_rgb, fg_rgb, np.round(bg_d).astype(np.float32),
            np.round(fg_d).astype(np.float32),
            float(np.linalg.norm(cam[:3, 3])), owner == 0)


MODES = {"hsv": dict(hsv=True), "both": dict(hsv=False, both=True),
         "rgb": dict(hsv=False, both=False)}


@pytest.mark.parametrize("do_cca", [True, False])
@pytest.mark.parametrize("remove_one_std", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_create_label_rgbd(mode, remove_one_std, do_cca):
    kw = dict(MODES[mode], remove_one_std=remove_one_std, do_cca=do_cca)
    if mode == "both":            # the labeling's own parameters
        kw.update(threshold=30.0, open_k=6, close_k=6)
    for view in (0, 5):
        bg_rgb, fg_rgb, bg_d, fg_d, dist, truth = scene(view)
        want = np.asarray(jbgs.create_label_rgbd(
            *(jnp.asarray(a) for a in (bg_rgb.astype(np.float32),
                                       fg_rgb.astype(np.float32), bg_d,
                                       fg_d)), jnp.float32(dist), **kw))
        args = [torch.from_numpy(a) for a in (bg_rgb, fg_rgb, bg_d, fg_d)]
        got = bgs.create_label_rgbd(*args, dist, **kw).numpy()
        assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
        p = bgs.P_HSV if kw["hsv"] else (bgs.P_BOTH if kw.get("both")
                                         else bgs.P_RGB)
        _, score = bgs.label_scores(*args, dist, p, kw["hsv"],
                                    kw.get("both", False))
        at_threshold = np.abs(score.numpy() - kw.get("threshold", 100.0)
                              ) < SCORE_TIE
        differ = got != want
        assert not (differ & ~at_threshold).any(), (view, differ.sum())
        iou = ((got > 0) & truth).sum() / ((got > 0) | truth).sum()
        assert iou > 0.5, (view, iou)


def test_build_bs_input_wraps_large_depth_differences():
    bg_rgb, fg_rgb, bg_d, fg_d, dist, _ = scene(3)
    # depth differences of 100-400 mm on alternate columns, inside the
    # measurement window
    fg_d = np.where(fg_d > 0, fg_d + 100.0 * (np.arange(160) % 4), 0.0
                    ).astype(np.float32)
    want = np.asarray(jbgs.build_bs_input(
        jnp.asarray(bg_rgb, jnp.float32), jnp.asarray(fg_rgb, jnp.float32),
        jnp.asarray(bg_d), jnp.asarray(fg_d), jnp.float32(dist + 100.0)))
    got = bgs.build_bs_input(*(torch.from_numpy(a) for a in (
        bg_rgb, fg_rgb, bg_d, fg_d)), dist + 100.0).numpy()
    assert got.shape == (128, 160, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=BS_ATOL, rtol=BS_RTOL)
    # some depth difference wrapped past 255
    raw = np.abs(fg_d - bg_d)[(bg_d > 0) & (fg_d > 0)]
    assert (raw > 255).any()
