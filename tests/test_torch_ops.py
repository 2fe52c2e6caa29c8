"""The port's transforms, projection and CCA ops held against the JAX
package's on the CPU: indices, labels, masks and counts exactly, floats
within f32 rounding. The JAX side's random draws are computed here and
handed to the port as `uniforms`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.ops import cca as jcca
from autoposeestimation_tpu.ops import projection as jproj
from autoposeestimation_tpu.utils import transforms as jT
from autoposeestimation_tpu_torch.ops import cca, projection
from autoposeestimation_tpu_torch.utils import transforms as T


def t(x):
    return torch.from_numpy(np.array(x))


# --- transforms --------------------------------------------------------------

def test_quaternion_ops():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(6, 4)).astype(np.float32)
    q2 = rng.normal(size=(6, 4)).astype(np.float32)
    t1 = rng.normal(size=(6, 3)).astype(np.float32)
    t2 = rng.normal(size=(6, 3)).astype(np.float32)
    pairs = [
        (T.quat_normalize(t(q1)), jT.quat_normalize(q1)),
        (T.quat_to_mat(t(q1)), jT.quat_to_mat(q1)),
        (T.quat_multiply(t(q1), t(q2)), jT.quat_multiply(q1, q2)),
        (T.pose_to_tf(t(q1), t(t1)), jT.pose_to_tf(q1, t1)),
        (T.make_tf(trans=t(t2)), jT.make_tf(trans=t2)),
    ]
    pairs += list(zip(T.compose_quat_poses(t(q1), t(t1), t(q2), t(t2)),
                      jT.compose_quat_poses(q1, t1, q2, t2)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_mat_to_quat_every_pivot():
    """Rotations whose largest Shepperd pivot is w, x, y and z."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:4] = np.eye(4, dtype=np.float32) + 0.05
    mats = np.asarray(jT.quat_to_mat(q))
    np.testing.assert_allclose(T.mat_to_quat(t(mats)).numpy(),
                               np.asarray(jT.mat_to_quat(mats)), atol=1e-6)


# --- projection --------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 7, 40, 500])
def test_choose_masked_indices(count):
    """Wrap-pad below num_pt, stratified draws above it, empty -> zeros."""
    rng = np.random.default_rng(count)
    window = np.zeros(32 * 32, bool)
    window[rng.choice(32 * 32, count, replace=False)] = True
    window = window.reshape(32, 32)
    key = jax.random.PRNGKey(count)
    want_idx, want_count = jproj.choose_masked_indices(jnp.asarray(window),
                                                       40, key)
    u = np.asarray(jax.random.uniform(key, (40,)))
    idx, got_count = projection.choose_masked_indices(t(window), 40, t(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert int(got_count) == int(want_count) == count


def blob_masks(h=96, w=128):
    """Two blobs and one box of mixed size: the class masks of a frame."""
    rr, cc = np.mgrid[:h, :w]
    masks = np.zeros((3, h, w), bool)
    masks[0] = (rr - 30) ** 2 + (cc - 40) ** 2 < 15 ** 2
    masks[1] = (rr - 60) ** 2 / 4 + (cc - 100) ** 2 < 12 ** 2
    masks[2, 10:95, 5:120] = True          # larger than the crop
    return masks


def test_zoom_window_and_resample():
    masks = blob_masks()
    img = np.random.default_rng(2).integers(0, 256, (96, 128, 3), np.uint8)
    r0, c0, win = projection.zoom_window_bbox(t(masks), 48, 96, 128)
    crops = projection.resample_window(t(img).permute(2, 0, 1), r0, c0, win,
                                       48)
    for k in range(3):
        jr0, jc0, jwin = jproj.zoom_window_bbox(jnp.asarray(masks[k]), 48,
                                                96, 128)
        assert (int(r0[k]), int(c0[k]), int(win[k])) == (
            int(jr0), int(jc0), int(jwin))
        want = jproj.resample_window(jnp.asarray(img), jr0, jc0, jwin, 48)
        np.testing.assert_array_equal(crops[k].permute(1, 2, 0).numpy(),
                                      np.asarray(want))


def test_backproject_choose_zoom():
    masks = blob_masks()
    rng = np.random.default_rng(3)
    depth = rng.uniform(500, 900, (96, 128)).astype(np.float32)
    depth[rng.random((96, 128)) < 0.1] = 0.0      # holes
    intr = np.asarray([120.0, 110.0, 64.0, 48.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    u = np.stack([np.asarray(jax.random.uniform(k, (64,))) for k in keys])
    r0, c0, win = projection.zoom_window_bbox(t(masks), 48, 96, 128)
    cloud, choose, count = projection.backproject_choose_zoom(
        t(depth), t(masks), t(intr), 0.001, r0, c0, win, 48, 64, t(u))
    for k in range(3):
        jr0, jc0, jwin = jproj.zoom_window_bbox(jnp.asarray(masks[k]), 48,
                                                96, 128)
        jcloud, jchoose, jcount = jproj.backproject_choose_zoom(
            jnp.asarray(depth), jnp.asarray(masks[k]), jnp.asarray(intr),
            jnp.float32(0.001), jr0, jc0, jwin, 48, 64, keys[k])
        np.testing.assert_array_equal(choose[k].numpy(), np.asarray(jchoose))
        assert int(count[k]) == int(jcount)
        np.testing.assert_allclose(cloud[k].numpy(), np.asarray(jcloud),
                                   atol=1e-6)


# --- connected components ----------------------------------------------------

def random_mask(seed, h=40, w=56, p=0.45):
    """Speckle thresholded from smoothed noise: many components with
    turns."""
    rng = np.random.default_rng(seed)
    x = rng.random((h + 4, w + 4))
    x = sum(x[i:i + h, j:j + w] for i in range(5) for j in range(5)) / 25
    return x > np.quantile(x, 1 - p)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("fixed_sweeps", [0, 2])
def test_connected_components(connectivity, fixed_sweeps):
    mask = random_mask(connectivity + fixed_sweeps)
    want, want_conv = jcca.connected_components(
        jnp.asarray(mask), connectivity, fixed_sweeps=fixed_sweeps,
        with_flag=True)
    got, got_conv = cca.connected_components(
        t(mask), connectivity, fixed_sweeps=fixed_sweeps, with_flag=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got_conv) == bool(want_conv)


@pytest.mark.parametrize("rule", ["mean", "mean_float", "area", "sum"])
@pytest.mark.parametrize("scale", [1, 8])
def test_best_component_mask(rule, scale):
    """Batched port (3 masks at once) against the JAX version per mask."""
    rng = np.random.default_rng(5)
    masks = np.stack([random_mask(s, 50, 70, 0.35) for s in (6, 7, 8)])
    score = rng.random(masks.shape).astype(np.float32)
    if rule == "mean":
        score = score * 3.0      # the floored mean needs scores above 1
    comp, found, conv = cca.best_component_mask(
        t(masks), t(score), min_size=3.0, rule=rule, scale=scale,
        fixed_sweeps=3, with_flag=True)
    for k in range(3):
        jcomp, jfound, jconv = jcca.best_component_mask(
            jnp.asarray(masks[k]), jnp.asarray(score[k]), min_size=3.0,
            rule=rule, scale=scale, fixed_sweeps=3, with_flag=True)
        np.testing.assert_array_equal(comp[k].numpy(), np.asarray(jcomp))
        assert bool(found[k]) == bool(jfound)
        assert bool(conv[k]) == bool(jconv)


def test_component_stats():
    mask = random_mask(9)
    score = np.random.default_rng(9).random(mask.shape).astype(np.float32)
    labels = cca.connected_components(t(mask))
    counts, sums = cca.component_stats(labels, t(mask), t(score))
    jlabels = jcca.connected_components(jnp.asarray(mask))
    jcounts, jsums = jcca.component_stats(jlabels, jnp.asarray(mask),
                                          jnp.asarray(score))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), atol=1e-5)
