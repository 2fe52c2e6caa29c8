"""The port's ICP against the JAX package's on the CPU, on the clouds of
tests/test_icp.py.

The JAX side finds its correspondences through the TPU kernel's function,
`nn_pallas(interpret=True)` (on the CPU its `nn` would take `nn_xla`), so
both sides pick the same neighbours. The port sums in f64 where the JAX
package sums in f32; tolerances: transforms within 1e-4 (mm and rotation
entries), fitness equal, iteration counts equal, rmse within 2e-3 mm. At
these 40 mm coordinates the expansion |q|^2 + |r|^2 - 2 q.r rounds d2 by
up to ~1e-4 mm^2, so an rmse at its floor (~4e-3 mm for clouds that
register exactly) moves by up to ~1e-3 mm with the last bit of the moved
points. For the same reason the cases use Open3D's default criteria
(1e-2), the pipeline's: with criteria of 1e-6, as tests/test_icp.py's
point-to-plane case sets, the stopping iteration is decided by that
rounding noise in either package."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.ops import icp as jicp
from autoposeestimation_tpu.ops import knn as jknn
from autoposeestimation_tpu.ops import pointcloud as jpc
from autoposeestimation_tpu.utils import transforms as jT
from autoposeestimation_tpu_torch.ops import icp
from autoposeestimation_tpu_torch.ops import pointcloud as pc
from autoposeestimation_tpu_torch.utils import transforms as T
from test_icp import apply_np, make_shape


@pytest.fixture(scope="module", autouse=True)
def jax_nn_is_the_kernel():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "nn", functools.partial(jknn.nn_pallas,
                                                 interpret=True))
        jax.clear_caches()          # no trace of registration_icp with nn_xla
        yield
    jax.clear_caches()


def true_tf(euler, trans):
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = np.asarray(jT.euler_to_mat(*(jnp.float32(a) for a in euler)))
    tf[:3, 3] = trans
    return tf


def clouds(n, seed, euler, trans, size, noise=0.0, keep=None):
    rng = np.random.default_rng(seed)
    src = make_shape(n, seed=seed)
    tgt = apply_np(true_tf(euler, trans), src)
    tgt = tgt + rng.normal(scale=noise, size=src.shape) if noise else tgt
    tgt = tgt[:keep] if keep else tgt
    s, sv = pc.pad_cloud(src, size)
    t, tv = pc.pad_cloud(tgt.astype(np.float32), size)
    return s, sv, t, tv


CASES = {
    "p2p": (clouds(400, 0, (0.05, -0.08, 0.1), (3.0, -2.0, 1.5), 512),
            dict(max_corr_dist=20.0)),
    "p2p noisy partial": (clouds(600, 2, (0.06, 0.0, 0.07), (2.0, 1.0, -1.0),
                                 1024, noise=0.05, keep=500),
                          dict(max_corr_dist=15.0)),
    "p2plane": (clouds(400, 1, (0.03, 0.02, -0.04), (1.0, 0.5, -0.8), 512),
                dict(max_corr_dist=10.0, estimation="point_to_plane")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_registration_icp_against_jax(name):
    (s, sv, t, tv), kw = CASES[name]
    want = jicp.registration_icp(jnp.asarray(s), jnp.asarray(sv),
                                 jnp.asarray(t), jnp.asarray(tv), **kw)
    got = icp.registration_icp(torch.from_numpy(s), torch.from_numpy(sv),
                               torch.from_numpy(t), torch.from_numpy(tv),
                               **kw)
    assert got.transformation.dtype == torch.float32
    assert got.num_iterations == int(want.num_iterations)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(want.transformation), atol=1e-4)
    assert float(got.fitness) == float(want.fitness)
    assert abs(float(got.inlier_rmse) - float(want.inlier_rmse)) <= 2e-3


def test_icp_regression_against_jax():
    s, sv, t, tv = clouds(300, 3, (0.0, 0.0, 0.0), (4.0, -1.0, 2.0), 512)
    want = jicp.icp_regression(jnp.asarray(t), jnp.asarray(tv),
                               jnp.asarray(s), jnp.asarray(sv),
                               voxel_size=2.0, threshold=50.0)
    got = icp.icp_regression(torch.from_numpy(t), torch.from_numpy(tv),
                             torch.from_numpy(s), torch.from_numpy(sv),
                             voxel_size=2.0, threshold=50.0)
    for g, w in zip(got[:4], want[:4]):          # the downsampled clouds
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=1e-4)
    # with the FPFH + RANSAC initial transform (each package's own draw):
    # the same registration
    want = jicp.icp_regression(jnp.asarray(t), jnp.asarray(tv),
                               jnp.asarray(s), jnp.asarray(sv),
                               voxel_size=2.0, threshold=50.0,
                               global_regression=True)
    got = icp.icp_regression(*(torch.from_numpy(x) for x in (t, tv, s, sv)),
                             voxel_size=2.0, threshold=50.0,
                             global_regression=True)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=1e-4)


def test_kabsch_and_point2plane_step_against_jax():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(200, 3)).astype(np.float32) * 20
    tgt = apply_np(true_tf((0.2, -0.1, 0.3), (5.0, 1.0, -2.0)), src)
    w = (rng.random(200) > 0.1).astype(np.float32)
    np.testing.assert_allclose(
        icp._kabsch(*(torch.from_numpy(x) for x in (src, tgt, w))).numpy(),
        np.asarray(jicp._kabsch(jnp.asarray(src), jnp.asarray(tgt),
                                jnp.asarray(w))), atol=1e-4)
    normals = rng.normal(size=(200, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    near = apply_np(true_tf((0.01, -0.02, 0.015), (0.3, -0.2, 0.1)), src)
    np.testing.assert_allclose(
        icp._point2plane_step(*(torch.from_numpy(x) for x in (
            src, near, normals, w))).numpy(),
        np.asarray(jicp._point2plane_step(jnp.asarray(src), jnp.asarray(near),
                                          jnp.asarray(normals),
                                          jnp.asarray(w))), atol=1e-4)


def test_port_matches_its_voxel_downsample_input():
    """`icp_regression` downsamples with the op of ops/pointcloud.py."""
    s, sv, _, _ = clouds(300, 5, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 512)
    got, gv = pc.voxel_downsample(torch.from_numpy(s), torch.from_numpy(sv),
                                  2.0)
    want, wv = jpc.voxel_downsample(jnp.asarray(s), jnp.asarray(sv), 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_transforms_against_jax():
    """euler_to_mat / mat_to_euler (gimbal lock included), apply_tf and
    tf_inverse within f32 rounding (1e-6)."""
    rng = np.random.default_rng(6)
    eul = rng.uniform(-3, 3, (3, 16)).astype(np.float32)
    eul[1, :2] = [np.pi / 2, -np.pi / 2]                    # gimbal lock
    got = T.euler_to_mat(*(torch.from_numpy(e) for e in eul)).numpy()
    want = np.asarray(jT.euler_to_mat(*(jnp.asarray(e) for e in eul)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    for g, w in zip(T.mat_to_euler(torch.from_numpy(want)),
                    jT.mat_to_euler(jnp.asarray(want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    tf = jT.make_tf(jnp.asarray(want), jnp.asarray(
        rng.normal(size=(16, 3)).astype(np.float32)))
    pts = rng.normal(size=(16, 5, 3)).astype(np.float32) * 50
    np.testing.assert_allclose(
        T.apply_tf(torch.from_numpy(np.asarray(tf)),
                   torch.from_numpy(pts)).numpy(),
        np.asarray(jT.apply_tf(tf, jnp.asarray(pts))), atol=1e-4)
    np.testing.assert_allclose(
        T.tf_inverse(torch.from_numpy(np.asarray(tf))).numpy(),
        np.asarray(jT.tf_inverse(tf)), atol=1e-6)
