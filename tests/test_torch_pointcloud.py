"""The port's point-cloud ops against the JAX package's on the CPU.

The voxel downsample adds in the same order as the JAX scatter, so it is
held to equal bits. The outlier tests measure distances in f64 where the
JAX package uses the f32 expansion |q|^2 + |r|^2 - 2 q.r: a decision may
flip only for a point that some f64 distance puts within that expansion's
rounding band 8 * 2^-24 * (|q|^2 + |r|^2) of the threshold; each test
states how many such flips it allows and checks each one in f64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.ops import pointcloud as jpc
from autoposeestimation_tpu_torch.ops import pointcloud as pc


def surface_cloud(n, seed, center=(30.0, 10.0, 40.0), noise=0.8):
    """n points on a 40 mm ball (mm) with noise and a few far outliers,
    the kind of cloud the reconstruction cleans."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v = v * 40.0 / np.linalg.norm(v, axis=1, keepdims=True) + center
    v += rng.normal(size=(n, 3)) * noise
    v[:5] += rng.normal(size=(5, 3)) * 30.0
    return v.astype(np.float32)


def both(points, size):
    p, v = pc.pad_cloud(points, size)
    return (jnp.asarray(p), jnp.asarray(v)), (torch.from_numpy(p),
                                              torch.from_numpy(v))


def test_pad_compact_and_centres():
    pts = surface_cloud(300, 0)
    p, v = pc.pad_bucket(pts)
    jp, jv = jpc.pad_bucket(pts)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(v, jv)
    assert p.shape == (1024, 3) and pc.bucket_size(1025) == 2048
    np.testing.assert_array_equal(pc.pad_cloud(pts, 512)[0],
                                  jpc.pad_cloud(pts, 512)[0])
    (jt, jvt), (tt, tvt) = both(pts, 512)
    np.testing.assert_array_equal(pc.compact(tt, tvt), jpc.compact(jt, jvt))
    np.testing.assert_array_equal(pc.aabb_center(tt, tvt).numpy(),
                                  np.asarray(jpc.aabb_center(jt, jvt)))
    np.testing.assert_allclose(pc.centroid(tt, tvt).numpy(),
                               np.asarray(jpc.centroid(jt, jvt)), rtol=1e-6)


@pytest.mark.parametrize("voxel", [0.7, 2.0, 5.0])
def test_voxel_downsample_equal_bits(voxel):
    pts = surface_cloud(1500, 1)
    (jp, jv), (tp, tv) = both(pts, 2048)
    jo, jov = jpc.voxel_downsample(jp, jv, voxel)
    to, tov = pc.voxel_downsample(tp, tv, voxel)
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert 0 < int(tov.sum()) < 1500


def test_voxel_downsample_edge_cases():
    pts = np.repeat(surface_cloud(40, 2), 7, axis=0)   # 7 points a voxel
    (jp, jv), (tp, tv) = both(pts, 512)
    jo, jov = jpc.voxel_downsample(jp, jv, 0.01)
    to, tov = pc.voxel_downsample(tp, tv, 0.01)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tov.sum()) == 40
    empty = torch.zeros(64, dtype=torch.bool)
    out, ov = pc.voxel_downsample(torch.ones(64, 3), empty, 1.0)
    assert not ov.any() and not out.any()


def check_flips(points, keep_t, keep_j, threshold2, what, allowed):
    """Each flipped decision must have a pair whose f64 d2 lies within the
    JAX expansion's rounding band of `threshold2`."""
    flips = np.nonzero(keep_t != keep_j)[0]
    assert len(flips) <= allowed, (what, len(flips))
    p64 = points.astype(np.float64)
    for i in flips:
        d2 = np.sum((p64 - p64[i]) ** 2, 1)
        band = 8 * 2.0 ** -24 * (np.sum(p64 ** 2, 1) + np.sum(p64[i] ** 2))
        assert np.any(np.abs(d2 - threshold2) <= band), (what, i)
    return len(flips)


@pytest.mark.parametrize("nb,radius", [(3, 3.0), (5, 5.0), (20, 10.0)])
def test_remove_radius_outliers(nb, radius):
    """At most 2 flips (each checked in f64)."""
    pts = surface_cloud(1200, 3)
    (jp, jv), (tp, tv) = both(pts, 2048)
    want = np.asarray(jpc.remove_radius_outliers(jp, jv, nb, radius))
    got = pc.remove_radius_outliers(tp, tv, nb, radius).numpy()
    check_flips(np.asarray(jp), got, want, np.float32(radius) ** 2,
                "radius", 2)
    assert not got[1200:].any() and 0 < got.sum() < 1200


def test_mean_knn_dists_and_statistical_outliers():
    """Mean kNN distances within 1e-3 mm: the JAX expansion's d^2 is off by
    up to its band, ~5e-3 mm^2 at these 70 mm coordinates, so a distance
    of ~5 mm by up to 5e-4 mm. The keep decisions are equal but for points
    whose mean distance lies within 1e-3 mm of the threshold (at most 2)."""
    pts = surface_cloud(1000, 4)
    (jp, jv), (tp, tv) = both(pts, 1024)
    jd = np.asarray(jpc.mean_knn_dists(jp, jv, 10))
    td = pc.mean_knn_dists(tp, tv, 10).numpy()
    np.testing.assert_allclose(td[:1000], jd[:1000], atol=1e-3)
    want = np.asarray(jpc.remove_statistical_outliers(jp, jv, 10, 1.0))
    got = pc.remove_statistical_outliers(tp, tv, 10, 1.0).numpy()
    d = td[:1000].astype(np.float64)
    thresh = d.mean() + d.std()
    flips = np.nonzero(got != want)[0]
    assert len(flips) <= 2
    assert np.all(np.abs(d[flips] - thresh) <= 1e-3)
    assert not got[:5].any() and got.sum() < 1000


def test_mahalanobis():
    pts = surface_cloud(700, 5)
    (jp, jv), (tp, tv) = both(pts, 1024)
    got = pc.mahalanobis(tp, tv).numpy()
    np.testing.assert_allclose(got, np.asarray(jpc.mahalanobis(jp, jv)),
                               rtol=1e-5, atol=1e-6)
    assert not got[700:].any()


def test_estimate_normals_up_to_sign():
    """|n_port . n_jax| >= 1 - 1e-4, the normals being unit eigenvectors
    up to sign; the JAX normals are checked against the ball's radii."""
    pts = surface_cloud(800, 6, noise=0.05)
    (jp, jv), (tp, tv) = both(pts, 1024)
    jn = np.asarray(jpc.estimate_normals(jp, jv, 30))[5:800]
    tn = pc.estimate_normals(tp, tv, 30).numpy()[5:800]
    np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0, atol=1e-5)
    assert np.all(np.abs(np.sum(tn * jn, 1)) >= 1 - 1e-4)
    radial = pts[5:800] - [30.0, 10.0, 40.0]
    radial /= np.linalg.norm(radial, axis=1, keepdims=True)
    assert np.median(np.abs(np.sum(tn * radial, 1))) > 0.99


def test_triangulation():
    rng = np.random.default_rng(7)
    target = np.asarray([10.0, -20.0, 35.0])
    origins = rng.normal(size=(6, 3)) * 300
    dirs = target - origins + rng.normal(size=(6, 3)) * 0.5
    got = pc.triangulate_position(torch.from_numpy(origins),
                                  torch.from_numpy(dirs)).numpy()
    want = np.asarray(jpc.triangulate_position(jnp.asarray(origins,
                                                           jnp.float32),
                                               jnp.asarray(dirs, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, target, atol=1.0)
    a1, a2 = pc.intersect_line_line(*(torch.from_numpy(x) for x in (
        origins[0], dirs[0], origins[1], dirs[1])))
    b1, b2 = jpc.intersect_line_line(*(jnp.asarray(x, jnp.float32) for x in (
        origins[0], dirs[0], origins[1], dirs[1])))
    np.testing.assert_allclose(a1.numpy(), np.asarray(b1), atol=1e-3)
    np.testing.assert_allclose(a2.numpy(), np.asarray(b2), atol=1e-3)
