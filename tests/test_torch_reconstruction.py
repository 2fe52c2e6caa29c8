"""The port's reconstruction slice against the JAX package on the CPU: the
synthetic dataset writer, `load_point_cloud` and `create_pose_label` on
one JAX-written dataset (160x128, 5 views of a ball with a bump), and the
canonical-cloud registration of a turned run.

The JAX side finds ICP correspondences through the TPU kernel's function,
`nn_pallas(interpret=True)`, as the port does. What remains different is
the rounding of the outlier tests and of ICP's sums (f64 in the port, f32
in the JAX package); on this dataset it leaves the clouds within 1e-3 mm
of each other, point for point (measured: 2.7e-5 mm mean, 1.1e-4 mm
largest), with equal point counts."""
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.labeling import pose_labels as jpl
from autoposeestimation_tpu.ops import knn as jknn
from autoposeestimation_tpu.ops import projection as jproj
from autoposeestimation_tpu.reconstruction import create_pointcloud as jrec
from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.labeling import pose_labels
from autoposeestimation_tpu_torch.ops import projection
from autoposeestimation_tpu_torch.reconstruction import create_pointcloud as rec
from autoposeestimation_tpu_torch.utils import io, synthetic

SETTINGS = dict(mode="gen", n_viewpoints=5, min_friends=5, min_dist=8,
                nb_neighbors=10, threshold=10, voxel_size=3,
                voxel_size_out=6, icp_point2plane=False)


def ball(pkg):
    return pkg.SphereObject("ball", np.asarray([30.0, 10.0, 40.0]), 40.0,
                            (210, 50, 50), parts=(((25.0, 25.0, 25.0), 18.0),))


@pytest.fixture(scope="module", autouse=True)
def jax_nn_is_the_kernel():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "nn", functools.partial(jknn.nn_pallas,
                                                 interpret=True))
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One JAX-written dataset, copied for each package, each package's
    reconstruction and pose labels in its own copy."""
    base = tmp_path_factory.mktemp("recon")
    jsyn.make_dataset(str(base / "jax"), objects=[ball(jsyn)],
                      cfg=jsyn.SynthConfig(n_viewpoints=5))
    shutil.copytree(base / "jax", base / "port")
    out = {}
    for name, load, label, kw in (
            ("jax", jrec.load_point_cloud, jpl.create_pose_label, {}),
            ("port", rec.load_point_cloud, pose_labels.create_pose_label,
             {"device": "cpu"})):
        root = str(base / name)
        cloud = load("ball", jio.pc_dir(root), root, **SETTINGS, **kw)
        written = label(root, "ball", **kw)
        out[name] = (root, cloud, written)
    return out


def mean_and_max_nn(a, b):
    d = np.sqrt(np.min(np.sum((a[:, None] - b[None]) ** 2, -1), 1))
    return d.mean(), d.max()


def test_make_dataset_same_pixels_and_meta(tmp_path):
    cfg_kw = dict(n_viewpoints=2)
    jsyn.make_dataset(str(tmp_path / "jax"), cfg=jsyn.SynthConfig(**cfg_kw))
    synthetic.make_dataset(str(tmp_path / "port"),
                           cfg=synthetic.SynthConfig(**cfg_kw))
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    ported = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                    for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert files == ported and len(files) == 2 * 20 + 2 * 3 + 8
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".png"):
            want = np.asarray(jio.read_depth(str(a)) if "depth" in rel
                              else jio.read_color(str(a)) if "color" in rel
                              else jio.read_label(str(a)))
            got = (io.read_depth if "depth" in rel else io.read_color
                   if "color" in rel else io.read_label)(str(b))
            np.testing.assert_array_equal(got, want, err_msg=rel)
        else:                           # json, ply, xyz, lists: byte-equal
            assert a.read_bytes() == b.read_bytes(), rel


def test_pixels_to_points_on_the_lattice(roots):
    """The backprojection on the reconstruction's inputs, equal bits: the
    full f32 pixel lattice (the batched path) and the integer pixels of a
    mask (the per-view path), with a view's f32 depth in mm."""
    root = roots["jax"][0]
    run = os.path.join(io.data_dir(root), "ball", "foreground")
    depth = io.read_depth(os.path.join(run, "000002.depth.png")).astype(
        np.float32)
    intr = io.read_sample_meta(os.path.join(run, "000002.meta.json"))[
        "intr"].as_array()
    h, w = depth.shape
    rows, cols = (a.reshape(-1) for a in np.mgrid[:h, :w].astype(np.float32))
    ys, xs = np.nonzero(depth)
    for r, c, z in ((rows, cols, depth.reshape(-1)), (ys, xs, depth[ys, xs])):
        got = projection.pixels_to_points(torch.from_numpy(r),
                                          torch.from_numpy(c),
                                          torch.from_numpy(z),
                                          torch.from_numpy(intr))
        want = jproj.pixels_to_points(jnp.asarray(r), jnp.asarray(c),
                                      jnp.asarray(z), jnp.asarray(intr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_view_distribution_and_surfaces(roots):
    root = roots["jax"][0]
    data = os.path.join(io.data_dir(root), "ball")
    for n, k in ((5, 5), (5, 3)):
        np.testing.assert_array_equal(
            rec.get_view_distribution(data, "foreground", n, k),
            jrec.get_view_distribution(data, "foreground", n, k))
    labels = os.path.join(io.label_dir(root), "ball", "foreground")
    views = []
    for i in range(5):
        meta = io.read_sample_meta(os.path.join(data, "foreground",
                                                f"{i:06d}.meta.json"))
        views.append((io.read_label(os.path.join(labels,
                                                 f"{i:06d}.gen.label.png")),
                      io.read_depth(os.path.join(data, "foreground",
                                                 f"{i:06d}.depth.png")),
                      meta["intr"], io.robot2cam_from_meta(meta)))
    args = (5, 8, 10, 3.0)
    for label, depth, intr, r2c in views[:2]:
        got = rec.get_surface(label, depth.astype(np.float64), intr, r2c,
                              *args, device="cpu")
        want = jrec.get_surface(label, depth.astype(np.float64), intr, r2c,
                                *args)
        assert len(got) == len(want) > 100
        assert mean_and_max_nn(got, want)[1] <= 1e-4
    # the lattice path against the per-view one (robot coordinates rounded
    # to f32 on the device there, in f64 on the host here): same surface
    batched = rec.get_surfaces_batched(*zip(*views), *args, device="cpu")
    for (label, depth, intr, r2c), got in zip(views, batched):
        want = rec.get_surface(label, depth.astype(np.float64), intr, r2c,
                               *args, device="cpu")
        assert abs(len(got) - len(want)) <= 0.02 * len(want)
        assert mean_and_max_nn(got, want)[0] <= 0.05 * 3.0
    positions = rec.get_surface_positions(root, "ball", "foreground", *args[:3],
                                          voxel_size=3.0, device="cpu")
    np.testing.assert_allclose(positions, jrec.get_surface_positions(
        root, "ball", "foreground", *args[:3], voxel_size=3.0), atol=1e-3)


def test_load_point_cloud_against_jax(roots):
    (jroot, jcloud, _), (proot, pcloud, _) = roots["jax"], roots["port"]
    assert len(pcloud) == len(jcloud)
    assert mean_and_max_nn(pcloud, jcloud)[1] <= 1e-3
    for fn in ("ball_out.ply", "ball.ply", "foreground.ply", "ball.xyz",
               "ball_out.pcd", "ball.pcd", "foreground.pcd"):
        got = os.path.join(io.pc_dir(proot), "ball", fn)
        want = os.path.join(io.pc_dir(jroot), "ball", fn)
        read = jio.read_xyz if fn.endswith(".xyz") else (
            jio.read_pcd if fn.endswith(".pcd") else jio.read_ply)
        a, b = read(got), read(want)
        assert len(a) == len(b), fn
        mean, worst = mean_and_max_nn(a, b)
        assert mean <= 1e-3 and worst <= 1e-2, (fn, mean, worst)


def test_create_pose_label_against_jax(roots):
    (jroot, _, jn), (proot, _, pn) = roots["jax"], roots["port"]
    assert pn == jn == 5
    for i in range(5):
        rel = os.path.join("ball", "foreground", f"{i:06d}.meta.json")
        got = io.read_pose_label_meta(os.path.join(io.label_dir(proot), rel))
        want = jio.read_pose_label_meta(os.path.join(io.label_dir(jroot),
                                                     rel))
        assert got["cls_name"] == want["cls_name"] == "ball"
        for key in ("rotation", "cam2robot"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(got["position"], want["position"],
                                   atol=1e-3)
        np.testing.assert_allclose(got["robot2object"], want["robot2object"],
                                   atol=1e-3)


def turned(cloud, degrees, shift):
    a = np.deg2rad(degrees)
    rot = np.asarray([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a),
                                                      0.0], [0.0, 0.0, 1.0]])
    c = cloud.mean(axis=0)
    return (cloud - c) @ rot.T + c + shift


def test_register_canonical_on_a_turned_run_cloud(roots):
    """ICP of a copy of the run cloud turned by 6 degrees about z and
    shifted 2 mm back onto the run cloud. The two packages agree to 2e-5
    for 10 iterations; then, with ~200 correspondences on the 5 mm voxel
    grid, one near-tie correspondence differs between the f32 and the f64
    sums' last bits and moves both results by ~1e-2. So: equal iterations,
    transforms within 0.02 (mm and rotation entries), moved clouds within
    0.05 mm, and the same share of the turn undone (Open3D's 1e-2 criteria
    stop both at ~4.4 of the 6 degrees on this coarse grid)."""
    run = io.read_ply(os.path.join(io.pc_dir(roots["port"][0]), "ball",
                                   "foreground.ply"))
    canonical = turned(run, 6.0, [2.0, 0.0, 0.0])
    tf, moved = pose_labels._register_canonical(canonical, run,
                                                device="cpu")
    jtf, jmoved = jpl._register_canonical(canonical, run)
    np.testing.assert_allclose(tf, jtf, atol=0.02)
    assert moved.shape == jmoved.shape
    np.testing.assert_allclose(moved, jmoved, atol=0.05)
    angle, jangle = (np.rad2deg(np.arctan2(t[1, 0], t[0, 0]))
                     for t in (tf, jtf))
    assert abs(angle - jangle) <= 0.05 and angle < -3.0, (angle, jangle)


def test_device_defaults_to_cuda():
    """The entry points resolve `device=None` to CUDA: without a card they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: rec.load_point_cloud("ball", "none", "none"),
                 lambda: pose_labels.create_pose_label("none", "ball")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_dataset_lists_written(roots):
    ds = io.dataset_dir(roots["port"][0], "pose_estimation", "synth")
    with open(os.path.join(ds, "classes.txt")) as f:
        assert f.read() == "ball\n"
    assert json.loads(json.dumps(io.read_lines(os.path.join(
        ds, "test_data_list.txt")))) == ["ball/foreground/000000"]
