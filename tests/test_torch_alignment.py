"""The reconstruction across runs against the JAX package on the CPU:
`align_point_clouds` on two and on three sphere clouds (40 mm, 2,500-3,000
points, offset by 10 and -45 mm in y), and `create_pose_label` with a run
turned by 180 degrees about the vertical axis and an `extra` run in that
pose, written as `chip_smoke.py` phase 13 writes them (the renderer's
spheres moved, `object_pose` set to the turn).

The JAX side finds ICP correspondences through the TPU kernel's function,
`nn_pallas(interpret=True)`, as the port does; ICP's sums are f32 there
and f64 in the port. Clouds: equal point counts, within 1e-3 mm point for
point, for each run's cloud; the cross-run merge within the looser bound
that `test_clouds_across_runs` states. Pose labels, computed by the port
from the JAX package's clouds: the camera transform equal; the untouched
run's position within 1e-3 mm; the turned and extra runs' rotation and
position within 0.02 (the canonical-cloud ICP on the 5 mm grid, where one
near-tie correspondence can move both results by ~1e-2; tests/
test_torch_reconstruction.py::test_register_canonical_on_a_turned_run_cloud
measures it)."""
import functools
import os
import shutil

import jax
import numpy as np
import pytest

import chip_smoke
from autoposeestimation_tpu.labeling import pose_labels as jpl
from autoposeestimation_tpu.ops import knn as jknn
from autoposeestimation_tpu.reconstruction import create_pointcloud as jrec
from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.labeling import pose_labels
from autoposeestimation_tpu_torch.reconstruction import create_pointcloud as rec
from autoposeestimation_tpu_torch.utils import io, synthetic
from test_torch_seg_models import two_threads  # noqa: F401

CLOUD_ATOL = 1e-3     # mm
TURN_ATOL = 0.02
SETTINGS = dict(mode="gen", n_viewpoints=5, min_friends=5, min_dist=8,
                nb_neighbors=10, threshold=10, voxel_size=3,
                voxel_size_out=6, icp_point2plane=False)
OFFSETS = (0.0, 10.0, -45.0)


@pytest.fixture(scope="module", autouse=True)
def jax_nn_is_the_kernel():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "nn", functools.partial(jknn.nn_pallas,
                                                 interpret=True))
        jax.clear_caches()
        yield
    jax.clear_caches()


def sphere_cloud(seed, offset_y):
    rng = np.random.default_rng(seed)
    n = 2500 + 250 * seed
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = 40.0 * u + rng.normal(scale=0.3, size=(n, 3))
    return pts + np.asarray([0.0, offset_y, 40.0])


def max_nn(a, b):
    return float(np.sqrt(np.min(np.sum((a[:, None] - b[None]) ** 2, -1),
                                1)).max())


@pytest.mark.parametrize("runs", [(0, 1), (0, 2), (0, 1, 2)])
def test_align_point_clouds(runs):
    clouds = [sphere_cloud(i, OFFSETS[i]) for i in runs]
    args = (10, 10.0, 5)
    got = rec.align_point_clouds(clouds, *args, device="cpu")
    want = jrec.align_point_clouds(clouds, *args)
    assert len(got) == len(want) > 300
    assert max_nn(got, want) <= CLOUD_ATOL and max_nn(want, got) <= CLOUD_ATOL


def ball(pkg):
    return pkg.SphereObject("ball", np.asarray([30.0, 10.0, 40.0]), 40.0,
                            (210, 50, 50), parts=(((25.0, 25.0, 25.0), 18.0),))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("turned")
    cfg = jsyn.SynthConfig(n_viewpoints=5)
    jsyn.make_dataset(str(base / "jax"), objects=[ball(jsyn)], cfg=cfg)
    pose = chip_smoke.turn_pose()
    turned = chip_smoke.turned_object(ball(synthetic), pose)
    port_cfg = synthetic.SynthConfig(n_viewpoints=5)
    chip_smoke.write_run(str(base / "jax"), turned, "foreground180",
                         port_cfg, pose)
    chip_smoke.write_run(str(base / "jax"), turned, "extra",
                         synthetic.SynthConfig(n_viewpoints=3,
                                               ring_height=300.0), pose)
    shutil.copytree(base / "jax", base / "port")
    out = {}
    for name, load, label, kw in (
            ("jax", jrec.load_point_cloud, jpl.create_pose_label, {}),
            ("port", rec.load_point_cloud, pose_labels.create_pose_label,
             {"device": "cpu"})):
        root = str(base / name)
        cloud = load("ball", jio.pc_dir(root), root, **SETTINGS, **kw)
        written = label(root, "ball", with_extra=True, **kw)
        out[name] = (root, cloud, written)
    # the port's pose labels from the JAX package's clouds
    shutil.copytree(base / "port", base / "labels")
    shutil.rmtree(jio.pc_dir(str(base / "labels")))
    shutil.copytree(jio.pc_dir(str(base / "jax")),
                    jio.pc_dir(str(base / "labels")))
    root = str(base / "labels")
    out["labels"] = (root, None, pose_labels.create_pose_label(
        root, "ball", with_extra=True, device="cpu"))
    return out


def test_turned_part_moved():
    pose = chip_smoke.turn_pose()
    turned = chip_smoke.turned_object(ball(synthetic), pose)
    np.testing.assert_allclose(turned.parts[0][0], (-25.0, -25.0, 25.0),
                               atol=1e-5)
    np.testing.assert_allclose(pose[:3, :3], np.diag([-1.0, -1.0, 1.0]),
                               atol=1e-7)


def test_clouds_across_runs(roots):
    """Each run's cloud within 1e-3 mm. Across the runs, the cross-run ICP
    (f32 sums in the JAX package, f64 in the port) converges ~1e-2 apart
    on this coarse grid, so the merged, voxel-downsampled and cleaned cloud
    keeps a few other points: counts within 1 % and 97 % of the points
    within 0.05 mm of the other package's (measured: 1037 against 1041
    points, 98.4 % and 98.0 %), a mean within 0.05 mm."""
    jroot, proot = roots["jax"][0], roots["port"][0]
    for fn in ("foreground.ply", "foreground180.ply"):
        a = io.read_ply(os.path.join(io.pc_dir(proot), "ball", fn))
        b = jio.read_ply(os.path.join(io.pc_dir(jroot), "ball", fn))
        assert len(a) == len(b) > 100, fn
        assert max_nn(a, b) <= CLOUD_ATOL, fn
    a = io.read_ply(os.path.join(io.pc_dir(proot), "ball", "ball_out.ply"))
    b = jio.read_ply(os.path.join(io.pc_dir(jroot), "ball", "ball_out.ply"))
    assert abs(len(a) - len(b)) <= 0.01 * len(b)
    for x, y in ((a, b), (b, a)):
        d = np.sqrt(np.min(np.sum((x[:, None] - y[None]) ** 2, -1), 1))
        assert np.mean(d <= 0.05) >= 0.97 and d.mean() <= 0.05
    assert not os.path.exists(os.path.join(io.pc_dir(proot), "ball",
                                           "extra.ply"))


def test_pose_labels_with_turned_and_extra_runs(roots):
    """The port's labels from the JAX package's clouds against the JAX
    labels."""
    (jroot, _, jn), (proot, _, pn) = roots["jax"], roots["labels"]
    assert pn == jn == roots["port"][2] == 5 + 5 + 3
    for run, n in (("foreground", 5), ("foreground180", 5), ("extra", 3)):
        for i in range(n):
            rel = os.path.join("ball", run, f"{i:06d}.meta.json")
            got = io.read_pose_label_meta(os.path.join(io.label_dir(proot),
                                                       rel))
            want = jio.read_pose_label_meta(os.path.join(io.label_dir(jroot),
                                                         rel))
            np.testing.assert_array_equal(got["cam2robot"],
                                          want["cam2robot"])
            atol = CLOUD_ATOL if run == "foreground" else TURN_ATOL
            for key in ("position", "robot2object"):
                np.testing.assert_allclose(got[key], want[key], atol=atol,
                                           err_msg=f"{rel} {key}")
            if run == "foreground":
                np.testing.assert_array_equal(got["rotation"],
                                              want["rotation"])
            else:
                np.testing.assert_allclose(got["rotation"], want["rotation"],
                                           atol=TURN_ATOL)
                # the turn is in the label: about 180 degrees about z
                r = got["robot2object"][:3, :3]
                assert r[0, 0] < -0.95 and r[1, 1] < -0.95, rel
    # the extra run reuses the turned run's pose
    a = io.read_pose_label_meta(os.path.join(io.label_dir(proot), "ball",
                                             "extra", "000000.meta.json"))
    b = io.read_pose_label_meta(os.path.join(io.label_dir(proot), "ball",
                                             "foreground180",
                                             "000000.meta.json"))
    np.testing.assert_array_equal(a["robot2object"], b["robot2object"])
