"""The port's host shells of acquisition against the JAX package on the
CPU: the yes/no prompt, the typed configuration, viewpoint paths, the scan
loop with each package's fake camera and robot on the same ring path (PNGs
equal, metas equal, the f32 transforms within 1e-6), the pause gate and
the extra-sample thread, the maintenance scripts on copies of one tree,
`App.acquire_new_data_from_object` with and without `continue_at`, and
both packages failing alike when the menu's acquire has no path."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from autoposeestimation_tpu import config as jconfig
from autoposeestimation_tpu import main as jmain
from autoposeestimation_tpu.acquisition import get_data as jgd
from autoposeestimation_tpu.acquisition import maintenance as jmaint
from autoposeestimation_tpu.acquisition import paths as jpaths
from autoposeestimation_tpu.hardware import camera as jcam
from autoposeestimation_tpu.hardware import robot as jrobot
from autoposeestimation_tpu.pipeline import tui as jtui
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch import config
from autoposeestimation_tpu_torch import main as pmain
from autoposeestimation_tpu_torch.acquisition import get_data as gd
from autoposeestimation_tpu_torch.acquisition import maintenance, paths
from autoposeestimation_tpu_torch.hardware import camera, robot
from autoposeestimation_tpu_torch.pipeline import tui
from autoposeestimation_tpu_torch.utils import io, synthetic
from test_torch_seg_models import two_threads  # noqa: F401

RTOL = 1e-6     # the f32 transforms: XLA's and torch's f32 sin/cos/acos
TRANSFORMS = ("robot2endEff_tf", "object_pose")
OBJECT_POSE = {"a": 90, "b": 0, "c": 180, "x": 5.0, "y": -7.0, "z": 11.0}
HAND_EYE = np.asarray([[0.0, -1.0, 0.0, 30.0], [1.0, 0.0, 0.0, -40.0],
                       [0.0, 0.0, 1.0, 50.0], [0.0, 0.0, 0.0, 1.0]])
PACKAGES = {
    "jax": dict(syn=jsyn, robot=jrobot, cam=jcam, gd=jgd, app=jmain.App,
                maint=jmaint),
    "port": dict(syn=synthetic, robot=robot, cam=camera, gd=gd,
                 app=pmain.App, maint=maintenance),
}


def rig(pkg, n_views=4, move_duration=0.0):
    """A ring of views at 64x48, a fake robot moving through them and a
    fake camera that follows it, all of package `pkg`."""
    m = PACKAGES[pkg]
    cfg = m["syn"].SynthConfig(img_h=48, img_w=64, fx=56.0, fy=56.0,
                               n_viewpoints=n_views)
    cams = m["syn"].ring_cameras(cfg, np.zeros(3))
    ctrl = m["robot"].FakeRobot(fk_fn=m["robot"].ring_fk(cams),
                                move_duration=move_duration)
    cam = m["cam"].FakeDepthCam(cfg=cfg, robot2cam_fn=ctrl.robot2end)
    return cams, ctrl, cam


def tree(root):
    """{relative path: file} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(dirpath, f), root)] = \
                os.path.join(dirpath, f)
    return out


def assert_same_captures(jroot, proot):
    """The two trees hold the same files: PNGs with equal pixels, metas
    equal but for the f32 transforms and the rotation vector, which agree
    within RTOL. Extra samples are left out: their names are capture
    times, and whether the thread catches the robot moving depends on the
    threads' timing, in both packages."""
    jt, pt = ({rel: path for rel, path in tree(root).items()
               if os.sep + "extra" + os.sep not in rel}
              for root in (jroot, proot))
    assert sorted(jt) == sorted(pt)
    for rel in jt:
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pt[rel])),
                                          np.asarray(Image.open(jt[rel])))
        elif rel.endswith(".meta.json"):
            with open(jt[rel]) as f:
                want = json.load(f)
            with open(pt[rel]) as f:
                got = json.load(f)
            assert sorted(got) == sorted(want)
            for key in want:
                if key in TRANSFORMS:
                    np.testing.assert_allclose(got[key], want[key],
                                               rtol=RTOL, atol=RTOL)
                elif key == "pose":
                    assert sorted(got[key]) == sorted(want[key])
                    for k in "xyz":
                        assert got[key][k] == want[key][k]
                    np.testing.assert_allclose(
                        [got[key][k] for k in "abc"],
                        [want[key][k] for k in "abc"], rtol=RTOL, atol=RTOL)
                else:
                    assert got[key] == want[key], key


# --- the prompts and the configuration ---------------------------------------

@pytest.mark.parametrize("answers", [["y"], ["n"], [""], ["q"], ["maybe", "Y"],
                                     ["1"], ["0"], ["true"], ["no"]])
@pytest.mark.parametrize("default", [True, False])
def test_get_true_or_false(answers, default):
    outs = []
    for mod in (jtui, tui):
        asked, said = [], []
        it = iter(answers)
        got = mod.get_true_or_false(
            "go on?", default=default,
            input_fn=lambda q: asked.append(q) or next(it),
            print_fn=said.append)
        outs.append((got, asked, said))
    assert outs[0] == outs[1]


def fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", ["LabelGenConfig", "ReconstructionConfig",
                                  "AcquisitionConfig", "ServingConfig"])
def test_config_defaults(name):
    assert fields(getattr(config, name)()) == fields(getattr(jconfig, name)())


def test_app_config_defaults():
    """Every field equal to the JAX AppConfig's; of the re-exported
    DFConfig, the JAX package's one field the port does not have is
    `dil_s2b` (a TPU re-lowering, not ported)."""
    got, want = fields(config.AppConfig()), fields(jconfig.AppConfig())
    assert sorted(got) == sorted(want)
    for key in want:
        if key in ("segmentation", "pose"):
            g, w = fields(got[key]), fields(want[key])
            assert {k: v for k, v in w.items() if k in g} == g
            assert set(w) - set(g) <= {"dil_s2b"}
        elif key in ("labels", "reconstruction", "acquisition", "serving"):
            assert fields(got[key]) == fields(want[key])
        else:
            assert got[key] == want[key]
    assert config.DFConfig is pmain.dft.DFConfig
    np.testing.assert_array_equal(config.AppConfig().reference_point_array(),
                                  jconfig.AppConfig().reference_point_array())


# --- paths -------------------------------------------------------------------

@pytest.mark.parametrize("n,via", [(1, 0), (5, 0), (12, 1), (4, 3)])
def test_ring_path_and_file(tmp_path, n, via):
    want = jpaths.generate_ring_path(n, n_via=via)
    got = paths.generate_ring_path(n, n_via=via)
    assert got == want
    p = str(tmp_path / "robot" / "viewpointsPath.json")
    paths.save_path(p, got)
    assert jpaths.load_path(p) == got == paths.load_path(p)
    assert gd.load_robot_path(p) == got


def test_record_path():
    """The interactive recorder over the same scripted stations."""
    outs = []
    for pkg, mod in (("jax", jpaths), ("port", paths)):
        _, ctrl, _ = rig(pkg)
        script = iter(["c", "x", "v", "c", "d"])
        said = []

        def answer(_, script=script, ctrl=ctrl):
            cmd = next(script)
            ctrl.move_joints(np.deg2rad([len(said), -90, 0, -90, 0, 0]))
            return cmd
        outs.append((mod.record_path(ctrl, input_fn=answer,
                                     print_fn=said.append), said))
    (want, want_said), (got, got_said) = outs
    assert got_said == want_said
    assert got["joints"] == want["joints"]
    assert got["via_points"] == want["via_points"] == [0, 1, 0]
    for g, w in zip(got["cart_pose"], want["cart_pose"]):
        np.testing.assert_allclose([g[k] for k in "xyzabc"],
                                   [w[k] for k in "xyzabc"], rtol=RTOL,
                                   atol=RTOL)


# --- the scan loop -----------------------------------------------------------

def test_meta_transforms_are_f32_on_the_cpu():
    """Both 4x4s carry f32 rounding, as the JAX package's, within 1e-6 of
    it; the rotation of object_pose is its f32 euler matrix."""
    pose = {"x": 120.5, "y": -330.25, "z": 410.125, "a": 0.3, "b": -2.9,
            "c": 1.1}
    got = gd.robot2end_from_pose(pose)
    want = jgd.robot2end_from_pose(pose)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    got, want = gd.object_pose_tf(OBJECT_POSE), jgd.object_pose_tf(OBJECT_POSE)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(got[:3, 3], [11.0, -7.0, 11.0])
    assert np.array_equal(got[:3, :3], got[:3, :3].astype(np.float32))


def test_get_data_matches_jax(tmp_path):
    """One scan of a 4-view ring with a via point between views, by each
    package with its own fakes."""
    path = paths.generate_ring_path(4, n_via=1)
    roots = {}
    for pkg in ("jax", "port"):
        _, ctrl, cam = rig(pkg)
        roots[pkg] = str(tmp_path / pkg)
        n = PACKAGES[pkg]["gd"].get_data(
            cam, ctrl, path, roots[pkg], "obj", "foreground", OBJECT_POSE,
            symmetric=True, hand_eye_calibration=HAND_EYE, settle=0.0,
            with_extra=False)
        assert n == 4
    assert_same_captures(roots["jax"], roots["port"])
    meta = io.read_sample_meta(os.path.join(
        io.data_dir(roots["port"]), "obj", "foreground", "000002.meta.json"))
    assert meta["symmetric"] == 1 and meta["view_point_id"] == 2
    np.testing.assert_array_equal(meta["hand_eye_calibration"], HAND_EYE)


def test_get_data_waits_for_home(tmp_path):
    _, ctrl, cam = rig("port")
    ctrl.move_joints(np.deg2rad([1.0, -90, 0, -90, 0, 0]))
    assert gd.get_data(cam, ctrl, paths.generate_ring_path(2), str(tmp_path),
                       "obj", "foreground", {}, 0, np.eye(4),
                       settle=0.0) == 0


def test_pause_gate(tmp_path):
    state_path = str(tmp_path / "state.json")
    with open(state_path, "w") as f:
        json.dump({"state": "pause"}, f)

    def release():
        time.sleep(0.3)
        with open(state_path, "w") as f:
            json.dump({"state": "running"}, f)

    t = threading.Thread(target=release)
    t.start()
    t0 = time.time()
    gd.wait_until_running(state_path, poll=0.05)
    t.join(timeout=5)
    assert not t.is_alive() and time.time() - t0 >= 0.25
    with open(state_path, "w") as f:
        f.write("{not json")
    gd.wait_until_running(state_path, poll=0.05)   # unreadable: running
    gd.wait_until_running(str(tmp_path / "absent.json"))


def test_extra_sample_worker(tmp_path):
    _, ctrl, cam = rig("port", n_views=6)
    extra_dir = str(tmp_path / "extra")
    stop = {"flag": False}
    results = {}

    def run():
        results["n"] = gd.extra_sample_worker(
            lambda: stop["flag"], ctrl, cam, extra_dir, OBJECT_POSE, 0,
            HAND_EYE, 1, min_dist_travelled=25.0, poll=0.01)

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.05)
    ctrl.move_joints(np.deg2rad([3, -90, 0, -90, 0, 0]))
    time.sleep(0.15)
    stop["flag"] = True
    t.join(timeout=10)
    assert not t.is_alive() and results["n"] >= 1
    stems = io.list_sample_ids(extra_dir)
    assert len(stems) == results["n"]
    meta = io.read_sample_meta(os.path.join(extra_dir,
                                            stems[0] + ".meta.json"))
    assert meta["view_point_id"] == 1
    np.testing.assert_allclose(meta["object_pose"],
                               gd.object_pose_tf(OBJECT_POSE))


# --- maintenance -------------------------------------------------------------

def write_maintenance_tree(root):
    """An object with a background, a foreground and a turned run, and 11
    extra samples in two bursts 60 s apart: the first in the upright pose
    but for one turned sample, the second turned but for two upright."""
    upright = {"a": 0, "b": 0, "c": 0}
    turned = {"a": 0, "b": 0, "c": 180}
    img = np.zeros((4, 6, 3), np.uint8)
    depth = np.ones((4, 6), np.uint16)
    base = os.path.join(io.data_dir(root), "mug")

    def sample(run, stem, object_pose):
        d = os.path.join(base, run)
        meta = {"joints": [0.0] * 6, "pose": {k: 0.0 for k in "xyzabc"},
                "object_pose": gd.object_pose_tf(object_pose),
                "robot2endEff_tf": np.eye(4), "intr": io.Intrinsics(),
                "depth_scale": 0.001, "symmetric": 0,
                "hand_eye_calibration": np.eye(4), "view_point_id": 0}
        gd.write_sample(d, stem, {"image": img, "depth": depth}, meta)

    for i in range(2):
        sample("background", f"{i:06d}", upright)
        sample("foreground", f"{i:06d}", upright)
        sample("foreground180", f"{i:06d}", turned)
    for i in range(5):
        sample("extra", f"{1000.0 + 0.5 * i}", turned if i == 2 else upright)
    for i in range(6):
        sample("extra", f"{1060.0 + 0.5 * i}",
               upright if i in (1, 4) else turned)


def test_fix_symmetric_and_clean_extra_data(tmp_path):
    roots = {pkg: str(tmp_path / pkg) for pkg in PACKAGES}
    write_maintenance_tree(roots["jax"])
    shutil.copytree(roots["jax"], roots["port"])
    outs = {}
    for pkg, root in roots.items():
        m = PACKAGES[pkg]["maint"]
        outs[pkg] = (m.clean_extra_data(root, "mug"),
                     m.fix_symmetric(root, "mug", symmetric=1),
                     m.clean_extra_data(root, "absent"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == {"kept": 8, "deleted": 3}
    assert outs["port"][1] == 14
    jt, pt = tree(roots["jax"]), tree(roots["port"])
    assert sorted(jt) == sorted(pt)
    for rel in jt:
        if rel.endswith(".json"):
            with open(jt[rel]) as f, open(pt[rel]) as g:
                assert json.load(g) == json.load(f)
                assert json.load(open(pt[rel]))["symmetric"] == 1


# --- the App -----------------------------------------------------------------

def acquire(pkg, root, **kw):
    """App.acquire_new_data_from_object of package `pkg` with its fakes
    on a 2-view ring; returns (count, printed lines, prompts)."""
    _, ctrl, cam = rig(pkg, n_views=2)
    said, asked = [], []
    app = PACKAGES[pkg]["app"](
        root, camera_factory=lambda: cam, controller_factory=lambda: ctrl,
        input_fn=lambda q: asked.append(q) or "mug", print_fn=said.append)
    n = app.acquire_new_data_from_object(
        path_data=paths.generate_ring_path(2), **kw)
    return n, said, asked


@pytest.mark.parametrize("kw", [{}, {"with_turns": True,
                                     "continue_at": "foreground90_2"}])
def test_app_acquire(tmp_path, kw):
    """The default background + foreground scan, and the scan of
    turns resumed at a named run, with a hand-eye file in the workspace."""
    outs = {}
    for pkg in PACKAGES:
        root = str(tmp_path / pkg)
        pmain.hand_eye.save_hand_eye(os.path.join(
            root, "hand_eye_calibration", "data", "handEye_tf.json"),
            HAND_EYE)
        outs[pkg] = acquire(pkg, root, **kw)
    assert outs["port"] == outs["jax"]
    n, said, asked = outs["port"]
    assert asked == ["object name> "]
    runs = io.list_runs(str(tmp_path / "port"), "mug")
    if kw:
        assert n == 4 and said[0].startswith("place/turn object for run "
                                             "'foreground90_2'")
        assert [r for r in runs if r != "extra"] == ["foreground90_2",
                                                     "foreground90_3"]
    else:
        assert n == 4 and [r for r in runs if r != "extra"] == [
            "background", "foreground"]
    for run in runs:
        if run == "extra":
            continue
        meta = io.read_sample_meta(os.path.join(
            io.data_dir(str(tmp_path / "port")), "mug", run,
            "000000.meta.json"))
        np.testing.assert_array_equal(meta["hand_eye_calibration"], HAND_EYE)
    assert_same_captures(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_acquire_without_a_path_fails_in_both(tmp_path):
    """The menu calls acquire_new_data_from_object() with no path, so
    `path_data` is None: both packages raise the same error, and the menu
    prints it and goes on."""
    errors = []
    for pkg in PACKAGES:
        _, ctrl, cam = rig(pkg, n_views=2)
        app = PACKAGES[pkg]["app"](
            str(tmp_path / pkg), camera_factory=lambda: cam,
            controller_factory=lambda: ctrl, input_fn=lambda q: "mug",
            print_fn=lambda s: None)
        with pytest.raises(TypeError) as exc:
            app.acquire_new_data_from_object()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    menus = []
    for pkg in PACKAGES:
        _, ctrl, cam = rig(pkg, n_views=2)
        script = iter(["0", "mug", "10"])
        said = []
        PACKAGES[pkg]["app"](
            str(tmp_path / ("menu_" + pkg)), camera_factory=lambda: cam,
            controller_factory=lambda: ctrl,
            input_fn=lambda q: next(script), print_fn=said.append).main()
        menus.append(said)
    assert menus[0] == menus[1]
    assert menus[1].count(f"action failed: {errors[1]}") == 1


def test_main_module_runs_the_menu(tmp_path):
    """`python -m autoposeestimation_tpu_torch.main --root W --device cpu`
    shows the menu and quits; without a card the default device raises
    before the menu."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "autoposeestimation_tpu_torch.main",
           "--root", str(tmp_path)]
    res = subprocess.run(cmd + ["--device", "cpu"], input="10\n", cwd=root,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "Select action:" and lines[11] == "  [10] quit"
    res = subprocess.run(cmd, input="10\n", cwd=root, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode != 0 and "device='cpu'" in res.stderr
