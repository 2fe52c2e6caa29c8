"""The serving consumers, port against the JAX package on the CPU: the
rotation-vector transforms (within 1e-6, angles near 0 and near pi
included), `get_robot2object`, `FakeRobot`, `FakeDepthCam`,
`PlaybackDepthCam`, the hand-eye file, the slideshows, the grasp sequence
with a stubbed predictor, the multi-view prediction with real (small)
models, grasp teaching and `App.run_live_prediction(device="cpu")` in both
modes."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu import main as jmain
from autoposeestimation_tpu.hardware import camera as jcamera
from autoposeestimation_tpu.hardware import hand_eye as jhand_eye
from autoposeestimation_tpu.hardware import robot as jrobot
from autoposeestimation_tpu.pipeline import grasping as jgrasping
from autoposeestimation_tpu.pipeline import predict as jpredict
from autoposeestimation_tpu.pipeline import visualize as jviz
from autoposeestimation_tpu.utils import synthetic as jsynth
from autoposeestimation_tpu.utils import transforms as JT
from autoposeestimation_tpu_torch import main
from autoposeestimation_tpu_torch.hardware import camera, hand_eye, robot
from autoposeestimation_tpu_torch.pipeline import grasping, predict
from autoposeestimation_tpu_torch.pipeline import visualize as viz
from autoposeestimation_tpu_torch.utils import synthetic
from autoposeestimation_tpu_torch.utils import transforms as T

TF_ATOL = 1e-6
H, W = 96, 128


def rotvecs(seed):
    """Seeded rotation vectors, with angles 0, 1e-9, 1e-6 and pi - 1e-3,
    pi exactly among them."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(-np.pi, np.pi, 7),
                             [0.0, 1e-9, 1e-6, np.pi - 1e-3, np.pi]])
    return (axes * angles[:, None]).astype(np.float32)


def both(fn_name, *args):
    """(port, JAX) results of one transform on the same f32 inputs."""
    got = getattr(T, fn_name)(*[torch.as_tensor(a) for a in args]).numpy()
    want = np.asarray(getattr(JT, fn_name)(*[jnp.asarray(a) for a in args]))
    return got, want


@pytest.mark.parametrize("fn_name", ["quat_conjugate", "axangle_to_mat",
                                     "rotvec_to_mat", "mat_to_rotvec"])
@pytest.mark.parametrize("seed", [0, 1])
def test_transforms_match_jax(fn_name, seed):
    rng = np.random.default_rng(seed + 10)
    rv = rotvecs(seed)
    if fn_name == "quat_conjugate":
        args = (rng.normal(size=(12, 4)).astype(np.float32),)
    elif fn_name == "axangle_to_mat":
        args = ((rng.normal(size=(12, 3)) * 2).astype(np.float32),
                np.linalg.norm(rv, axis=1).astype(np.float32))
    elif fn_name == "rotvec_to_mat":
        args = (rv,)
    else:
        args = (np.array(JT.rotvec_to_mat(jnp.asarray(rv))),)
    got, want = both(fn_name, *args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TF_ATOL)
    if fn_name == "mat_to_rotvec":     # and back to the same rotation
        np.testing.assert_allclose(
            T.rotvec_to_mat(torch.as_tensor(got)).numpy(), args[0],
            atol=1e-5)


class PoseController:
    """A controller that reports one fixed end-effector pose (mm)."""

    def __init__(self, pose):
        self.pose = pose

    def get_pose(self, return_mm=True):
        return dict(self.pose)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_robot2object_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rv = rotvecs(seed)[[seed, 7 + seed]]
    end2cam = np.eye(4)
    end2cam[:3, :3] = np.asarray(JT.rotvec_to_mat(jnp.asarray(rv[1])))
    end2cam[:3, 3] = rng.normal(size=3) * 50
    pose = dict(zip("xyzabc", [*(rng.normal(size=3) * 300),
                               *rv[0].astype(float)]))

    def prediction():
        preds = {}
        for cls in ("mug", "box", "cup"):
            q = rng.normal(size=4).astype(np.float32)
            preds[cls] = {"position": (rng.normal(size=3) * 0.1 + [0, 0, 0.5]
                                       ).astype(np.float32),
                          "rotation": q / np.linalg.norm(q),
                          "mask": np.zeros((4, 4), np.uint8)}
        return {"predictions": preds}

    pred = prediction()
    jpred = {"predictions": {c: dict(p) for c, p in
                             pred["predictions"].items()}}
    got = predict.get_robot2object(pred, PoseController(pose), end2cam)
    want = jpredict.get_robot2object(jpred, PoseController(pose), end2cam)
    assert got is pred
    for cls, p in want["predictions"].items():
        q = got["predictions"][cls]
        assert q["position"].dtype == p["position"].dtype == np.float64
        assert q["rotation"].dtype == np.float32
        np.testing.assert_allclose(q["position"], p["position"],
                                   atol=TF_ATOL)
        np.testing.assert_allclose(q["rotation"], p["rotation"],
                                   atol=TF_ATOL)
    empty = {"predictions": {}}
    assert predict.get_robot2object(empty, None, end2cam) is empty


def ring(n=4, img_hw=(H, W)):
    cfg = synthetic.SynthConfig(img_h=img_hw[0], img_w=img_hw[1], fx=120.0,
                                fy=120.0, n_viewpoints=n)
    return cfg, synthetic.ring_cameras(cfg, np.zeros(3))


def test_fake_robot_matches_jax():
    _, cams = ring()
    he = np.eye(4)
    he[:3, 3] = [10.0, -5.0, 30.0]
    port = robot.FakeRobot(fk_fn=robot.ring_fk(cams, he))
    ref = jrobot.FakeRobot(fk_fn=jrobot.ring_fk(cams, he))
    assert port.is_home() and ref.is_home()
    for joints in ([1.0, -90, 0, -90, 0, 0], [2.0, 10, 20, 30, 40, 50],
                   [-57.0, -125.5, -60.9, -102.5, 40.5, 27.3]):
        for r in (port, ref):
            r.move_joints(np.deg2rad(joints))
        assert port.at_target(joints) and not port.is_home()
        for mm in (True, False):
            got, want = port.get_pose(return_mm=mm), ref.get_pose(return_mm=mm)
            assert set(got) == set(want)
            for name in got:
                np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                           atol=TF_ATOL)
        np.testing.assert_array_equal(port.robot2end(), ref.robot2end())
    target = {"x": 1.0, "y": 2.0, "z": 3.0, "a": 0.0, "b": 0.0, "c": 0.0}
    for r in (port, ref):
        r.move_to_pose(target)
        r.close_gripper()
        r.open_gripper()
    assert port.get_pose() == ref.get_pose() == target
    assert [h[0] for h in port.history] == [h[0] for h in ref.history]
    assert port.get_joints("rad").tolist() == ref.get_joints("rad").tolist()
    assert port.get_joints("other") == -1


def test_fake_depth_cam_matches_jax():
    cfg, cams = ring()
    jcfg = jsynth.SynthConfig(img_h=H, img_w=W, fx=120.0, fy=120.0,
                              n_viewpoints=4)
    sphere = ("obj", np.asarray([30.0, 10.0, 40.0]), 40.0, (210, 50, 50))
    port = camera.FakeDepthCam(cfg=cfg, spheres=[synthetic.SphereObject(
        *sphere)], robot2cam_fn=lambda: cams[1], fail_every=3)
    ref = jcamera.FakeDepthCam(cfg=jcfg, spheres=[jsynth.SphereObject(
        *sphere)], robot2cam_fn=lambda: cams[1], fail_every=3)
    for _ in range(4):
        got, want = port.get_frames(), ref.get_frames()
        assert (got is None) == (want is None)
        if got is not None:
            assert got["depth"].dtype == np.uint16
            for name in ("image", "depth"):
                np.testing.assert_array_equal(got[name], want[name])
    assert port.get_frames() is not None
    assert port.get_frames(with_repair=True) is not None   # the 6th fails
    assert port.repairs == 1
    assert port.get_intrinsics().to_dict() == ref.get_intrinsics().to_dict()
    assert port.get_depth_scale() == ref.get_depth_scale()
    assert not port.check_state(3)
    assert port.stream(max_frames=2, show=lambda f: None) == 2


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_ds"))
    synthetic.make_dataset(root, objects=[synthetic.SphereObject(
        "ball", np.asarray([0.0, 0.0, 30.0]), 30.0, (200, 0, 0))],
        cfg=synthetic.SynthConfig(n_viewpoints=3))
    return root


def test_playback_cam_and_slideshows_match_jax(dataset_root):
    run_dir = os.path.join(dataset_root, "data_generation", "data", "ball",
                           "foreground")
    port = camera.PlaybackDepthCam(run_dir, loop=False)
    ref = jcamera.PlaybackDepthCam(run_dir, loop=False)
    assert port.get_intrinsics().to_dict() == ref.get_intrinsics().to_dict()
    assert port.get_depth_scale() == ref.get_depth_scale()
    for _ in range(3):
        got, want = port.get_frames(), ref.get_frames()
        for name in ("image", "depth"):
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    assert port.get_frames() is None
    looped = camera.PlaybackDepthCam(run_dir)
    first = looped.get_frames()["image"]
    for _ in range(3):
        again = looped.get_frames()["image"]
    np.testing.assert_array_equal(again, first)
    empty = os.path.join(dataset_root, "empty_run")
    os.makedirs(empty)
    with pytest.raises(ValueError, match="no samples"):
        camera.PlaybackDepthCam(empty)

    for kind in ("visualise_segmentation_masks", "visualise_pose_labels"):
        got = list(getattr(viz, kind)(dataset_root, "ball", "foreground"))
        want = list(getattr(jviz, kind)(dataset_root, "ball", "foreground"))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        token = viz.CancellationToken()
        token.listen(input_fn=lambda _: "").join(timeout=10)
        assert token.cancelled
        assert list(getattr(viz, kind)(dataset_root, "ball", "foreground",
                                       token=token)) == []


def test_hand_eye_file_round_trip(tmp_path):
    tf = np.arange(16, dtype=np.float64).reshape(4, 4) / 7.0
    path = str(tmp_path / "hand_eye_calibration" / "data" / "handEye_tf.json")
    hand_eye.save_hand_eye(path, tf)
    np.testing.assert_array_equal(jhand_eye.load_hand_eye(path), tf)
    np.testing.assert_array_equal(hand_eye.load_hand_eye(path), tf)
    assert np.array_equal(main.App(str(tmp_path))._load_hand_eye(), tf)
    assert np.array_equal(main.App(str(tmp_path / "none"))._load_hand_eye(),
                          np.eye(4))
    assert main.COLOR_DICT == jmain.COLOR_DICT
    np.testing.assert_array_equal(main.REFERENCE_POINT, jmain.REFERENCE_POINT)
    assert grasping.CONSTRAINTS == jgrasping.CONSTRAINTS


def test_execute_grasp_sequence(tmp_path, monkeypatch):
    """The whole grasp with a stubbed predictor, as the JAX package's
    test does: approach, descend, close, lift, return, open."""
    root = str(tmp_path)
    c = grasping.CONSTRAINTS
    inside = np.asarray([(c["max_x"] + c["min_x"]) / 2,
                         (c["max_y"] + c["min_y"]) / 2,
                         (c["max_z"] + c["min_z"]) / 2])
    grasping.save_grasping_delta(root, "ds", "mug", inside, [1, 0, 0, 0],
                                 {"x": inside[0], "y": inside[1],
                                  "z": inside[2], "a": 0.0, "b": 0.0,
                                  "c": 0.0})
    calls = []

    def fake_full_prediction(image, depth, meta, models, **kw):
        calls.append(meta["depth_scale"])
        return {"predictions": {"mug": {
            "mask": np.zeros((8, 8), np.uint8), "position": inside.copy(),
            "rotation": np.asarray([1.0, 0, 0, 0])}}, "elapsed_times": {}}

    monkeypatch.setattr(predict, "full_prediction", fake_full_prediction)
    monkeypatch.setattr(predict, "get_robot2object",
                        lambda prediction, controller, end2cam: prediction)
    cfg, cams = ring(img_hw=(8, 8))
    cam = camera.FakeDepthCam(cfg=cfg)
    fr = robot.FakeRobot()
    assert not grasping.execute_grasp(fr, cam, np.eye(4), None, root, "ds",
                                      "mug", poll=0.0)   # not at grasp_pos
    assert grasping.move_to_grasp_position(fr, poll=0.0)
    assert grasping.execute_grasp(fr, cam, np.eye(4), None, root, "ds",
                                  "mug", confirm=lambda m: True, poll=0.0)
    assert len(calls) == len(c["view_points"])
    assert [h[1] for h in fr.history if h[0] == "gripper"] == ["close",
                                                               "open"]
    assert fr.at_target(c["grasp_pos"][1])
    assert not grasping.execute_grasp(fr, cam, np.eye(4), None, root, "ds",
                                      "box", poll=0.0)   # nothing taught
    assert grasping.move_home(fr, poll=0.0) and fr.is_home()


def small_models(classes=("obj",)):
    rng = np.random.default_rng(0)
    return predict.build_models(
        len(classes), rng.normal(size=(len(classes), 60, 3)) * 0.05, classes,
        num_points=64, crop=32, refine_iters=1, dtype=torch.float32,
        device="cpu")


def sphere_cam(robot2cam_fn=None):
    cfg, cams = ring()
    return camera.FakeDepthCam(cfg=cfg, spheres=[synthetic.SphereObject(
        "obj", np.asarray([30.0, 10.0, 40.0]), 40.0, (210, 50, 50))],
        robot2cam_fn=robot2cam_fn)


def test_get_predictions_in_the_robot_frame(monkeypatch):
    """The five views with real models on the CPU, the camera following
    the robot: every view's poses go through `get_robot2object`, and the
    average keeps the classes every view saw."""
    _, cams = ring()
    he = np.eye(4)
    fr = robot.FakeRobot(fk_fn=robot.ring_fk(cams, he))
    cam = sphere_cam(lambda: fr.robot2end() @ he)
    seen = []
    real = predict.get_robot2object

    def spy(prediction, controller, end2cam):
        seen.append({c: dict(p) for c, p in prediction["predictions"].items()})
        return real(prediction, controller, end2cam)

    models = small_models()
    assert grasping.get_predictions(fr, cam, he, models, poll=0.0) == (
        False, {})
    assert grasping.move_to_grasp_position(fr, poll=0.0)
    monkeypatch.setattr(predict, "get_robot2object", spy)
    ok, final = grasping.get_predictions(fr, cam, he, models, poll=0.0)
    assert ok and len(seen) == 5
    assert fr.at_target(grasping.CONSTRAINTS["grasp_pos"][1])
    for cls, p in final.items():
        assert np.isfinite(p["position"]).all()
        assert np.isfinite(p["rotation"]).all()
        assert all(cls in view for view in seen)


def test_teach_grasping_matches_jax(tmp_path):
    pose = {"x": 0.1, "y": -0.7, "z": 0.05, "a": 3.1, "b": 0.2, "c": -0.1}
    pred = {"position": np.asarray([0.01, -0.75, 0.02]),
            "rotation": np.asarray([1.0, 0.0, 0.0, 0.0])}
    for app_cls, sub in ((main.App, "port"), (jmain.App, "jax")):
        app_cls(str(tmp_path / sub),
                controller_factory=lambda: PoseController(pose)
                ).teach_grasping("ds", "mug", pred)
    got = grasping.load_grasping_deltas(str(tmp_path / "port"), "ds")
    assert got == grasping.load_grasping_deltas(str(tmp_path / "jax"), "ds")
    assert got["mug"]["robot_pose"] == pose


@pytest.mark.parametrize("pipelined", [False, True])
def test_run_live_prediction(tmp_path, pipelined):
    """The live loop over a FakeDepthCam (uint16 depth) on the CPU, one
    `fps:` line and one callback a frame, blocking or through
    `serve_stream` at batch 2 with 2 calls in flight."""
    lines, seen = [], []
    app = main.App(str(tmp_path), camera_factory=sphere_cam,
                   input_fn=lambda _: "0", print_fn=lines.append)
    n_frames = 3 if pipelined else 2
    n = app.run_live_prediction(
        max_frames=n_frames, models=small_models(), pipelined=pipelined,
        in_flight=2, batch=2, device="cpu",
        frame_callback=lambda fr, out: seen.append((fr, out)))
    assert n == n_frames == len(seen) == len(lines)
    assert all(line.startswith("fps:") for line in lines)
    for fr, out in seen:
        assert fr["depth"].dtype == np.uint16
        assert set(out["predictions"]) <= {"obj"}
