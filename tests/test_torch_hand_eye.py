"""The port's hand-eye calibration against the JAX package on the CPU: the
rotation log, the AX = XB solver and `calibrate_hand_eye` bit for bit on
20 seeded motion sets (with a motion of angle 0 and one near pi),
`collect_and_calibrate` on ChArUco boards rendered by cv2 through each
package's fake robot, and the poses yaml and handEye_tf.json files (the
tests of what needs OpenCV skip without it)."""
import numpy as np
import pytest

from autoposeestimation_tpu.hardware import camera as jcam
from autoposeestimation_tpu.hardware import hand_eye as jhe
from autoposeestimation_tpu.hardware import robot as jrobot
from autoposeestimation_tpu_torch.hardware import camera, hand_eye, robot
from autoposeestimation_tpu_torch.utils import io


def rotation(axis, angle):
    """Rodrigues' rotation about `axis` by `angle` (f64)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def rigid(rot, trans):
    tf = np.eye(4)
    tf[:3, :3], tf[:3, 3] = rot, trans
    return tf


def euler(ai, aj, ak):
    """Static-frame XYZ euler angles -> rotation, f64."""
    return rotation([0, 0, 1], ak) @ rotation([0, 1, 0], aj) \
        @ rotation([1, 0, 0], ai)


def motion_set(seed, n=8):
    """Robot poses and the camera's board poses of a known X. Seed 0 holds
    two equal consecutive rotations (a motion of angle 0), seed 1 a motion
    of pi - 1e-6."""
    rng = np.random.default_rng(seed)
    x = rigid(euler(*rng.uniform(-1, 1, 3)), rng.uniform(-60, 60, 3))
    board = rigid(euler(*rng.uniform(-0.5, 0.5, 3)), [300.0, 100.0, 10.0])
    ends = [rigid(euler(*rng.uniform(-0.8, 0.8, 3)),
                  rng.uniform(-300, 300, 3)) for _ in range(n)]
    if seed == 0:
        ends[3][:3, :3] = ends[2][:3, :3]
    if seed == 1:
        ends[5][:3, :3] = ends[4][:3, :3] @ rotation(rng.normal(size=3),
                                                     np.pi - 1e-6)
    cams = [np.linalg.inv(e @ x) @ board for e in ends]
    return ends, cams, x


@pytest.mark.parametrize("seed", range(20))
def test_solver_bit_for_bit(seed):
    ends, cams, x = motion_set(seed)
    for e0, e1 in zip(ends, ends[1:]):
        rel = np.linalg.inv(e0) @ e1
        np.testing.assert_array_equal(hand_eye._log_so3(rel[:3, :3]),
                                      jhe._log_so3(rel[:3, :3]))
    a = [np.linalg.inv(e0) @ e1 for e0, e1 in zip(ends, ends[1:])]
    b = [c0 @ np.linalg.inv(c1) for c0, c1 in zip(cams, cams[1:])]
    np.testing.assert_array_equal(hand_eye.solve_ax_xb(a, b),
                                  jhe.solve_ax_xb(a, b))
    got = hand_eye.calibrate_hand_eye(ends, cams)
    np.testing.assert_array_equal(got, jhe.calibrate_hand_eye(ends, cams))
    np.testing.assert_allclose(got, x, atol=1e-6)


def test_log_so3_edges():
    for rot in (np.eye(3), rotation([0, 0, 1], np.pi),
                rotation([1, 2, 3], np.pi - 1e-9), rotation([1, 0, 0], 1e-11)):
        np.testing.assert_array_equal(hand_eye._log_so3(rot),
                                      jhe._log_so3(rot))


def board_rig(cv2, cam_mod, robot_mod, x, board_in_robot, stations):
    """A fake robot through `stations` end poses and a camera that renders
    the ChArUco board (cv2) as the end-effector's camera sees it."""
    board, _ = hand_eye.get_board()
    base = board.generateImage((800, 920), marginSize=40)
    corners, ids, _, _ = cv2.aruco.CharucoDetector(board).detectBoard(base)
    obj_pts, img_pts = board.matchImagePoints(corners, ids)
    h_base, _ = cv2.findHomography(obj_pts.reshape(-1, 3)[:, :2],
                                   img_pts.reshape(-1, 2))
    intr = io.Intrinsics(width=640, height=480, ppx=320.0, ppy=240.0,
                         fx=600.0, fy=600.0, coeffs=[0.0] * 5)
    k_mat = np.asarray([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]])
    ctrl = robot_mod.FakeRobot(
        fk_fn=lambda j: stations[int(round(j[0])) % len(stations)])

    class BoardCam(cam_mod.DepthCamBase):
        def get_intrinsics(self):
            return intr

        def get_frames(self, with_repair=False, secure_image=False):
            c2b = np.linalg.inv(ctrl.robot2end() @ x) @ board_in_robot
            m = k_mat @ np.column_stack([c2b[:3, 0], c2b[:3, 1], c2b[:3, 3]])
            m = m @ np.linalg.inv(h_base)
            img = cv2.warpPerspective(base, m / m[2, 2], (640, 480),
                                      borderValue=255)
            return {"image": np.stack([img] * 3, axis=-1),
                    "depth": np.zeros((480, 640), np.uint16)}

    return BoardCam(), ctrl


def test_collect_and_calibrate_against_jax(tmp_path):
    """The collection flow of each package with its own fake robot (the
    JAX one's rotation vectors come from XLA, the port's from torch, both
    in f32) on the same rendered boards: the same stations, X within
    1e-5 of JAX's and near the truth."""
    cv2 = pytest.importorskip("cv2")
    x = rigid(euler(0.06, -0.1, 0.15), [30.0, -40.0, 50.0])
    board_in_robot = rigid(euler(0.05, 0.02, 0.4), [300.0, 100.0, 10.0])
    rng = np.random.default_rng(2)
    stations = []
    for _ in range(10):
        c = rigid(euler(*rng.uniform([-0.45, -0.45, -0.6], [0.45, 0.45, 0.6])),
                  [rng.uniform(-60, 10), rng.uniform(-60, 10),
                   rng.uniform(240, 380)])
        stations.append(board_in_robot @ np.linalg.inv(c) @ np.linalg.inv(x))
    targets = [np.deg2rad([i, 0, 0, 0, 0, 0]) for i in range(len(stations))]
    outs = {}
    for name, cam_mod, robot_mod, he in (("jax", jcam, jrobot, jhe),
                                         ("port", camera, robot, hand_eye)):
        cam, ctrl = board_rig(cv2, cam_mod, robot_mod, x, board_in_robot,
                              stations)
        path = str(tmp_path / name / "handEye_tf.json")
        outs[name] = he.collect_and_calibrate(cam, ctrl, targets,
                                              out_path=path)
        np.testing.assert_array_equal(he.load_hand_eye(path),
                                      outs[name]["end2cam"])
    got, want = outs["port"], outs["jax"]
    assert got["n_stations"] == want["n_stations"] == len(stations)
    np.testing.assert_allclose(got["end2cam"], want["end2cam"], atol=1e-5)
    rel = got["end2cam"][:3, :3].T @ x[:3, :3]
    assert np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))) \
        < 0.5
    np.testing.assert_allclose(got["end2cam"][:3, 3], x[:3, 3], atol=3.0)


def test_collect_needs_three_stations():
    class NoBoard(camera.DepthCamBase):
        def get_intrinsics(self):
            return io.Intrinsics()

        def get_frames(self, with_repair=False, secure_image=False):
            return {"image": np.full((48, 64, 3), 255, np.uint8),
                    "depth": np.zeros((48, 64), np.uint16)}

    with pytest.raises(RuntimeError, match="only 0 valid stations"):
        hand_eye.collect_and_calibrate(NoBoard(), robot.FakeRobot(),
                                       [np.zeros(6)] * 4)


def test_poses_yaml_and_hand_eye_files(tmp_path):
    pytest.importorskip("cv2")
    poses = [np.eye(4), rigid(euler(0.1, 0.2, 0.3), [1.0, -2.0, 3.5])]
    path = str(tmp_path / "poses" / "cam_poses.yaml")
    hand_eye.save_poses_yaml(path, poses, key_prefix="cam")
    for mod in (hand_eye, jhe):
        back = mod.load_poses_yaml(path, key_prefix="cam")
        assert len(back) == 2
        np.testing.assert_array_equal(back[1], poses[1])
    x = np.arange(16, dtype=float).reshape(4, 4) / 7.0
    hand_eye.save_hand_eye(str(tmp_path / "a.json"), x)
    jhe.save_hand_eye(str(tmp_path / "b.json"), x)
    with open(tmp_path / "a.json") as f, open(tmp_path / "b.json") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(
        hand_eye.load_hand_eye(str(tmp_path / "b.json")), x)


def test_board_and_intrinsics_like_jax():
    pytest.importorskip("cv2")
    board, _ = hand_eye.get_board()
    jboard, _ = jhe.get_board()
    np.testing.assert_array_equal(board.getChessboardCorners(),
                                  jboard.getChessboardCorners())
    assert hand_eye.calibrate_camera_intrinsics(
        [np.full((48, 64), 255, np.uint8)] * 3) is None
