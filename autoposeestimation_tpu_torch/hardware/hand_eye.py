"""Hand-eye calibration (port of
`autoposeestimation_tpu/hardware/hand_eye.py`): ChArUco board poses with
OpenCV, and a closed-form AX = XB solver (Park & Martin: the rotation from
the log-map correlation matrix, the translation by stacked least squares)
in numpy f64, a copy of the JAX package's, so that both give the same X bit
for bit.

Board: 6x7 ChArUco, DICT_5X5_50, 15 mm squares / 10 mm markers (reference
calib.py:10-21). The result is the end-effector -> camera transform in mm,
stored as handEye_tf.json {'tf': 16 floats}.

OpenCV is imported inside the functions that need it (`get_board`,
`estimate_board_pose`, `calibrate_camera_intrinsics`, the poses yaml), as
in the JAX package. Where cv2 is not installed, those functions raise
ImportError when called: the same behaviour as the JAX package there, not
a fallback. The solver, the json file and `collect_and_calibrate` with an
injected board-pose estimator need no cv2.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..acquisition.get_data import robot2end_from_pose
from ..utils import io


# ---------------------------------------------------------------------------
# ChArUco extraction (host-side OpenCV)
# ---------------------------------------------------------------------------

def get_board(squares_x: int = 6, squares_y: int = 7,
              square_len_mm: float = 15.0, marker_len_mm: float = 10.0):
    import cv2

    dictionary = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_50)
    board = cv2.aruco.CharucoBoard(
        (squares_x, squares_y), square_len_mm, marker_len_mm, dictionary)
    return board, dictionary


def estimate_board_pose(image: np.ndarray, intr: io.Intrinsics,
                        board=None) -> Optional[np.ndarray]:
    """cam->board 4x4 (mm) from one image; None if the board isn't found."""
    import cv2

    if board is None:
        board, _ = get_board()
    detector = cv2.aruco.CharucoDetector(board)
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) if image.ndim == 3 else image
    corners, ids, _, _ = detector.detectBoard(gray)
    if corners is None or ids is None or len(corners) < 4:
        return None
    camera_matrix = np.asarray([[intr.fx, 0, intr.ppx],
                                [0, intr.fy, intr.ppy],
                                [0, 0, 1]], np.float64)
    dist = np.asarray(intr.coeffs, np.float64)
    obj_pts, img_pts = board.matchImagePoints(corners, ids)
    if obj_pts is None or len(obj_pts) < 4:
        return None
    ok, rvec, tvec = cv2.solvePnP(obj_pts, img_pts, camera_matrix, dist)
    if not ok:
        return None
    tf = np.eye(4)
    tf[:3, :3] = cv2.Rodrigues(rvec)[0]
    tf[:3, 3] = tvec.reshape(3)
    return tf


def calibrate_camera_intrinsics(images, board=None,
                                image_size=None) -> Optional[Dict]:
    """Intrinsic calibration from ChArUco detections (reference calib.py
    `read_chessboards` + `calibrate_camera`). Returns {'intr': Intrinsics,
    'rms': float} or None when too few detections."""
    import cv2

    if board is None:
        board, _ = get_board()
    detector = cv2.aruco.CharucoDetector(board)
    all_obj, all_img = [], []
    for image in images:
        gray = (cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
                if image.ndim == 3 else image)
        if image_size is None:
            image_size = (gray.shape[1], gray.shape[0])
        corners, ids, _, _ = detector.detectBoard(gray)
        if corners is None or ids is None or len(corners) < 6:
            continue
        obj_pts, img_pts = board.matchImagePoints(corners, ids)
        if obj_pts is not None and len(obj_pts) >= 6:
            all_obj.append(obj_pts)
            all_img.append(img_pts)
    if len(all_obj) < 3:
        return None
    rms, camera_matrix, dist, _, _ = cv2.calibrateCamera(
        all_obj, all_img, image_size, None, None)
    intr = io.Intrinsics(
        width=image_size[0], height=image_size[1],
        ppx=float(camera_matrix[0, 2]), ppy=float(camera_matrix[1, 2]),
        fx=float(camera_matrix[0, 0]), fy=float(camera_matrix[1, 1]),
        coeffs=[float(v) for v in np.asarray(dist).flatten()[:5]])
    return {"intr": intr, "rms": float(rms)}


# ---------------------------------------------------------------------------
# AX = XB solver (Park & Martin 1994)
# ---------------------------------------------------------------------------

def _log_so3(rot: np.ndarray) -> np.ndarray:
    theta = np.arccos(np.clip((np.trace(rot) - 1.0) / 2.0, -1.0, 1.0))
    if theta < 1e-10:
        return np.zeros(3)
    w = np.asarray([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                    rot[1, 0] - rot[0, 1]])
    return theta / (2.0 * np.sin(theta)) * w


def solve_ax_xb(a_list: List[np.ndarray], b_list: List[np.ndarray]
                ) -> np.ndarray:
    """Closed-form X from relative motions A_i X = X B_i (4x4 each)."""
    m = np.zeros((3, 3))
    for a, b in zip(a_list, b_list):
        alpha = _log_so3(a[:3, :3])
        beta = _log_so3(b[:3, :3])
        m += np.outer(beta, alpha)
    # R = (M^T M)^{-1/2} M^T
    w, v = np.linalg.eigh(m.T @ m)
    inv_sqrt = v @ np.diag(1.0 / np.sqrt(np.maximum(w, 1e-12))) @ v.T
    rot = inv_sqrt @ m.T
    # orthonormalize
    u, _, vt = np.linalg.svd(rot)
    rot = u @ vt
    if np.linalg.det(rot) < 0:
        rot = u @ np.diag([1.0, 1.0, -1.0]) @ vt

    lhs = []
    rhs = []
    for a, b in zip(a_list, b_list):
        lhs.append(a[:3, :3] - np.eye(3))
        rhs.append(rot @ b[:3, 3] - a[:3, 3])
    lhs = np.concatenate(lhs)
    rhs = np.concatenate(rhs)
    t, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)
    x = np.eye(4)
    x[:3, :3] = rot
    x[:3, 3] = t
    return x


def calibrate_hand_eye(robot2end_list: List[np.ndarray],
                       cam2board_list: List[np.ndarray]) -> np.ndarray:
    """endEff->camera from paired stations: robot->endEff poses and the
    camera's board poses (cam->board). Uses consecutive relative motions:
    A_i = inv(E_i) E_{i+1} (end-effector motion), B_i = C_i inv(C_{i+1})
    (camera motion), then AX = XB."""
    a_list, b_list = [], []
    for i in range(len(robot2end_list) - 1):
        a = np.linalg.inv(robot2end_list[i]) @ robot2end_list[i + 1]
        b = cam2board_list[i] @ np.linalg.inv(cam2board_list[i + 1])
        a_list.append(a)
        b_list.append(b)
    return solve_ax_xb(a_list, b_list)


def save_poses_yaml(path: str, poses: List[np.ndarray],
                    key_prefix: str = "pose") -> None:
    """OpenCV FileStorage yaml pose dump (the reference's cam_poses.yaml /
    robot_poses.yaml, getPoses.py:12-129)."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("n", len(poses))
    for i, pose in enumerate(poses):
        fs.write(f"{key_prefix}_{i}", np.asarray(pose, np.float64))
    fs.release()


def load_poses_yaml(path: str, key_prefix: str = "pose") -> List[np.ndarray]:
    import cv2

    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    n = int(fs.getNode("n").real())
    poses = [fs.getNode(f"{key_prefix}_{i}").mat() for i in range(n)]
    fs.release()
    return poses


def save_hand_eye(path: str, tf: np.ndarray) -> None:
    """handEye_tf.json: {'tf': 16 floats} (mm)."""
    io.write_json(path, {"tf": [float(v) for v in np.asarray(tf).flatten()]})


def load_hand_eye(path: str) -> np.ndarray:
    return np.asarray(io.read_json(path)["tf"], np.float64).reshape(4, 4)


def collect_and_calibrate(camera, controller, joint_targets,
                          board=None, settle: float = 0.0,
                          out_path: Optional[str] = None) -> Dict:
    """Drive the robot through `joint_targets` (rad), capture a frame at
    each, estimate the board poses and solve (the reference getPoses.py
    collection flow). The robot poses are built as the acquisition metas
    are (`robot2end_from_pose`, f32). Returns {'end2cam', 'n_stations'};
    with `out_path` also writes handEye_tf.json."""
    intr = camera.get_intrinsics()
    robot_poses, cam_poses = [], []
    for target in joint_targets:
        controller.move_joints(target, moveType="p")
        while controller.is_moving():
            time.sleep(0.05)
        if settle:
            time.sleep(settle)
        frames = camera.get_frames(with_repair=True, secure_image=True)
        if frames is None:
            continue
        robot2end = robot2end_from_pose(controller.get_pose(return_mm=True))
        board_tf = estimate_board_pose(frames["image"], intr, board)
        if board_tf is None:
            continue
        robot_poses.append(robot2end)
        cam_poses.append(board_tf)

    if len(robot_poses) < 3:
        raise RuntimeError(
            f"only {len(robot_poses)} valid stations; need >= 3")
    x = calibrate_hand_eye(robot_poses, cam_poses)
    if out_path:
        save_hand_eye(out_path, x)
    return {"end2cam": x, "n_stations": len(robot_poses)}
