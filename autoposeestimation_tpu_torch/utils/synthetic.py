"""Ray-traced tabletop scenes and the synthetic on-disk dataset (numpy copy
of `autoposeestimation_tpu/utils/synthetic.py`): the fixture of the port's
tests and of `chip_smoke.py`. Robot frame in mm, depth in mm. The dataset
is written through the port's own io (PNG codec included), so writing it
needs no PIL."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import io


@dataclass
class SphereObject:
    """A sphere, optionally with extra sphere parts (offset, radius[,
    color]) glued on."""

    name: str
    center: np.ndarray          # robot frame, mm
    radius: float               # mm
    color: Tuple[int, int, int]
    symmetric: int = 1
    parts: Tuple = ()


def object_spheres(obj: SphereObject):
    """(center, radius, color) of the object's main sphere and parts."""
    out = [(np.asarray(obj.center, float), obj.radius, obj.color)]
    for part in obj.parts:
        col = part[2] if len(part) > 2 else obj.color
        out.append((np.asarray(obj.center, float) + np.asarray(part[0], float),
                    part[1], col))
    return out


@dataclass
class SynthConfig:
    img_h: int = 128
    img_w: int = 160
    fx: float = 140.0
    fy: float = 140.0
    n_viewpoints: int = 12
    ring_radius: float = 420.0  # mm
    ring_height: float = 380.0  # mm
    depth_scale: float = 0.001
    table_color: Tuple[int, int, int] = (110, 110, 115)
    noise: float = 0.0          # depth noise (mm)
    seed: int = 0


def look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """robot->camera 4x4 (mm): camera z-axis points at target."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    up = np.asarray([0.0, 0.0, -1.0])
    if abs(np.dot(up, z)) > 0.98:
        up = np.asarray([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    tf = np.eye(4)
    tf[:3, 0], tf[:3, 1], tf[:3, 2] = x, y, z
    tf[:3, 3] = cam_pos
    return tf


def ring_cameras(cfg: SynthConfig, target: np.ndarray) -> List[np.ndarray]:
    cams = []
    for i in range(cfg.n_viewpoints):
        a = 2 * np.pi * i / cfg.n_viewpoints
        pos = np.asarray([cfg.ring_radius * np.cos(a),
                          cfg.ring_radius * np.sin(a), cfg.ring_height])
        cams.append(look_at(pos, target))
    return cams


def render(cfg: SynthConfig, robot2cam: np.ndarray,
           spheres: Sequence[SphereObject]):
    """Exact ray-traced (color uint8 (H, W, 3), z-depth mm (H, W), owner
    (H, W) object index or -1)."""
    h, w = cfg.img_h, cfg.img_w
    ppx, ppy = w / 2.0, h / 2.0
    cols, rows = np.meshgrid(np.arange(w), np.arange(h))
    d = np.stack([(cols - ppx) / cfg.fx, (rows - ppy) / cfg.fy,
                  np.ones_like(cols, dtype=np.float64)], axis=-1)

    rot_rc = robot2cam[:3, :3].T  # R(cam <- robot)
    n = rot_rc @ np.asarray([0.0, 0.0, 1.0])
    p0 = rot_rc @ (np.zeros(3) - robot2cam[:3, 3])
    denom = d @ n
    t_plane = np.where(np.abs(denom) > 1e-9, (p0 @ n) / denom, np.inf)
    depth_t = np.where(t_plane > 0, t_plane, np.inf)
    color = np.empty((h, w, 3), np.float64)
    color[:] = cfg.table_color
    owner = np.full((h, w), -1, np.int32)

    for si, sp in enumerate(spheres):
        for c_robot, radius, col in object_spheres(sp):
            c_cam = rot_rc @ (c_robot - robot2cam[:3, 3])
            b = d @ c_cam
            cc = c_cam @ c_cam - radius ** 2
            dd = (d * d).sum(-1)
            disc = b * b - dd * cc
            t_sp = np.where(disc >= 0,
                            (b - np.sqrt(np.maximum(disc, 0.0))) / dd, np.inf)
            t_sp = np.where(t_sp > 0, t_sp, np.inf)
            hit = t_sp < depth_t
            depth_t = np.where(hit, t_sp, depth_t)
            owner = np.where(hit, si, owner)
            color[hit] = col

    zdepth = depth_t * d[..., 2]
    zdepth = np.where(np.isfinite(zdepth), zdepth, 0.0)
    if cfg.noise > 0:
        rng = np.random.default_rng(cfg.seed)
        zdepth = np.where(zdepth > 0,
                          zdepth + rng.normal(0, cfg.noise, zdepth.shape), 0.0)
    return color.astype(np.uint8), zdepth, owner


def headline_scene(num_classes: int = 5, img_hw: Tuple[int, int] = (480, 640),
                   model_pts: int = 1000):
    """The headline 5-object tabletop scene: (cfg, spheres, model_points).
    The RNG draw order (model points, then colors) reproduces the JAX
    package's frame exactly."""
    rng = np.random.default_rng(0)
    model_points = rng.normal(
        size=(num_classes, model_pts, 3)).astype(np.float32) * 0.05
    cfg = SynthConfig(img_h=img_hw[0], img_w=img_hw[1], fx=600.0, fy=600.0,
                      ring_radius=500.0, ring_height=450.0)
    spheres = [
        SphereObject(f"obj{i}",
                     np.asarray([120.0 * np.cos(a), 120.0 * np.sin(a), 40.0]),
                     45.0, tuple(int(v) for v in rng.integers(60, 255, 3)))
        for i, a in enumerate(np.linspace(0, 2 * np.pi, num_classes,
                                          endpoint=False))
    ]
    return cfg, spheres, model_points


def sphere_model_points(radius: float, n: int = 500, seed: int = 0
                        ) -> np.ndarray:
    """Fibonacci-sphere surface samples (mm, centered)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([radius * np.sin(phi) * np.cos(theta),
                     radius * np.sin(phi) * np.sin(theta),
                     radius * np.cos(phi)], axis=1)


def make_dataset(root: str, objects: Sequence[SphereObject] = None,
                 cfg: SynthConfig = None, dataset_name: str = "synth",
                 p_test: float = 0.2) -> Dict:
    """Write the full on-disk contract: per object a background and a
    foreground run (colour, depth, meta), ground-truth labels in the gen,
    pred and new_pred modes with pose-label metas, the model clouds and the
    dataset lists. Returns a manifest dict."""
    cfg = cfg or SynthConfig()
    if objects is None:
        objects = [
            SphereObject("red_ball", np.asarray([40.0, 0.0, 35.0]), 35.0,
                         (200, 40, 40)),
            SphereObject("blue_ball", np.asarray([-50.0, 30.0, 28.0]), 28.0,
                         (40, 60, 200)),
        ]
    intr = io.Intrinsics(width=cfg.img_w, height=cfg.img_h,
                         ppx=cfg.img_w / 2.0, ppy=cfg.img_h / 2.0,
                         fx=cfg.fx, fy=cfg.fy)
    hand_eye = np.eye(4)
    cams = ring_cameras(cfg, np.zeros(3))
    manifest = {"objects": [], "cams": cams, "intr": intr, "cfg": cfg}

    for obj in objects:
        # this object alone on the table (one object per scan)
        for run, spheres in (("background", []), ("foreground", [obj])):
            run_dir = os.path.join(io.data_dir(root), obj.name, run)
            label_run_dir = os.path.join(io.label_dir(root), obj.name, run)
            os.makedirs(run_dir, exist_ok=True)
            for vp, robot2cam in enumerate(cams):
                color, depth, owner = render(cfg, robot2cam, spheres)
                robot2end = robot2cam @ np.linalg.inv(hand_eye)
                meta = {
                    "joints": [0.0] * 6,
                    "pose": {"x": float(robot2end[0, 3]),
                             "y": float(robot2end[1, 3]),
                             "z": float(robot2end[2, 3]),
                             "a": 0.0, "b": 0.0, "c": 0.0},
                    "object_pose": np.eye(4),
                    "robot2endEff_tf": robot2end,
                    "intr": intr,
                    "depth_scale": cfg.depth_scale,
                    "symmetric": obj.symmetric,
                    "hand_eye_calibration": hand_eye,
                    "view_point_id": vp,
                }
                stem = f"{vp:06d}"
                io.write_png(os.path.join(run_dir, stem + ".color.png"), color)
                io.write_png(os.path.join(run_dir, stem + ".depth.png"),
                             np.round(depth).astype(np.uint16))
                io.write_sample_meta(os.path.join(run_dir, stem + ".meta.json"),
                                     meta)
                if run == "foreground":
                    mask = ((owner == 0).astype(np.uint8)) * 255
                    for mode in ("gen", "pred", "new_pred"):
                        io.write_png(os.path.join(
                            label_run_dir, f"{stem}.{mode}.label.png"), mask)
                    cam2robot = np.linalg.inv(robot2cam)
                    robot2object = np.eye(4)
                    robot2object[:3, 3] = obj.center
                    # the camera-frame object pose, cam2robot @ robot2object
                    cam2object = cam2robot @ robot2object
                    io.write_pose_label_meta(
                        os.path.join(label_run_dir, stem + ".meta.json"),
                        position=cam2object[:3, 3],
                        rotation=cam2object[:3, :3],
                        cls_name=obj.name, cam2robot=cam2robot,
                        robot2object=robot2object)

        # model cloud (.xyz, mm, centered) and .ply in the robot frame
        model = np.concatenate([sphere_model_points(r, 500) + (c - obj.center)
                                for c, r, _ in object_spheres(obj)])[:1000]
        pc_obj = os.path.join(io.pc_dir(root), obj.name)
        io.write_xyz(os.path.join(pc_obj, obj.name + ".xyz"), model)
        io.write_ply(os.path.join(pc_obj, obj.name + "_out.ply"),
                     model + obj.center)
        io.write_ply(os.path.join(pc_obj, obj.name + ".ply"), model)
        manifest["objects"].append(obj)

    # dataset lists (segmentation, pose_estimation), every-Nth test split
    names = [o.name for o in objects]
    for kind in ("segmentation", "pose_estimation"):
        ds = io.dataset_dir(root, kind, dataset_name)
        train, test = [], []
        for obj in objects:
            stems = [f"{obj.name}/foreground/{vp:06d}"
                     for vp in range(cfg.n_viewpoints)]
            n_test = max(int(len(stems) * p_test), 1)
            step = max(len(stems) // n_test, 1)
            for i, s in enumerate(stems):
                (test if i % step == 0 and len(
                    [t for t in test if t.startswith(obj.name)]) < n_test
                 else train).append(s)
        io.write_lines(os.path.join(ds, "classes.txt"), names)
        io.write_lines(os.path.join(ds, "train_data_list.txt"), train)
        io.write_lines(os.path.join(ds, "test_data_list.txt"), test)
        io.write_lines(os.path.join(ds, "extra_train_data_list.txt"), [])
    manifest["dataset_name"] = dataset_name
    return manifest
