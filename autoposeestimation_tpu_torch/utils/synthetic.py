"""Ray-traced tabletop scenes (numpy copy of the scene part of
`autoposeestimation_tpu/utils/synthetic.py`): the fixture of the port's
tests and of `chip_smoke.py`. Robot frame in mm, depth in mm."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


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
