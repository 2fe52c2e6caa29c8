"""Ray-traced tabletop frames: spheres on a table seen from a ring of
cameras (a copy, in torch, of the measured package's synthetic renderer,
so that a pool of 640x480 frames renders on the card in milliseconds).

Robot frame in mm, depth in mm (depth_scale 0.001), colour uint8 RGB. The
layout is data: rings of objects (radius, count, height above the table,
sphere radius) and a ring of cameras (radius, height, focal length). The
seed draws the objects' colours, a phase for every ring and the cameras'
phase; every seed gives the same number of objects and frames, so the same
sizes."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

TABLE_COLOR = (110.0, 110.0, 115.0)


def look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """robot -> camera 4x4 (mm); the camera's z axis points at target."""
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


def place_objects(layout: Dict, rng: np.random.Generator
                  ) -> List[Tuple[np.ndarray, float, Tuple[int, int, int]]]:
    """(centre mm, radius mm, colour) of every object, ring by ring."""
    out = []
    for ring in layout["rings"]:
        phase = rng.uniform(0, 2 * np.pi)
        for i in range(ring["count"]):
            a = phase + 2 * np.pi * i / ring["count"]
            centre = np.asarray([ring["radius_mm"] * np.cos(a),
                                 ring["radius_mm"] * np.sin(a),
                                 ring["height_mm"]])
            colour = tuple(int(v) for v in rng.integers(60, 255, 3))
            out.append((centre, float(ring["sphere_mm"]), colour))
    return out


def cameras(layout: Dict, count: int, rng: np.random.Generator
            ) -> List[np.ndarray]:
    cam = layout["camera"]
    phase = rng.uniform(0, 2 * np.pi)
    out = []
    for i in range(count):
        a = phase + 2 * np.pi * i / count
        pos = np.asarray([cam["ring_radius_mm"] * np.cos(a),
                          cam["ring_radius_mm"] * np.sin(a),
                          cam["height_mm"]])
        out.append(look_at(pos, np.zeros(3)))
    return out


def render(hw: Tuple[int, int], focal: float, robot2cam: np.ndarray,
           objects, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(colour uint8 (H, W, 3), z-depth mm (H, W) float32) of the table
    and the spheres, exact ray casting."""
    h, w = hw
    f64 = dict(dtype=torch.float64, device=device)
    rows, cols = torch.meshgrid(torch.arange(h, **f64),
                                torch.arange(w, **f64), indexing="ij")
    d = torch.stack([(cols - w / 2.0) / focal, (rows - h / 2.0) / focal,
                     torch.ones_like(cols)], dim=-1)
    rot_rc = torch.as_tensor(robot2cam[:3, :3].T, **f64)
    origin = torch.as_tensor(robot2cam[:3, 3], **f64)
    n = rot_rc @ torch.tensor([0.0, 0.0, 1.0], **f64)
    p0 = rot_rc @ (-origin)
    denom = d @ n
    t_plane = torch.where(denom.abs() > 1e-9, (p0 @ n) / denom,
                          torch.full_like(denom, math.inf))
    depth_t = torch.where(t_plane > 0, t_plane,
                          torch.full_like(t_plane, math.inf))
    color = torch.tensor(TABLE_COLOR, **f64).expand(h, w, 3).clone()
    dd = (d * d).sum(-1)
    for centre, radius, colour in objects:
        c_cam = rot_rc @ (torch.as_tensor(centre, **f64) - origin)
        b = d @ c_cam
        disc = b * b - dd * (c_cam @ c_cam - radius ** 2)
        t_sp = (b - torch.sqrt(disc.clamp(min=0.0))) / dd
        t_sp = torch.where((disc >= 0) & (t_sp > 0), t_sp,
                           torch.full_like(t_sp, math.inf))
        hit = t_sp < depth_t
        depth_t = torch.where(hit, t_sp, depth_t)
        color = torch.where(hit[..., None], torch.tensor(colour, **f64),
                            color)
    z = depth_t * d[..., 2]
    z = torch.where(torch.isfinite(z), z, torch.zeros_like(z))
    return color.to(torch.uint8), z.to(torch.float32)


def frame_pool(layout: Dict, hw: Tuple[int, int], count: int, seed: int,
               device) -> Dict:
    """`count` views of one seeded scene: 'images' uint8 (F, H, W, 3) and
    'depths' uint16 mm (F, H, W) on the host, 'intr' (fx, fy, ppx, ppy)
    and 'depth_scale'."""
    rng = np.random.default_rng(seed)
    objects = place_objects(layout, rng)
    focal = float(layout["camera"]["focal_px"])
    images, depths = [], []
    for tf in cameras(layout, count, rng):
        color, z = render(hw, focal, tf, objects, device)
        images.append(color)
        depths.append(torch.round(z).to(torch.int32))
    images = torch.stack(images).cpu().numpy()
    depths = torch.stack(depths).cpu().numpy().astype(np.uint16)
    intr = np.asarray([focal, focal, hw[1] / 2.0, hw[0] / 2.0], np.float32)
    return {"images": images, "depths": depths, "intr": intr,
            "depth_scale": 0.001}


def point_draws(count: int, k: int, n: int, seed: int) -> np.ndarray:
    """The point-selection draws (count, K, N) in [0, 1), one set a frame
    of the pool."""
    rng = np.random.default_rng([seed, 1])
    return rng.random((count, k, n), dtype=np.float32)


def model_points(k: int, m: int, seed: int) -> np.ndarray:
    """Per-class model clouds (K, M, 3) in metres."""
    rng = np.random.default_rng([seed, 2])
    return (rng.normal(size=(k, m, 3)) * 0.05).astype(np.float32)
