"""The on-disk dataset contract (numpy copy of the matching functions in
`autoposeestimation_tpu/utils/io.py`; the layout is documented there).
Images go through the port's own PNG codec (`utils/png.py`), not PIL; the
text formats (json, `.xyz`, `.ply`, `.pcd`) are byte-identical to the JAX
package's."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from . import png


@dataclass
class Intrinsics:
    """Pinhole intrinsics as stored in the acquisition meta.json `intr`."""

    width: int = 640
    height: int = 480
    ppx: float = 320.0
    ppy: float = 240.0
    fx: float = 600.0
    fy: float = 600.0
    coeffs: List[float] = field(default_factory=lambda: [0.0] * 5)

    @classmethod
    def from_dict(cls, d: Dict) -> "Intrinsics":
        return cls(width=int(d["width"]), height=int(d["height"]),
                   ppx=float(d["ppx"]), ppy=float(d["ppy"]),
                   fx=float(d["fx"]), fy=float(d["fy"]),
                   coeffs=list(d.get("coeffs", [0.0] * 5)))

    def to_dict(self) -> Dict:
        return {"width": self.width, "height": self.height, "ppx": self.ppx,
                "ppy": self.ppy, "fx": self.fx, "fy": self.fy,
                "coeffs": self.coeffs}

    def as_array(self) -> np.ndarray:
        """(fx, fy, ppx, ppy) vector for the projection ops."""
        return np.asarray([self.fx, self.fy, self.ppx, self.ppy], np.float32)


_TRANSFORM_KEYS = ("robot2endEff_tf", "hand_eye_calibration", "object_pose")


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def write_json(path: str, data: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)


def read_sample_meta(path: str) -> Dict:
    """Acquisition meta.json with `intr` parsed and the 4x4 transforms
    reshaped."""
    meta = read_json(path)
    out = dict(meta)
    out["intr"] = Intrinsics.from_dict(meta["intr"])
    for key in _TRANSFORM_KEYS:
        if meta.get(key) is not None:
            out[key] = np.asarray(meta[key], np.float64).reshape(4, 4)
    return out


def write_sample_meta(path: str, meta: Dict) -> None:
    out = dict(meta)
    if isinstance(out.get("intr"), Intrinsics):
        out["intr"] = out["intr"].to_dict()
    for key in _TRANSFORM_KEYS:
        if isinstance(out.get(key), np.ndarray):
            out[key] = [float(v) for v in out[key].flatten()]
    write_json(path, out)


def read_pose_label_meta(path: str) -> Dict:
    """Pose-label meta.json: position (3, mm), rotation (3x3), cls_name,
    cam2robot (4x4, mm), robot2object (4x4, mm)."""
    meta = read_json(path)
    out = dict(meta)
    for key, shape in (("position", (3,)), ("rotation", (3, 3)),
                       ("cam2robot", (4, 4)), ("robot2object", (4, 4))):
        out[key] = np.asarray(meta[key], np.float64).reshape(shape)
    return out


def write_pose_label_meta(path: str, position, rotation, cls_name: str,
                          cam2robot, robot2object) -> None:
    def flat(a):
        return [float(v) for v in np.asarray(a).flatten()]

    write_json(path, {"position": flat(position), "rotation": flat(rotation),
                      "cls_name": cls_name, "cam2robot": flat(cam2robot),
                      "robot2object": flat(robot2object)})


def read_color(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3), as Pillow's `convert("RGB")` gives it: grey is
    repeated, alpha dropped. A 16-bit or palette PNG raises ValueError."""
    img = png.read(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a {img.dtype} image is not a colour "
                         f"image")
    if img.ndim == 2:
        return np.repeat(img.astype(np.uint8)[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_depth(path: str) -> np.ndarray:
    """Depth uint16 (H, W) in camera units (mm at depth_scale 0.001)."""
    return png.read(path).astype(np.uint16)


def read_label(path: str) -> np.ndarray:
    """Label uint8 (H, W): binary masks use 255, multi-class use ids."""
    return png.read(path).astype(np.uint8)


def write_png(path: str, array: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    png.write(path, array)


def read_lines(path: str) -> List[str]:
    """List files (classes.txt, *_data_list.txt): lines up to the first
    blank one."""
    out: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                break
            out.append(line)
    return out


def read_xyz(path: str) -> np.ndarray:
    """`.xyz` model cloud: one `[x y z]` numpy repr per line."""
    points = []
    with open(path) as f:
        for line in f:
            line = line.strip().strip("[]")
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 3:
                points.append(vals[:3])
    return np.asarray(points, dtype=np.float64)


def write_lines(path: str, lines: List[str]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for line in lines:
            f.write(line + "\n")


def write_xyz(path: str, points: np.ndarray) -> None:
    """One numpy repr `[x y z]` per line, as the reference writes."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for p in np.asarray(points):
            f.write("%s\n" % p)


def read_ply(path: str) -> np.ndarray:
    """Vertex xyz (K, 3) f64 of an ascii or binary PLY with one element."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        n_vertex = int(next(ln.split()[-1] for ln in header
                            if ln.startswith("element vertex")))
        props = [ln.split() for ln in header if ln.startswith("property")]
        dtypes = {"float": "f4", "float32": "f4", "double": "f8",
                  "float64": "f8", "uchar": "u1", "uint8": "u1", "int": "i4",
                  "int32": "i4"}
        names = [p[2] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex, dtype=np.float64)
            data = data.reshape(n_vertex, -1)
            return data[:, [names.index(c) for c in ("x", "y", "z")]]
        endian = "<" if "little" in fmt else ">"
        rec = np.dtype([(n, endian + dtypes[p[1]])
                        for n, p in zip(names, props)])
        data = np.frombuffer(f.read(rec.itemsize * n_vertex), dtype=rec)
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=1).astype(np.float64)


def _write_xyz_rows(f, points: np.ndarray) -> None:
    for p in points:
        f.write("%.10g %.10g %.10g\n" % (p[0], p[1], p[2]))


def write_ply(path: str, points: np.ndarray) -> None:
    """ASCII PLY, xyz only."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    points = np.asarray(points, dtype=np.float64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write("element vertex %d\n" % len(points))
        f.write("property double x\nproperty double y\nproperty double z\n")
        f.write("end_header\n")
        _write_xyz_rows(f, points)


def write_pcd(path: str, points: np.ndarray) -> None:
    """ASCII PCD, xyz only."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write("WIDTH %d\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %d\n"
                "DATA ascii\n" % (n, n))
        _write_xyz_rows(f, points)


def read_pcd(path: str) -> np.ndarray:
    """Vertex xyz (K, 3) f64 of an ascii PCD."""
    with open(path) as f:
        n = 0
        for line in f:
            s = line.strip()
            if s.startswith("POINTS"):
                n = int(s.split()[-1])
            if s.startswith("DATA"):
                if "ascii" not in s:
                    raise ValueError("only ascii PCD supported")
                break
        data = np.loadtxt(f, max_rows=n, dtype=np.float64)
    return data.reshape(n, -1)[:, :3]


def data_dir(root: str) -> str:
    return os.path.join(root, "data_generation", "data")


def label_dir(root: str) -> str:
    return os.path.join(root, "label_generator", "data")


def dataset_dir(root: str, kind: str, name: str) -> str:
    """kind in {segmentation, pose_estimation}."""
    return os.path.join(root, "label_generator", "data_sets", kind, name)


def pc_dir(root: str) -> str:
    return os.path.join(root, "pc_reconstruction", "data")


def list_objects(root: str) -> List[str]:
    """The object directories of the acquisition data, sorted."""
    d = data_dir(root)
    if not os.path.isdir(d):
        return []
    return sorted(o for o in os.listdir(d) if os.path.isdir(os.path.join(d, o)))


def list_runs(root: str, obj: str) -> List[str]:
    """The run directories (background, foreground, ...) of an object."""
    d = os.path.join(data_dir(root), obj)
    if not os.path.isdir(d):
        return []
    return sorted(r for r in os.listdir(d) if os.path.isdir(os.path.join(d, r)))


def list_sample_ids(run_dir: str) -> List[str]:
    """Sample stems (e.g. '000012') of an acquisition run directory."""
    return sorted({fn[: -len(".color.png")] for fn in os.listdir(run_dir)
                   if fn.endswith(".color.png")})


def robot2cam_from_meta(meta: Dict) -> np.ndarray:
    """robot -> camera 4x4 (mm): robot2endEff @ handEye."""
    return (np.asarray(meta["robot2endEff_tf"])
            @ np.asarray(meta["hand_eye_calibration"]))
