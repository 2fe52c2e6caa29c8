"""The public benchmarks' loaders, YCB-Video and LineMOD (port of
`autoposeestimation_tpu/data/legacy_datasets.py`, after upstream
DenseFusion's datasets/ycb/dataset.py and datasets/linemod/dataset.py):
samples in the pose dataset's contract (img crop, cloud, choose, target,
model_points, obj_idx, is_sym), so that the DenseFusion trainer and
evaluation run on them unchanged, and the vanilla segmentation dataset of
YCB-Video.

Layouts:
  YCB-Video: <root>/data/NNNN/NNNNNN-{color.png,depth.png,label.png,meta.mat}
             with meta.mat keys cls_indexes, poses, factor_depth;
             models/<cls>/points.xyz.
  LineMOD:   <root>/data/NN/{rgb,depth,mask}/NNNN.png + gt.yml (per-frame
             cam_R_m2c, cam_t_m2c) + models/obj_NN.ply; depth factor 1000.

Each sample equals the JAX package's key by key from the same seed: the
numpy `default_rng` and Python `random.Random` draws are made in the same
order. Images are read by the port's PNG codec, colour with the
semantics of Pillow's `convert("RGB")` (`io.read_color`: grey repeated,
alpha dropped; a palette PNG raises). LineMOD's gt.yml is read by `read_gt_yml`, not PyYAML. The
synthetic frames of `YCBSegDataset` are brightened and blurred by
`data/augment.py`'s copies of Pillow's `ImageEnhance.Brightness` and
`GaussianBlur`.

As in the JAX package, a LineMOD sample's `obj_idx` is `obj - 1` of the
LineMOD id (1-15) and `is_sym` marks ids 7 and 8. Upstream DenseFusion
means entries 7 and 8 of its 13-object list (eggbox 10, glue 11).
"""
from __future__ import annotations

import os
import random
import re
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.common import IMAGENET_MEAN, IMAGENET_STD
from ..utils import io, png
from . import augment as aug

YCB_SYM_IDS = (12, 15, 18, 19, 20)  # upstream symmetric object indices
LINEMOD_SYM_IDS = (7, 8)            # see the module docstring


# YAML 1.1's int and float forms, as PyYAML's safe_load resolves them
_YAML_INT = re.compile(r"[-+]?[0-9]+$")
_YAML_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")


def _scalar(text: str) -> Any:
    text = text.strip()
    if _YAML_INT.match(text):
        return int(text)
    if _YAML_FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(text.replace("_", ""))
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def _value(text: str) -> Any:
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    return _scalar(text)


def read_gt_yml(path: str) -> Dict[int, List[Dict[str, Any]]]:
    """LineMOD's gt.yml: an int frame key -> a list of mappings of scalars
    and lists of scalars (flow `[a, b]`, also wrapped over lines, or block
    `- a` lines), what `yaml.safe_load` gives for the file."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    entries: Optional[List[Dict[str, Any]]] = None
    entry: Optional[Dict[str, Any]] = None
    open_key: Optional[str] = None      # a key whose block list follows
    pending = ""                        # a flow list wrapped over lines
    with open(path) as f:
        for raw in f:
            line = raw.split(" #")[0].rstrip()
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if pending or (line.count("[") > line.count("]")):
                pending += (" " if pending else "") + (
                    line.strip() if pending else line)
                if pending.count("[") > pending.count("]"):
                    continue
                line, pending = pending, ""
            if not line[0].isspace() and not line.startswith("-"):
                key, _, rest = line.partition(":")
                entries = [] if rest.strip() in ("", "[]") else None
                if entries is None:
                    raise ValueError(f"{path}: unexpected line {line!r}")
                out[_scalar(key)] = entries
                entry, open_key = None, None
                continue
            body = line.strip()
            if body.startswith("- ") and ":" not in body[2:].split("[")[0]:
                if entry is None or open_key is None:
                    raise ValueError(f"{path}: unexpected line {line!r}")
                entry[open_key].append(_scalar(body[2:]))
                continue
            if body.startswith("- "):
                if entries is None:
                    raise ValueError(f"{path}: a list outside a frame key")
                entry = {}
                entries.append(entry)
                body = body[2:].strip()
            if entry is None:
                raise ValueError(f"{path}: unexpected line {line!r}")
            key, _, rest = body.partition(":")
            if rest.strip():
                entry[key.strip()] = _value(rest)
                open_key = None
            else:
                entry[key.strip()] = []
                open_key = key.strip()
    return out


def _choose_and_backproject(depth, mask, intr_vec, cam_scale, num_pt, crop,
                            rng):
    """Crop -> choose -> backproject (the math of data/pose_dataset.py)."""
    fx, fy, ppx, ppy = intr_vec
    valid = mask & (depth > 0)
    if not valid.any():
        return None
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rc = (np.where(rows)[0][[0, -1]].sum() + 1) // 2
    cc = (np.where(cols)[0][[0, -1]].sum() + 1) // 2
    h, w = mask.shape
    crop = min(crop, h, w)
    crop -= crop % 8
    r0 = int(np.clip(rc - crop // 2, 0, max(h - crop, 0)))
    c0 = int(np.clip(cc - crop // 2, 0, max(w - crop, 0)))
    win = valid[r0:r0 + crop, c0:c0 + crop]
    choose = win.flatten().nonzero()[0]
    if len(choose) == 0:
        return None
    if len(choose) > num_pt:
        sel = np.zeros(len(choose), dtype=int)
        sel[:num_pt] = 1
        rng.shuffle(sel)
        choose = choose[sel.nonzero()]
    else:
        choose = np.pad(choose, (0, num_pt - len(choose)), "wrap")
    drow = r0 + choose // crop
    dcol = c0 + choose % crop
    z = depth[drow, dcol] / cam_scale
    x = (dcol - ppx) * z / fx
    y = (drow - ppy) * z / fy
    cloud = np.stack([x, y, z], axis=1).astype(np.float32)
    return cloud, choose.astype(np.int32), (r0, c0, crop)


def _normalized_crop(img: np.ndarray, r0: int, c0: int, crop: int
                     ) -> np.ndarray:
    crop_img = img[r0:r0 + crop, c0:c0 + crop].astype(np.float32) / 255.0
    crop_img = (crop_img - np.asarray(IMAGENET_MEAN)) / np.asarray(
        IMAGENET_STD)
    return crop_img.astype(np.float32)


class YCBPoseDataset:
    """YCB-Video loader over the real frames (the upstream synthetic-
    blending branch is not part of it, as in the JAX package)."""

    # the two camera intrinsics the upstream loader switches between
    CAM_1 = (1066.778, 1067.487, 312.9869, 241.3109)
    CAM_2 = (1077.836, 1078.189, 323.7872, 279.6921)

    def __init__(self, root: str, data_list: List[str], classes: List[str],
                 num_pt: int = 1000, num_pt_mesh: int = 500, crop: int = 320,
                 seed: int = 0):
        self.root = root
        self.list = data_list
        self.classes = classes
        self.num_pt = num_pt
        self.num_pt_mesh = num_pt_mesh
        self.crop = crop
        self.rng = np.random.default_rng(seed)
        self.cld: Dict[int, np.ndarray] = {}
        for cid, cls in enumerate(classes, start=1):
            path = os.path.join(root, "models", cls, "points.xyz")
            pts = []
            with open(path) as f:
                for line in f:
                    vals = line.split()
                    if len(vals) >= 3:
                        pts.append([float(v) for v in vals[:3]])
            self.cld[cid] = np.asarray(pts, np.float32)

    def get_sym_list(self):
        return [i for i in YCB_SYM_IDS if i < len(self.classes)]

    def __len__(self):
        return len(self.list)

    def __getitem__(self, index: int) -> Optional[Dict]:
        import scipy.io as scio

        stem = self.list[index]
        base = os.path.join(self.root, stem)
        img = io.read_color(base + "-color.png")
        depth = png.read(base + "-depth.png").astype(np.float32)
        label = png.read(base + "-label.png")
        meta = scio.loadmat(base + "-meta.mat")
        # upstream rule: synthetic frames and videos >= 0060 use the second
        # camera's intrinsics
        parts = stem.split("/")
        video_id = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
        intr = self.CAM_2 if ("data_syn" in stem or video_id >= 60) \
            else self.CAM_1
        cls_indexes = meta["cls_indexes"].flatten().astype(int)
        pick = self.rng.integers(0, len(cls_indexes))
        obj = int(cls_indexes[pick])
        mask = label == obj
        out = _choose_and_backproject(depth, mask, intr,
                                      float(np.asarray(
                                          meta["factor_depth"]).reshape(-1)[0]),
                                      self.num_pt, self.crop, self.rng)
        if out is None:
            return None
        cloud, choose, (r0, c0, crop) = out
        pose = meta["poses"][:, :, pick]
        target_r, target_t = pose[:, :3], pose[:, 3]
        model = self.cld[obj]
        if len(model) > self.num_pt_mesh:
            keep = self.rng.choice(len(model), self.num_pt_mesh, replace=False)
            model = model[keep]
        target = model @ target_r.T + target_t
        return {
            "img": _normalized_crop(img, r0, c0, crop),
            "cloud": cloud, "choose": choose,
            "target": target.astype(np.float32),
            "model_points": model.astype(np.float32),
            "obj_idx": np.int32(obj - 1),
            "is_sym": np.bool_((obj - 1) in self.get_sym_list()),
        }


class LineModPoseDataset:
    """LineMOD-preprocessed loader (gt.yml poses, mm -> m)."""

    INTR = (572.41140, 573.57043, 325.26110, 242.04899)

    def __init__(self, root: str, objects: List[int], mode: str = "train",
                 num_pt: int = 500, num_pt_mesh: int = 500, crop: int = 240,
                 seed: int = 0):
        self.root = root
        self.num_pt = num_pt
        self.num_pt_mesh = num_pt_mesh
        self.crop = crop
        self.rng = np.random.default_rng(seed)
        self.items: List = []
        self.gt: Dict = {}
        self.cld: Dict[int, np.ndarray] = {}
        for obj in objects:
            seq = os.path.join(root, "data", f"{obj:02d}")
            with open(os.path.join(seq, f"{mode}.txt")) as f:
                frames = [ln.strip() for ln in f if ln.strip()]
            self.gt[obj] = read_gt_yml(os.path.join(seq, "gt.yml"))
            self.items.extend((obj, fr) for fr in frames)
            self.cld[obj] = io.read_ply(
                os.path.join(root, "models", f"obj_{obj:02d}.ply")) / 1000.0

    def get_sym_list(self):
        return list(LINEMOD_SYM_IDS)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Optional[Dict]:
        obj, frame = self.items[index]
        seq = os.path.join(self.root, "data", f"{obj:02d}")
        img = io.read_color(os.path.join(seq, "rgb", frame + ".png"))
        depth = png.read(os.path.join(seq, "depth", frame + ".png")).astype(
            np.float32)
        mask = png.read(os.path.join(seq, "mask", frame + ".png")) > 0
        if mask.ndim == 3:
            mask = mask[..., 0]
        entry = next(e for e in self.gt[obj][int(frame)]
                     if e["obj_id"] == obj)
        target_r = np.asarray(entry["cam_R_m2c"], np.float64).reshape(3, 3)
        target_t = np.asarray(entry["cam_t_m2c"], np.float64) / 1000.0
        out = _choose_and_backproject(depth, mask, self.INTR, 1000.0,
                                      self.num_pt, self.crop, self.rng)
        if out is None:
            return None
        cloud, choose, (r0, c0, crop) = out
        model = self.cld[obj]
        if len(model) > self.num_pt_mesh:
            keep = self.rng.choice(len(model), self.num_pt_mesh, replace=False)
            model = model[keep]
        target = model @ target_r.T + target_t
        return {
            "img": _normalized_crop(img, r0, c0, crop),
            "cloud": cloud, "choose": choose,
            "target": target.astype(np.float32),
            "model_points": model.astype(np.float32),
            "obj_idx": np.int32(obj - 1),
            "is_sym": np.bool_(obj in LINEMOD_SYM_IDS),
        }


class YCBSegDataset:
    """The vanilla segmentation dataset of YCB-Video (reference
    vanilla_segmentation/data_controller.py:17-98): `length` frames drawn
    at random an epoch, ColorJitter noise, synthetic frames brightened,
    blurred and composited onto a random real frame's background (its
    colour and label where the synthetic label is 0), random flips.
    Returns {'image': (H, W, 3) float32 ImageNet-normalized, 'label': (H, W)
    int32}."""

    def __init__(self, root: str, data_list: List[str], use_noise: bool,
                 length: int, seed: int = 0):
        self.root = root
        self.path = list(data_list)
        self.real_path = [p for p in self.path if p.startswith("data/")]
        self.use_noise = use_noise
        self.length = length
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

    def __len__(self):
        return self.length

    def _load(self, stem):
        base = os.path.join(self.root, stem)
        return (io.read_color(base + "-color.png").astype(np.float64),
                png.read(base + "-label.png"))

    def __getitem__(self, idx: int) -> Dict:
        index = self.rng.randint(0, max(len(self.path) - 10, 0))
        stem = self.path[index]
        rgb, label = self._load(stem)
        label = label.copy()
        if self.use_noise:
            rgb = aug.color_jitter(rgb.astype(np.uint8),
                                   rng=self.rng).astype(np.float64)

        if stem.startswith("data_syn"):
            img = io.read_color(os.path.join(self.root, stem) + "-color.png")
            img = aug.gaussian_blur(aug.adjust_brightness(img, 1.5), 0.8)
            rgb = aug.color_jitter(img, rng=self.rng).astype(np.float64)
            seed = self.rng.randint(0, max(len(self.path) - 10, 0))
            back = aug.color_jitter(
                self._load(self.path[seed])[0].astype(np.uint8),
                rng=self.rng).astype(np.float64)
            back_label = self._load(self.path[seed])[1]
            mask = (label == 0)
            rgb = rgb + self.np_rng.normal(0.0, 5.0, rgb.shape)
            rgb = back * mask[..., None] + rgb
            label = back_label * mask + label

        if self.use_noise:
            choice = self.rng.randint(0, 3)
            if choice == 0:
                rgb, label = np.fliplr(rgb), np.fliplr(label)
            elif choice == 1:
                rgb, label = np.flipud(rgb), np.flipud(label)
            elif choice == 2:
                rgb, label = np.flipud(np.fliplr(rgb)), np.flipud(
                    np.fliplr(label))

        img = rgb.astype(np.float32) / 255.0
        img = (img - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
        return {"image": img.astype(np.float32),
                "label": np.ascontiguousarray(label).astype(np.int32)}
