"""The DenseFusion pose dataset over the on-disk contract (port of
`autoposeestimation_tpu/data/pose_dataset.py`, whose docstring lists the
reference behaviour kept).

Host code in numpy: files are read with the port's PNG codec (colour as
`convert("RGB")` gives it, depth as Pillow's "I;16", labels as "L") and
augmented with `data/augment.py`, which reproduces Pillow's arithmetic, so
an item equals the JAX dataset's item from the same seed, key by key.
Random draws come from the dataset's own generators: `random.Random(seed)`
for the augmentation and the extra-sample pick, `default_rng(seed)` for the
point draws in train mode, and a per-item `default_rng((seed, index))` in
test mode, so every evaluation sees the same points.

An item is built in steps, each a method, so that their costs can be
measured apart: `load` (read and decode), `augment` (colour jitter and the
joint rotation, train mode only), `zoom` (with `crop_and_zoom`, train mode
only: a random label-driven crop resized to `crop` pixels, the intrinsics
rewritten to it) and `sample` (choose pixels, backproject, subsample the
model).
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.common import IMAGENET_MEAN, IMAGENET_STD
from ..ops.projection import zoom_window_bbox_np
from ..utils import io, png
from . import augment as aug


class PoseDataset:
    def __init__(self, root: str, data_set_name: str, mode: str = "train",
                 num_pt: int = 1000, add_noise: bool = True,
                 noise_trans: float = 0.03, label_mode: str = "new_pred",
                 p_extra_data: float = 0.0, p_viewpoints: float = 1.0,
                 num_pt_mesh: int = 1000, crop: int = 320, seed: int = 0,
                 crop_and_zoom: bool = False, return_raw: bool = False,
                 rot_degrees: float = 180.0, pose_source: str = "tf_chain"):
        # "tf_chain": cam2robot @ robot2object; "meta_fields": the label
        # meta's camera-frame position/rotation
        self.pose_source = pose_source
        self.rot_degrees = rot_degrees
        # test-mode extras for the per-epoch image dumps: the full frame and
        # the intrinsics vector
        self.return_raw = return_raw
        # train mode: random label-driven zoom crops of `crop` pixels, the
        # intrinsics rewritten to the crop frame
        self.crop_and_zoom = crop_and_zoom
        ds_dir = io.dataset_dir(root, "pose_estimation", data_set_name)
        self.mode = mode
        self.num_pt = num_pt
        self.num_pt_mesh = num_pt_mesh
        self.add_noise = add_noise and mode == "train"
        self.noise_trans = noise_trans
        self.label_mode = label_mode
        self.crop = crop
        self.data_root = io.data_dir(root)
        self.label_root = io.label_dir(root)
        self.seed = seed
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

        list_name = ("train_data_list.txt" if mode == "train"
                     else "test_data_list.txt")
        self.items: List[str] = io.read_lines(os.path.join(ds_dir, list_name))

        self.extra_items: List[str] = []
        self.n_extra_samples = 0
        if mode == "train":
            # viewpoint subsampling: viewpoint ids are the 6-digit stems of
            # the first run
            if p_viewpoints < 1.0 and self.items:
                first_run = "/".join(self.items[0].split("/")[:2])
                vp_ids = [s[-6:] for s in self.items
                          if s.startswith(first_run)]
                self.np_rng.shuffle(vp_ids)
                keep = set(vp_ids[: int(len(vp_ids) * p_viewpoints)])
                self.items = [s for s in self.items if s[-6:] in keep]
            else:
                keep = {s[-6:] for s in self.items}
            extra_path = os.path.join(ds_dir, "extra_train_data_list.txt")
            if p_extra_data > 0 and os.path.exists(extra_path):
                keep_ids = {int(v) for v in keep}
                for stem in io.read_lines(extra_path):
                    meta = io.read_sample_meta(os.path.join(
                        self.data_root, stem + ".meta.json"))
                    if meta["view_point_id"] in keep_ids:
                        self.extra_items.append(stem)
                self.n_extra_samples = int(len(self.items) * p_extra_data)

        self.classes = io.read_lines(os.path.join(ds_dir, "classes.txt"))
        self.cld: Dict[int, np.ndarray] = {}
        self.symmetry_obj_idx: List[int] = []
        for cid, cls in enumerate(self.classes):
            pts = io.read_xyz(os.path.join(io.pc_dir(root), cls,
                                           cls + ".xyz")) / 1000.0
            self.cld[cid] = pts.astype(np.float32)
            obj_dir = os.path.join(self.data_root, cls)
            run = sorted(os.listdir(obj_dir))[0]
            run_dir = os.path.join(obj_dir, run)
            metas = sorted(f for f in os.listdir(run_dir)
                           if f.endswith(".meta.json"))
            meta = io.read_sample_meta(os.path.join(run_dir, metas[0]))
            if bool(meta.get("symmetric", 0)):
                self.symmetry_obj_idx.append(cid)

    def get_sym_list(self) -> List[int]:
        return self.symmetry_obj_idx

    def __len__(self) -> int:
        return len(self.items) + self.n_extra_samples

    def load(self, index: int) -> Tuple:
        """Read item `index`: (img (H, W, 3) uint8, depth (H, W) uint16,
        label (H, W) uint8, image_meta, pose-label meta). An index past the
        list draws one of the extra samples."""
        if index < len(self.items):
            stem = self.items[index]
            label_mode = self.label_mode
        else:
            stem = self.extra_items[self.rng.randrange(len(self.extra_items))]
            label_mode = "new_pred"
        img = io.read_color(os.path.join(self.data_root, stem + ".color.png"))
        depth = png.read(os.path.join(self.data_root, stem + ".depth.png"))
        image_meta = io.read_sample_meta(os.path.join(
            self.data_root, stem + ".meta.json"))
        label = io.read_label(os.path.join(
            self.label_root, f"{stem}.{label_mode}.label.png"))
        meta = io.read_pose_label_meta(os.path.join(
            self.label_root, stem + ".meta.json"))
        return img, depth, label, image_meta, meta

    def augment(self, img: np.ndarray, label: np.ndarray, depth: np.ndarray
                ) -> Tuple:
        """Colour jitter, then one in-plane rotation of image, label and
        depth: (img, label, depth, rotation 4x4 of the camera frame)."""
        augment_rotation = np.eye(4)
        img = aug.color_jitter(img, rng=self.rng)
        angle = self.rng.uniform(-self.rot_degrees, self.rot_degrees)
        augment_rotation[:3, :3] = _rot_z(np.deg2rad(angle))
        img, label, depth = aug.rotate_joint(angle, img, label, depth)
        return img, label, depth, augment_rotation

    def zoom(self, img: np.ndarray, label: np.ndarray, depth: np.ndarray,
             intr) -> Tuple:
        """The crop-and-zoom of image, label and depth to `crop` pixels:
        (img, label, depth, (fx, fy, ppx, ppy) in the crop frame)."""
        box = aug.CropAndZoom(self.crop, rng=self.rng).compute_box(label)
        left, upper, right, lower = box
        sx = self.crop / max(right - left, 1)
        sy = self.crop / max(lower - upper, 1)
        size = (self.crop, self.crop)
        img = aug.resize_bicubic(aug.crop(img, box), size)
        label = aug.resize_nearest(aug.crop(label, box), size)
        depth = aug.resize_nearest(aug.crop(depth, box), size)
        return img, label, depth, (intr.fx * sx, intr.fy * sy,
                                   (intr.ppx - left) * sx,
                                   (intr.ppy - upper) * sy)

    def __getitem__(self, index: int) -> Optional[Dict[str, np.ndarray]]:
        img, depth, label, image_meta, meta = self.load(index)
        augment_rotation = np.eye(4)
        if self.add_noise:
            img, label, depth, augment_rotation = self.augment(img, label,
                                                               depth)
        intr = None
        if self.crop_and_zoom and self.mode == "train":
            img, label, depth, intr = self.zoom(img, label, depth,
                                                image_meta["intr"])
        return self.sample(index, img, depth, label, image_meta, meta,
                           augment_rotation, intr)

    def sample(self, index: int, img_np: np.ndarray, depth: np.ndarray,
               label_np: np.ndarray, image_meta: Dict, meta: Dict,
               augment_rotation: np.ndarray, intr: Optional[Tuple] = None
               ) -> Optional[Dict[str, np.ndarray]]:
        """The item's arrays from its (augmented) frame; None when the mask
        holds no valid depth inside the window. `intr` (fx, fy, ppx, ppy)
        replaces the frame's intrinsics (a zoomed crop's)."""
        item_rng = (self.np_rng if self.mode == "train"
                    else np.random.default_rng((self.seed, index)))
        obj = self.classes.index(meta["cls_name"])

        if self.pose_source == "meta_fields":
            cam2object = np.eye(4)
            cam2object[:3, :3] = meta["rotation"]
            cam2object[:3, 3] = meta["position"]
        else:
            cam2object = meta["cam2robot"] @ meta["robot2object"]
        if self.add_noise:
            cam2object = np.linalg.inv(augment_rotation) @ cam2object
        target_r = cam2object[:3, :3]
        target_t = cam2object[:3, 3] / 1000.0  # to meters
        if intr is None:
            frame = image_meta["intr"]
            intr = (frame.fx, frame.fy, frame.ppx, frame.ppy)
        fx, fy, ppx, ppy = intr

        depth_np = depth.astype(np.float32)
        mask = (label_np == 255) & (depth_np != 0)
        if not mask.any():
            return None
        h, w = label_np.shape
        # the static window clamped to the frame, a multiple of 8
        crop = min(self.crop, h, w)
        crop -= crop % 8
        # the serving graph's zoom window of the mask, and the (crop, crop)
        # lattice of it that serving samples
        r0, c0, win = zoom_window_bbox_np(label_np == 255, crop, h, w)
        ii = r0 + (np.arange(crop) * win) // crop
        jj = c0 + (np.arange(crop) * win) // crop
        lat_mask = mask[np.ix_(ii, jj)]
        choose = lat_mask.flatten().nonzero()[0]
        if len(choose) == 0:
            return None
        if len(choose) > self.num_pt:
            # stratified rank draw, one uniform pick per rank stratum
            cnt = len(choose)
            j = np.arange(self.num_pt)
            lo = (j * cnt) // self.num_pt
            hi = ((j + 1) * cnt) // self.num_pt
            ranks = lo + (item_rng.random(self.num_pt) * (hi - lo)).astype(int)
            choose = choose[ranks]
        else:
            choose = np.pad(choose, (0, self.num_pt - len(choose)), "wrap")

        drow = ii[choose // crop]
        dcol = jj[choose % crop]
        z = depth_np[drow, dcol] * image_meta["depth_scale"]
        x = (dcol - ppx) * z / fx
        y = (drow - ppy) * z / fy
        cloud = np.stack([x, y, z], axis=1).astype(np.float32)

        if self.add_noise:
            add_t = self.np_rng.uniform(-self.noise_trans, self.noise_trans, 3)
            cloud = cloud + add_t

        model = self.cld[obj]
        if len(model) > self.num_pt_mesh:
            dell = item_rng.choice(len(model), len(model) - self.num_pt_mesh,
                                   replace=False)
            model = np.delete(model, dell, axis=0)
        elif len(model) < self.num_pt_mesh:
            idx2 = np.arange(self.num_pt_mesh) % len(model)
            model = model[idx2]

        target = model @ target_r.T + target_t
        if self.add_noise:
            target = target + add_t
            target_t = target_t + add_t

        img_crop = img_np[np.ix_(ii, jj)].astype(np.float32) / 255.0
        img_crop = (img_crop - np.asarray(IMAGENET_MEAN)) / np.asarray(
            IMAGENET_STD)

        out = {
            "img": img_crop.astype(np.float32),
            "cloud": cloud.astype(np.float32),
            "choose": choose.astype(np.int32),
            "target": target.astype(np.float32),
            "model_points": model.astype(np.float32),
            "obj_idx": np.int32(obj),
            "is_sym": np.bool_(obj in self.symmetry_obj_idx),
            "target_t": target_t.astype(np.float32),
            "target_r": target_r.astype(np.float32),
        }
        if self.return_raw:
            out["raw_img"] = img_np.astype(np.uint8)
            out["intr"] = np.asarray([fx, fy, ppx, ppy], np.float32)
        return out


def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
