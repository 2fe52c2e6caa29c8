"""The multi-class segmentation dataset over the on-disk contract (port of
`autoposeestimation_tpu/data/segmentation_dataset.py`, whose docstring
lists the reference behaviour kept).

Host code in numpy: images and labels are read with the port's PNG codec
and augmented with `data/augment.py`, which reproduces Pillow's arithmetic,
so an item equals the JAX dataset's item from the same seed. In train mode
an item is colour-jittered, rotated with its label by an angle in
[-180, 180) and cropped-and-zoomed to `output_size`, all drawing from the
dataset's `random.Random(seed)` in the JAX order; in test mode it is the
full frame. An item is {"image": (H, W, 3) f32 normalized, "label": (H, W)
int32 class ids, 0 the background}.
"""
from __future__ import annotations

import os
import random
from typing import Dict, Tuple

import numpy as np

from ..models.common import IMAGENET_MEAN, IMAGENET_STD
from ..utils import io
from . import augment as aug


class SegmentationDataset:
    def __init__(self, root: str, data_set_name: str, mode: str = "train",
                 label_mode: str = "gen", use_imagenet_stats: bool = True,
                 output_size: int = 480, seed: int = 0):
        self.root = root
        self.mode = mode
        self.label_mode = label_mode
        self.output_size = output_size
        ds_dir = io.dataset_dir(root, "segmentation", data_set_name)
        self.classes = io.read_lines(os.path.join(ds_dir, "classes.txt"))
        list_name = ("train_data_list.txt" if mode == "train"
                     else "test_data_list.txt")
        self.items = io.read_lines(os.path.join(ds_dir, list_name))
        self.data_root = io.data_dir(root)
        self.label_root = io.label_dir(root)
        self.rng = random.Random(seed)

        if use_imagenet_stats:
            self.mean = np.asarray(IMAGENET_MEAN, np.float32)
            self.std = np.asarray(IMAGENET_STD, np.float32)
        else:
            self.mean, self.std = self.compute_stats()

    def compute_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-dataset channel mean and std over the listed images,
        accumulated in f64 (the reference's dataset.py:68-83)."""
        acc = np.zeros(3)
        acc2 = np.zeros(3)
        n = 0
        for stem in self.items:
            img = io.read_color(os.path.join(
                self.data_root, stem + ".color.png")) / 255.0
            acc += img.mean(axis=(0, 1))
            acc2 += (img ** 2).mean(axis=(0, 1))
            n += 1
        mean = acc / max(n, 1)
        std = np.sqrt(np.maximum(acc2 / max(n, 1) - mean ** 2, 1e-12))
        return mean.astype(np.float32), std.astype(np.float32)

    def class_id(self, stem: str) -> int:
        """1 + the index of the object (the stem's directory); 0 is the
        background."""
        return 1 + self.classes.index(stem.split("/")[0])

    def __len__(self) -> int:
        return len(self.items)

    def load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Item `index`'s colour image (H, W, 3) uint8 and label (H, W)
        uint8 (255 on the object)."""
        stem = self.items[index]
        img = io.read_color(os.path.join(self.data_root, stem + ".color.png"))
        label = io.read_label(os.path.join(
            self.label_root, f"{stem}.{self.label_mode}.label.png"))
        return img, label

    def augment(self, img: np.ndarray, label: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Colour jitter, the joint rotation and the crop-and-zoom."""
        img = aug.color_jitter(img, rng=self.rng)
        angle = self.rng.uniform(-180.0, 180.0)
        img, label = aug.rotate_joint(angle, img, label)
        return aug.CropAndZoom(self.output_size, rng=self.rng)(img, label)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img, label = self.load(index)
        if self.mode == "train":
            img, label = self.augment(img, label)
        image = img.astype(np.float32) / 255.0
        image = (image - self.mean) / self.std
        target = np.zeros(label.shape[:2], np.int32)
        target[label == 255] = self.class_id(self.items[index])
        return {"image": image.astype(np.float32), "label": target}
