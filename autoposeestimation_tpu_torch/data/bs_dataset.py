"""The learned background subtraction model's 7-channel dataset (port of
`autoposeestimation_tpu/data/bs_dataset.py`, whose docstring lists the
reference behaviour kept), in numpy without Pillow.

Per class, the first `samples_per_class` views of the background run and
of the first foreground run; the split is 80/20 by object class, drawn
with `random.Random(1234)` so both modes agree. In train mode one rotation
angle in [-180, 180) and two flips, drawn from the dataset's
`random.Random(seed)` in the JAX order, go to both frames, both depths and
the label alike: `data/augment.py::rotate` takes Pillow's 16.16 fixed-point
path for the uint8 RGB and label images and its generic double transform
for the 16-bit depths ("I;16"), as `Image.rotate` does by mode. HSV is
Pillow's exact `convert("HSV")` (`augment.rgb_to_hsv`), which the model is
trained on; at inference `ops/bg_subtraction.py::build_bs_input` feeds its
float form, as in the JAX package. The channel differences are cast to
uint8 by numpy as the JAX package does (`np.asarray(x, np.uint8)`: a float
above 255, a depth difference, wraps as the platform's cast does), /255,
then normalized with BS_MEAN / BS_STD.

An item is {"image": (H, W, 7) f32, "label": (H, W) int32, 1 where the
stored mask is 255}.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np

from ..ops.bg_subtraction import BS_MEAN, BS_STD
from ..utils import io
from . import augment as aug


class BSDataset:
    def __init__(self, root: str, mode: str = "train",
                 samples_per_class: int = 23, p_test: float = 0.2,
                 label_mode: str = "gen", seed: int = 0,
                 augment: bool = True):
        self.root = root
        self.mode = mode
        self.augment = augment and mode == "train"
        self.rng = random.Random(seed)
        self.label_mode = label_mode

        objects = sorted(io.list_objects(root))
        random.Random(1234).shuffle(objects)
        n_test = max(int(len(objects) * p_test), 1) if len(objects) > 1 else 0
        test_objects = objects[:n_test]
        chosen = (test_objects if mode == "test"
                  else [o for o in objects if o not in test_objects])

        self.samples: List = []
        for obj in chosen:
            runs = [r for r in io.list_runs(root, obj)
                    if r not in ("background", "extra")]
            if not runs:
                continue
            run_dir = os.path.join(io.data_dir(root), obj, runs[0])
            for stem in io.list_sample_ids(run_dir)[:samples_per_class]:
                self.samples.append((obj, runs[0], stem))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        obj, run, stem = self.samples[index]
        dd = io.data_dir(self.root)
        bg = os.path.join(dd, obj, "background", stem)
        fg = os.path.join(dd, obj, run, stem)
        images = [io.read_color(bg + ".color.png"),
                  io.read_color(fg + ".color.png"),
                  io.read_depth(bg + ".depth.png"),
                  io.read_depth(fg + ".depth.png"),
                  io.read_label(os.path.join(
                      io.label_dir(self.root), obj, run,
                      f"{stem}.{self.label_mode}.label.png"))]

        if self.augment:
            angle = self.rng.uniform(-180.0, 180.0)
            hflip = self.rng.random() < 0.5
            vflip = self.rng.random() < 0.5

            def tx(im):
                im = aug.rotate(im, angle)
                if hflip:
                    im = np.flip(im, 1)
                if vflip:
                    im = np.flip(im, 0)
                return im

            images = [tx(im) for im in images]
        b_img, f_img, b_depth, f_depth, label = images

        b_rgb = np.asarray(b_img, np.float32)
        f_rgb = np.asarray(f_img, np.float32)
        b_hsv = aug.rgb_to_hsv(b_img).astype(np.float32)
        f_hsv = aug.rgb_to_hsv(f_img).astype(np.float32)
        b_d = np.asarray(b_depth, np.float32)
        f_d = np.asarray(f_depth, np.float32)

        # depth cleared where the other frame has no measurement
        f_d = np.where(b_d == 0, 0.0, f_d)
        b_d = np.where(f_d == 0, 0.0, b_d)

        x = np.concatenate([
            np.abs(f_rgb - b_rgb),
            np.abs(f_hsv - b_hsv),
            np.abs(f_d - b_d)[..., None],
        ], axis=2)
        x = np.asarray(x, np.uint8).astype(np.float32) / 255.0
        x = (x - np.asarray(BS_MEAN)) / np.asarray(BS_STD)

        target = (np.asarray(label, np.uint8) == 255).astype(np.int32)
        return {"image": x.astype(np.float32), "label": target}
