"""The application entry points (port of the part of
`autoposeestimation_tpu/main.py::App` that pose training needs).

    from autoposeestimation_tpu_torch.main import App
    App(root).train_pose_estimation("synth", epochs=500)          # cuda
    App(root).train_pose_estimation("synth", device="cpu", ...)

trains DenseFusion from the dataset that labeling wrote under
`<root>/label_generator/data_sets/pose_estimation/<ds_name>` and writes
`<root>/DenseFusion/trained_models/<ds_name>/`: pose_model.npz,
pose_refine_model.npz, losses.json, trainer_resume.npz and
logs/images/ (test_images_epoch_<N>.png, losses.png).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

from .data import loader, pose_dataset
from .pipeline import tui
from .train import densefusion as dft
from .utils import io


@dataclass
class App:
    root: str
    input_fn: Callable[[str], str] = input
    print_fn: Callable[[str], None] = print

    def _select_dataset(self, kind: str = "segmentation"):
        base = os.path.join(self.root, "label_generator", "data_sets", kind)
        names = sorted(os.listdir(base)) if os.path.isdir(base) else []
        return tui.get_selection(f"{kind} dataset", names,
                                 input_fn=self.input_fn,
                                 print_fn=self.print_fn)

    def train_pose_estimation(self, ds_name: Optional[str] = None,
                              epochs: Optional[int] = None,
                              p_viewpoints: float = 1.0,
                              p_extra_data: float = 0.0,
                              warm_start: Optional[str] = None,
                              warm_start_refine: Optional[str] = None,
                              device=None, **overrides) -> dft.TrainerState:
        """Two-phase DenseFusion training on `device` (cuda by default).
        `overrides` set `DFConfig` fields. warm_start/warm_start_refine:
        pretrained weights (.pth or .npz) loaded with head re-init;
        start_epoch > 1 resumes the run's trainer_resume snapshot."""
        ds_name = ds_name or self._select_dataset("pose_estimation")
        classes = io.read_lines(os.path.join(
            io.dataset_dir(self.root, "pose_estimation", ds_name),
            "classes.txt"))
        cfg = dft.DFConfig(**overrides)
        state = dft.create_trainer(num_obj=len(classes), cfg=cfg,
                                   device=device)
        if warm_start:
            dft.warm_start(state, warm_start, warm_start_refine)
        train_ds = pose_dataset.PoseDataset(
            self.root, ds_name, mode="train", num_pt=cfg.num_points,
            num_pt_mesh=cfg.num_points_mesh, p_viewpoints=p_viewpoints,
            p_extra_data=p_extra_data)
        test_ds = pose_dataset.PoseDataset(
            self.root, ds_name, mode="test", num_pt=cfg.num_points,
            num_pt_mesh=cfg.num_points_mesh)
        out_dir = os.path.join(self.root, "DenseFusion", "trained_models",
                               ds_name)
        if cfg.start_epoch > 1:
            dft.resume_trainer(state, out_dir)
        # the per-epoch pose images come from a copy of the test set that
        # keeps the raw frames
        image_ds = pose_dataset.PoseDataset(
            self.root, ds_name, mode="test", num_pt=cfg.num_points,
            num_pt_mesh=cfg.num_points_mesh, return_raw=True)
        return dft.train(
            state,
            lambda: loader.Loader(train_ds, cfg.batch_size),
            lambda: loader.Loader(test_ds, cfg.batch_size, shuffle=False,
                                  drop_last=False),
            out_dir=out_dir, epochs=epochs,
            image_dump_dir=os.path.join(out_dir, "logs", "images"),
            image_batches=lambda: loader.Loader(
                image_ds, cfg.batch_size, shuffle=False, drop_last=False))
