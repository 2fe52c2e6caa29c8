"""The application entry points (port of the part of
`autoposeestimation_tpu/main.py::App` that offline labeling, segmentation
and pose training, live prediction and grasping need).

    app = App(root)
    app.create_labels(["mug"], mode="gen")                         # cuda
    app.create_dataset(["mug"], "segmentation", "synth", mode="gen")
    app.train_segmentation("synth")
    app.create_pose_data("synth", global_regression=False)

label the recorded scans under `<root>/data_generation/data/<object>/`:
classical background-subtraction masks ('gen'), or the learned 7-channel
model's ('pred', `<root>/background_subtraction/trained_models/
Unet_resnet34.ckpt.npz`), each as `<root>/label_generator/data/<object>/
<run>/NNNNNN.<mode>.label.png`; write a dataset's train/test lists; and
re-label with the dataset's trained U-Net (Phase A), reconstruct each
object (Phase B) and fit its pose labels (Phase C).

    from autoposeestimation_tpu_torch.main import App
    App(root).train_segmentation("synth", epochs=500)             # cuda

trains the segmentation U-Net from the dataset under
`<root>/label_generator/data_sets/segmentation/<ds_name>` and writes
`<root>/segmentation/trained_models/<ds_name>/Unet_resnet34.ckpt.npz`, the
weights that serving loads, and logs.json.

    App(root).train_pose_estimation("synth", epochs=500)          # cuda
    App(root).train_pose_estimation("synth", device="cpu", ...)

trains DenseFusion from the dataset that labeling wrote under
`<root>/label_generator/data_sets/pose_estimation/<ds_name>` and writes
`<root>/DenseFusion/trained_models/<ds_name>/`: pose_model.npz,
pose_refine_model.npz, losses.json, trainer_resume.npz and
logs/images/ (test_images_epoch_<N>.png, losses.png).

    app = App(root, camera_factory=..., controller_factory=...)
    app.run_live_prediction("synth", pipelined=True, batch=4)
    app.grasp("synth", "mug", confirm=...)

serve a camera (one frame at a time, or through `predict.serve_stream`)
and grasp an object with the hand-eye transform of
`<root>/hand_eye_calibration/data/handEye_tf.json`.

    app.acquire_new_data_from_object("mug", path_data=paths.load_path(p))
    app.visualise("segmentation masks", "mug")

scan an object (a background and a foreground run, or the reference's
full scan of turns) into `<root>/data_generation/data/<object>/`, and
show a run's masks or pose labels.

    python -m autoposeestimation_tpu_torch.main --root W [--device cpu]

runs the menu of every action on workspace W. The menu calls each action
with no arguments, so every action runs on the App's `device` (`--device`,
cuda by default).
"""
from __future__ import annotations

import argparse
import collections
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from . import weights
from .acquisition import get_data as gd
from .data import loader, pose_dataset, segmentation_dataset
from .hardware import camera as camera_mod
from .hardware import hand_eye
from .hardware import robot as robot_mod
from .labeling import create_labels as cl
from .labeling import make_dataset
from .models.unet import UNet
from .pipeline import grasping, predict, tui
from .pipeline import visualize as viz
from .train import checkpoints
from .train import densefusion as dft
from .train import segmentation as seg
from .utils import io
from .utils.device import resolve_device

# the 12-colour overlay table
COLOR_DICT = {
    name: {"tag": tag, "value": value}
    for name, tag, value in [
        ("red", "r", (255, 0, 0)), ("green", "g", (0, 255, 0)),
        ("blue", "b", (0, 0, 255)), ("yellow", "y", (255, 255, 0)),
        ("cyan", "c", (0, 255, 255)), ("magenta", "m", (255, 0, 255)),
        ("orange", "o", (255, 128, 0)), ("purple", "p", (128, 0, 255)),
        ("lime", "l", (128, 255, 0)), ("teal", "t", (0, 128, 128)),
        ("pink", "k", (255, 128, 192)), ("white", "w", (255, 255, 255)),
    ]
}

REFERENCE_POINT = np.asarray([0.0, -767.5, 0.0])


@dataclass
class App:
    root: str
    camera_factory: Callable = None
    controller_factory: Callable = None
    input_fn: Callable[[str], str] = input
    print_fn: Callable[[str], None] = print
    reference_point: np.ndarray = field(
        default_factory=lambda: REFERENCE_POINT.copy())
    # where an action runs when it is given no device (the menu gives none)
    device: Optional[str] = None

    def _device(self, device):
        return self.device if device is None else device

    def _select_objects(self, multi: bool = True):
        return tui.get_selection("objects", io.list_objects(self.root),
                                 multi=multi, add_all=True,
                                 input_fn=self.input_fn,
                                 print_fn=self.print_fn)

    def _select_dataset(self, kind: str = "segmentation"):
        base = os.path.join(self.root, "label_generator", "data_sets", kind)
        names = sorted(os.listdir(base)) if os.path.isdir(base) else []
        return tui.get_selection(f"{kind} dataset", names,
                                 input_fn=self.input_fn,
                                 print_fn=self.print_fn)

    def _load_hand_eye(self) -> np.ndarray:
        """The calibrated end-effector -> camera transform (mm), or the
        identity where none was saved."""
        path = os.path.join(self.root, "hand_eye_calibration", "data",
                            "handEye_tf.json")
        if os.path.exists(path):
            return hand_eye.load_hand_eye(path)
        return np.eye(4)

    def _load_seg_model(self, ds_name: str, num_classes: int, device=None
                        ) -> UNet:
        """The dataset's trained segmentation U-Net (f32, eval mode) on
        `device` (cuda unless given)."""
        model = UNet(num_classes)
        model.load_state_dict(weights.unet_state_dict(
            checkpoints.load_checkpoint(os.path.join(
                self.root, "segmentation", "trained_models", ds_name,
                "Unet_resnet34.ckpt"))["variables"]))
        return model.eval().to(resolve_device(self._device(device)))

    def _load_bs_model(self, device=None) -> UNet:
        """The learned background subtraction U-Net (7 channels, 2 classes,
        f32, eval mode) of `<root>/background_subtraction/trained_models/
        Unet_resnet34.ckpt.npz`, on `device` (cuda unless given)."""
        model = UNet(2, in_ch=7)
        model.load_state_dict(weights.unet_state_dict(
            checkpoints.load_checkpoint(os.path.join(
                self.root, "background_subtraction", "trained_models",
                "Unet_resnet34.ckpt"))["variables"]))
        return model.eval().to(resolve_device(self._device(device)))

    # the reference's full scan (main.py:103-135): background, an
    # upright foreground run, a 180-degree turn and three 90-degree turns
    DEFAULT_RUNS = {
        "background": {"a": 0, "b": 0, "c": 0},
        "foreground": {"a": 0, "b": 0, "c": 0},
        "foreground180": {"a": 0, "b": 0, "c": 180},
        "foreground90": {"a": 90, "b": 0, "c": 0},
        "foreground90_2": {"a": 90, "b": 0, "c": 90},
        "foreground90_3": {"a": 90, "b": 0, "c": 180},
    }

    def acquire_new_data_from_object(self, name: Optional[str] = None,
                                     path_data: Optional[Dict] = None,
                                     runs: Optional[Dict] = None,
                                     symmetric: int = 0,
                                     continue_at: Optional[str] = None,
                                     with_turns: bool = False) -> int:
        """Scan the object (asked for in the TUI unless given) along the
        viewpoint path `path_data`: a background and a foreground run, or
        with `with_turns` every run of DEFAULT_RUNS. `runs` maps
        run name -> object_pose dict (the turn declared for that run);
        `continue_at` resumes the scan at a named run. Each run starts
        from home. Host-side only: nothing runs on the card. Returns the
        viewpoint samples captured."""
        name = name or self.input_fn("object name> ").strip()
        camera = self.camera_factory()
        controller = self.controller_factory()
        hand_eye_tf = self._load_hand_eye()
        if runs is None:
            runs = (dict(self.DEFAULT_RUNS) if with_turns else {
                "background": {"a": 0, "b": 0, "c": 0},
                "foreground": {"a": 0, "b": 0, "c": 0},
            })
        total = 0
        started = continue_at is None
        for run, object_pose in runs.items():
            if not started:
                if run == continue_at:
                    started = True
                else:
                    continue
            if run != "background":
                self.print_fn(f"place/turn object for run '{run}' "
                              f"(pose {object_pose})")
            if not controller.is_home():
                controller.move_joints(np.deg2rad(
                    np.asarray(robot_mod.HOME_JOINTS_DEG)))
                while controller.is_moving():
                    time.sleep(0.05)
            total += gd.get_data(camera, controller, path_data, self.root,
                                 name, run, object_pose, symmetric=symmetric,
                                 hand_eye_calibration=hand_eye_tf)
        return total

    def create_labels(self, objects=None, mode: str = "gen",
                      device=None) -> int:
        """Label every foreground sample of the objects (chosen in the TUI
        unless given) on `device` (cuda unless given): 'gen' the classical
        background subtraction, otherwise the learned model ('pred').
        Returns the number of labels written."""
        objects = objects or self._select_objects()
        model = None if mode == "gen" else self._load_bs_model(device)
        total = 0
        for obj in objects:
            t0 = time.time()
            if model is None:
                total += cl.create_labels(
                    obj, self.root, reference_point=self.reference_point,
                    device=self._device(device))
            else:
                total += cl.create_mask_predictions(
                    obj, self.root, model,
                    reference_point=self.reference_point)
            self.print_fn(f"{obj}: {time.time() - t0:.1f}s")
        return total

    def create_pose_data(self, ds_name: Optional[str] = None,
                         global_regression: bool = False,
                         device=None) -> Dict:
        """Phases A-C of the offline labeling for the classes of a
        segmentation dataset, with its trained U-Net, on `device` (cuda
        unless given): new_pred labels, the reconstructed clouds and the
        pose labels. Returns {"stats", "times"}."""
        ds_name = ds_name or self._select_dataset("segmentation")
        classes = io.read_lines(os.path.join(
            io.dataset_dir(self.root, "segmentation", ds_name),
            "classes.txt"))
        model = self._load_seg_model(ds_name, len(classes) + 1, device)
        return cl.create_pose_data(
            self.root, classes, ds_name, model, self.reference_point,
            global_regression=global_regression,
            device=self._device(device))

    def create_dataset(self, objects=None, kind: str = "segmentation",
                       save_name: Optional[str] = None, mode: str = "pred",
                       p_test: float = 0.2) -> Dict:
        """Write a segmentation or pose_estimation dataset's lists from the
        objects' `mode` labels (pose datasets also list the extra run)."""
        objects = objects or self._select_objects()
        save_name = save_name or self.input_fn("dataset name> ").strip()
        return make_dataset.make_train_and_test_dataset(
            self.root, objects, kind, save_name, p_test=p_test, mode=mode,
            use_extra_data=(kind == "pose_estimation"))

    def train_segmentation(self, ds_name: Optional[str] = None,
                           epochs: Optional[int] = None, device=None,
                           **overrides) -> Dict:
        """Train the dataset's segmentation U-Net on `device` (cuda by
        default) in bf16, on 480-pixel crops; `overrides` set `SegConfig`
        fields. Writes `<root>/segmentation/trained_models/<ds_name>/
        Unet_resnet34.ckpt.npz` (the best valid mIoU) and logs.json beside
        it."""
        ds_name = ds_name or self._select_dataset("segmentation")
        classes = io.read_lines(os.path.join(
            io.dataset_dir(self.root, "segmentation", ds_name),
            "classes.txt"))
        cfg = seg.SegConfig(classes=len(classes) + 1, **overrides)
        if epochs is not None:
            cfg.epochs = epochs
        train_ds, valid_ds = (segmentation_dataset.SegmentationDataset(
            self.root, ds_name, mode=mode, label_mode="pred")
            for mode in ("train", "test"))
        out_dir = os.path.join(self.root, "segmentation", "trained_models",
                               ds_name)
        return seg.segmentation_training(
            lambda: loader.Loader(train_ds, cfg.batch_size),
            lambda: loader.Loader(valid_ds, cfg.batch_size, shuffle=False,
                                  drop_last=False),
            cfg, out_dir=out_dir, device=self._device(device))

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
                                   device=self._device(device))
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

    def run_live_prediction(self, ds_name: Optional[str] = None,
                            max_frames: Optional[int] = None,
                            frame_callback=None, models=None,
                            pipelined: bool = False, in_flight: int = 4,
                            batch: int = 1, device=None) -> int:
        """The live loop: capture, predict, report, for `max_frames` frames
        (None: until the camera fails); returns the frame count. Blocking,
        one `full_prediction` a frame, or with `pipelined` through
        `predict.serve_stream` (`in_flight` calls outstanding, `batch`
        frames a call; results still come one frame at a time, in order).
        Each frame prints an `fps:` line and goes to `frame_callback(frames,
        prediction)`. `models` injects built `PredictionModels`; by default
        the dataset's trained weights are loaded on `device` (cuda unless
        given)."""
        if models is None:
            ds_name = ds_name or self._select_dataset("segmentation")
            models = predict.get_prediction_models(
                self.root, ds_name, device=self._device(device))
        camera = self.camera_factory()
        meta = {"intr": camera.get_intrinsics(),
                "depth_scale": camera.get_depth_scale()}
        n = 0
        if pipelined:
            raw = collections.deque()

            def capture():
                m = 0
                while max_frames is None or m < max_frames:
                    frames = camera.get_frames(with_repair=True)
                    if frames is None:
                        return
                    raw.append(frames)
                    yield frames["image"], frames["depth"], meta
                    m += 1

            t0 = time.time()
            for out in predict.serve_stream(capture(), models,
                                            in_flight=in_flight,
                                            batch=batch):
                frames = raw.popleft()
                n += 1
                fps = n / max(time.time() - t0, 1e-9)
                self.print_fn(f"fps: {fps:.1f}  objects: "
                              f"{list(out['predictions'])}")
                if frame_callback is not None:
                    frame_callback(frames, out)
            return n
        while max_frames is None or n < max_frames:
            frames = camera.get_frames(with_repair=True)
            if frames is None:
                break
            t0 = time.time()
            out = predict.full_prediction(frames["image"], frames["depth"],
                                          meta, models)
            fps = 1.0 / max(time.time() - t0, 1e-9)
            self.print_fn(f"fps: {fps:.1f}  objects: "
                          f"{list(out['predictions'])}")
            if frame_callback is not None:
                frame_callback(frames, out)
            n += 1
        return n

    def teach_grasping(self, ds_name: str, cls: str, prediction: Dict) -> None:
        """Store the robot's current pose (m) as the grasp of `cls` for the
        predicted object pose `prediction` (position, rotation)."""
        pose = self.controller_factory().get_pose(return_mm=False)
        grasping.save_grasping_delta(self.root, ds_name, cls,
                                     prediction["position"],
                                     prediction["rotation"], pose)

    def grasp(self, ds_name: str, cls: str, confirm=None,
              device=None) -> bool:
        """Predict from the 5 view points with the dataset's trained
        weights (on `device`, cuda unless given) and grasp `cls` by its
        taught delta."""
        models = predict.get_prediction_models(
            self.root, ds_name, device=self._device(device))
        return grasping.execute_grasp(
            self.controller_factory(), self.camera_factory(),
            self._load_hand_eye(), models, self.root, ds_name, cls,
            confirm=confirm)

    def visualise(self, kind: Optional[str] = None, obj: Optional[str] = None,
                  run: str = "foreground", mode: str = "gen",
                  show=None) -> int:
        """The mask-overlay or pose-label slideshow of a run (kind and
        object asked for in the TUI unless given). `show(frame)` receives
        each uint8 frame (by default matplotlib, where it is installed);
        returns the frame count."""
        kind = kind or tui.get_selection(
            "visualisation", ["segmentation masks", "pose labels"],
            input_fn=self.input_fn, print_fn=self.print_fn)
        obj = obj or self._select_objects(multi=False)
        if show is None:
            def show(frame):
                try:
                    import matplotlib.pyplot as plt

                    plt.imshow(frame)
                    plt.pause(0.05)
                except Exception:
                    pass

        token = viz.CancellationToken()
        gen = (viz.visualise_segmentation_masks(self.root, obj, run, mode,
                                                token=token)
               if kind == "segmentation masks"
               else viz.visualise_pose_labels(self.root, obj, run,
                                              token=token))
        n = 0
        for frame in gen:
            show(frame)
            n += 1
        return n

    ACTIONS = [
        ("acquire new data from object", "acquire_new_data_from_object"),
        ("create labels", "create_labels"),
        ("create pose labels", "create_pose_data"),
        ("create data set", "create_dataset"),
        ("train segmentation", "train_segmentation"),
        ("train pose estimation", "train_pose_estimation"),
        ("run live prediction", "run_live_prediction"),
        ("visualise", "visualise"),
        ("teach grasping", "teach_grasping"),
        ("grasp", "grasp"),
        ("quit", None),
    ]

    def main(self) -> None:
        """The menu loop: choose an action, run it with no arguments, until
        'quit'. A failing action prints 'action failed: ...' and the loop
        goes on."""
        while True:
            choice = tui.get_selection(
                "action", [a for a, _ in self.ACTIONS],
                input_fn=self.input_fn, print_fn=self.print_fn)
            method = dict(self.ACTIONS).get(choice)
            if method is None:
                return
            try:
                getattr(self, method)()
            except Exception as exc:  # surface, keep the loop alive
                self.print_fn(f"action failed: {exc}")


def main() -> None:
    """`python -m autoposeestimation_tpu_torch.main --root W [--device D]`:
    the menu on workspace W, with a RealSense camera where its SDK finds
    one (else the synthetic FakeDepthCam) and the FakeRobot; every action
    runs on D (cuda by default)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.getcwd())
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    resolve_device(args.device)

    def camera_factory():
        try:
            cam = camera_mod.RealSenseCam()
        except Exception:
            cam = camera_mod.FakeDepthCam()
        print(f"camera: {type(cam).__name__}")
        return cam

    def controller_factory():
        return robot_mod.FakeRobot()

    App(args.root, camera_factory, controller_factory,
        device=args.device).main()


if __name__ == "__main__":
    main()
