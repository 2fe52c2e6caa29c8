"""Depth cameras (port of `autoposeestimation_tpu/hardware/camera.py`).

`DepthCamBase` is the capture interface the serving and acquisition layers
use: `get_frames` (with the self-repair loop that re-opens the pipeline
after a failed frame, and the draining of stale frames), `check_state`,
`get_intrinsics`, `get_depth_scale`. `RealSenseCam` drives a RealSense
through pyrealsense2, which it imports only when constructed, so this
module imports without it. `FakeDepthCam` ray-traces the synthetic scene
(`utils/synthetic.py`) and `PlaybackDepthCam` plays back a recorded run.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

from ..utils import io, synthetic


class DepthCamBase:
    """The capture interface the acquisition and serving layers use."""

    def get_frames(self, with_repair: bool = False,
                   secure_image: bool = False,
                   return_first: bool = False) -> Optional[Dict]:
        raise NotImplementedError

    def get_intrinsics(self) -> io.Intrinsics:
        raise NotImplementedError

    def get_depth_scale(self) -> float:
        raise NotImplementedError

    def check_state(self, n_probe: int = 10) -> bool:
        """True if the next `n_probe` frames all arrive."""
        for _ in range(n_probe):
            if self.get_frames() is None:
                return False
        return True

    def stream(self, max_frames: int = 0, show=None) -> int:
        """Show frames until one fails or `max_frames` (0: no limit) have
        been shown; returns the count. `show(frames)` displays one; by
        default matplotlib, where it is installed."""
        if show is None:
            def show(frames):
                try:
                    import matplotlib.pyplot as plt
                except ImportError:
                    return
                plt.imshow(frames["image"])
                plt.pause(0.01)

        n = 0
        while max_frames <= 0 or n < max_frames:
            frames = self.get_frames()
            if frames is None:
                break
            show(frames)
            n += 1
        return n

    def close(self) -> None:
        pass


class RealSenseCam(DepthCamBase):
    """pyrealsense2-backed camera (depth z16 + color rgb8, aligned to color,
    fixed exposure/white balance). Raises ImportError without the SDK."""

    def __init__(self, fps: int = 30, width: int = 640, height: int = 480,
                 exposure: float = 600.0, white_balance: float = 3700.0):
        import pyrealsense2 as rs  # noqa: F401  (hardware-only dependency)

        self._rs = rs
        self.fps = fps
        self.width = width
        self.height = height
        self.exposure = exposure
        self.white_balance = white_balance
        self._init_pipeline()

    def _init_pipeline(self) -> None:
        rs = self._rs
        self.pipeline = rs.pipeline()
        config = rs.config()
        config.enable_stream(rs.stream.depth, self.width, self.height,
                             rs.format.z16, self.fps)
        config.enable_stream(rs.stream.color, self.width, self.height,
                             rs.format.rgb8, self.fps)
        self.profile = self.pipeline.start(config)
        self.align = rs.align(rs.stream.color)
        sensor = self.profile.get_device().query_sensors()[1]
        sensor.set_option(rs.option.enable_auto_exposure, 0)
        sensor.set_option(rs.option.exposure, self.exposure)
        sensor.set_option(rs.option.enable_auto_white_balance, 0)
        sensor.set_option(rs.option.white_balance, self.white_balance)

    def _grab(self) -> Optional[Dict]:
        frames = self.pipeline.wait_for_frames()
        frames = self.align.process(frames)
        depth = frames.get_depth_frame()
        color = frames.get_color_frame()
        if not depth or not color:
            return None
        return {"image": np.asanyarray(color.get_data()),
                "depth": np.asanyarray(depth.get_data())}

    def get_frames(self, with_repair: bool = False,
                   secure_image: bool = False,
                   return_first: bool = False) -> Optional[Dict]:
        if secure_image:
            # drain ~1 s of stale frames
            t0 = time.time()
            while time.time() - t0 < 1.0:
                try:
                    self._grab()
                except Exception:
                    break
        while True:
            try:
                out = self._grab()
                if out is not None:
                    return out
            except Exception:
                out = None
            if return_first:
                return out
            if not with_repair:
                return None
            # self-repair: reinitialize the pipeline
            try:
                self.pipeline.stop()
            except Exception:
                pass
            time.sleep(0.5)
            self._init_pipeline()

    def get_intrinsics(self) -> io.Intrinsics:
        rs = self._rs
        stream = self.profile.get_stream(rs.stream.color)
        i = stream.as_video_stream_profile().get_intrinsics()
        return io.Intrinsics(width=i.width, height=i.height, ppx=i.ppx,
                             ppy=i.ppy, fx=i.fx, fy=i.fy,
                             coeffs=list(i.coeffs))

    def get_depth_scale(self) -> float:
        return self.profile.get_device().first_depth_sensor().get_depth_scale()

    def close(self) -> None:
        try:
            self.pipeline.stop()
        except Exception:
            pass


class FakeDepthCam(DepthCamBase):
    """Synthetic camera: renders the scene from a pose provided by a callable
    (e.g. the fake robot's current robot2cam), with optional injected frame
    failures to exercise the repair path."""

    def __init__(self, cfg: Optional[synthetic.SynthConfig] = None,
                 spheres=None,
                 robot2cam_fn: Optional[Callable[[], np.ndarray]] = None,
                 fail_every: int = 0):
        self.cfg = cfg or synthetic.SynthConfig()
        self.spheres = spheres if spheres is not None else [
            synthetic.SphereObject("obj", np.asarray([30.0, 10.0, 40.0]),
                                   40.0, (210, 50, 50))]
        self.robot2cam_fn = robot2cam_fn or (
            lambda: synthetic.ring_cameras(self.cfg, np.zeros(3))[0])
        self.fail_every = fail_every
        self._count = 0
        self.repairs = 0

    def get_frames(self, with_repair: bool = False,
                   secure_image: bool = False,
                   return_first: bool = False) -> Optional[Dict]:
        self._count += 1
        if self.fail_every and self._count % self.fail_every == 0:
            if with_repair:
                self.repairs += 1  # "repair" and fall through to a good frame
            elif return_first:
                return None
            else:
                return None
        color, depth, _ = synthetic.render(self.cfg, self.robot2cam_fn(),
                                           self.spheres)
        return {"image": color,
                "depth": np.round(depth).astype(np.uint16)}

    def get_intrinsics(self) -> io.Intrinsics:
        c = self.cfg
        return io.Intrinsics(width=c.img_w, height=c.img_h, ppx=c.img_w / 2.0,
                             ppy=c.img_h / 2.0, fx=c.fx, fy=c.fy)

    def get_depth_scale(self) -> float:
        return self.cfg.depth_scale


class PlaybackDepthCam(DepthCamBase):
    """Plays back a recorded acquisition run (object/run directory)."""

    def __init__(self, run_dir: str, loop: bool = True):
        self.run_dir = run_dir
        self.ids = io.list_sample_ids(run_dir)
        if not self.ids:
            raise ValueError(f"no samples in {run_dir}")
        self.loop = loop
        self.index = 0
        meta = io.read_sample_meta(
            f"{run_dir}/{self.ids[0]}.meta.json")
        self._intr = meta["intr"]
        self._depth_scale = float(meta["depth_scale"])

    def get_frames(self, with_repair: bool = False,
                   secure_image: bool = False,
                   return_first: bool = False) -> Optional[Dict]:
        if self.index >= len(self.ids):
            if not self.loop:
                return None
            self.index = 0
        stem = self.ids[self.index]
        self.index += 1
        return {
            "image": io.read_color(f"{self.run_dir}/{stem}.color.png"),
            "depth": io.read_depth(f"{self.run_dir}/{stem}.depth.png"),
        }

    def get_intrinsics(self) -> io.Intrinsics:
        return self._intr

    def get_depth_scale(self) -> float:
        return self._depth_scale
