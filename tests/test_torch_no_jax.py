"""The port runs without JAX: every module of `autoposeestimation_tpu_torch`
imports in a fresh interpreter where `jax` and `autoposeestimation_tpu`
cannot be imported, and none of them is loaded afterwards. On a card (marker
`cuda`; this file imports no JAX, so it runs there) `serve_stream` serves
without one host sync."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

PROBE = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "autoposeestimation_tpu"):
    sys.modules[blocked] = None          # any import of it raises
import autoposeestimation_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
    or k == "autoposeestimation_tpu"
    or k.startswith("autoposeestimation_tpu.")))
print(len(names), loaded)
"""


def test_port_imports_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.split(" ", 1)
    assert int(count) >= 84
    assert loaded.strip() == "[]"


def test_port_imports_without_pil_or_matplotlib():
    """The port needs neither Pillow, matplotlib, the RealSense SDK,
    OpenCV nor PyYAML: every port module imports with them blocked too,
    and none loads them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = PROBE.replace(
        '"autoposeestimation_tpu"):',
        '"autoposeestimation_tpu", "PIL", "matplotlib", "pyrealsense2",'
        ' "cv2", "yaml"):'
    ).replace(
        'or k == "autoposeestimation_tpu"',
        'or k in ("autoposeestimation_tpu", "PIL", "matplotlib")'
        ' or k.split(".")[0] in ("PIL", "matplotlib", "pyrealsense2",'
        ' "cv2", "yaml")')
    assert probe.count("PIL") == 3 and probe.count("pyrealsense2") == 2
    assert probe.count("cv2") == probe.count("yaml") == 2
    res = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.split(" ", 1)
    assert int(count) >= 84
    assert loaded.strip() == "[]"


SEG_PROBE = """
import sys
for blocked in ("jax", "jaxlib", "flax", "optax", "autoposeestimation_tpu",
                "PIL", "matplotlib", "pyrealsense2"):
    sys.modules[blocked] = None
import torch
from autoposeestimation_tpu_torch.data import segmentation_dataset
from autoposeestimation_tpu_torch.models import seg_variants, segnet
from autoposeestimation_tpu_torch.train import segmentation as seg
from autoposeestimation_tpu_torch.train import vanilla_segnet
assert not torch.cuda.is_available()
raised = []
for call in (
        lambda: seg.segmentation_training(lambda: iter(()), lambda: iter(()),
                                          seg.SegConfig(epochs=0), sys.argv[1]),
        lambda: vanilla_segnet.train_vanilla_segnet(
            lambda: iter(()), lambda: iter(()), 2, n_epochs=1,
            log_dir=sys.argv[1], model_save_path=sys.argv[1])):
    try:
        call()
    except RuntimeError as exc:
        raised.append("device='cpu'" in str(exc))
print(raised)
"""


def test_segmentation_slice_without_jax_pil_or_a_card(tmp_path):
    """The segmentation training modules import with JAX, the JAX package,
    Pillow, matplotlib and the RealSense SDK blocked, and their entry
    points default to cuda: without a card they raise, naming
    device='cpu'."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", SEG_PROBE, str(tmp_path)],
                         cwd=root, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ,
                                               CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[True, True]"


NEW_MODULES = ["utils.flops", "utils.train_stages", "utils.serving_stages",
               "utils.timing", "scripts", "scripts.stream_logs",
               "scripts.view_data", "scripts.train_synthetic_demo",
               "scripts.train_multi_demo", "scripts.attribute_serving",
               "scripts.mask_iou", "scripts.gate_symbf16",
               "scripts.train_bench_seg"]

STAGES_PROBE = """
import importlib, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "autoposeestimation_tpu",
                "PIL", "matplotlib", "pyrealsense2", "cv2", "yaml"):
    sys.modules[blocked] = None
import torch
assert not torch.cuda.is_available()
port = "autoposeestimation_tpu_torch."
for name in sys.argv[2:]:
    importlib.import_module(port + name)
from autoposeestimation_tpu_torch.utils import (flops, serving_stages,
                                                train_stages)
from autoposeestimation_tpu_torch.scripts import (
    attribute_serving, mask_iou, train_bench_seg, train_multi_demo,
    train_synthetic_demo)
out = sys.argv[1]
raised = []
for call in (
        lambda: train_stages.build_stages(num_obj=1, bs=2, n=8, m=8, crop=32),
        lambda: serving_stages.build_prefixes(num_classes=1, num_points=8,
                                              crop=32, h=48, w=64),
        lambda: flops.count_flops("train_stage_symloss_fwd"),
        lambda: train_multi_demo.main(["--out", out]),
        lambda: train_synthetic_demo.main(["--out", out]),
        lambda: attribute_serving.main(["--out", out]),
        lambda: mask_iou.main(["--out", out]),
        lambda: train_bench_seg.main(["--out", out])):
    try:
        call()
    except RuntimeError as exc:
        raised.append("device='cpu'" in str(exc))
import os
print(raised, os.listdir(out))
"""


def test_stages_flops_and_scripts_without_jax_or_a_card(tmp_path):
    """This slice's modules (the train stages, the serving prefixes, the
    FLOP counts, the timing utilities and every script) import with JAX,
    the JAX package and the host extras blocked; their entry points default to cuda, so
    without a card each raises, naming device='cpu', before it writes
    anything."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", STAGES_PROBE, str(tmp_path),
                          *NEW_MODULES], cwd=root, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[" + ", ".join(["True"] * 8) + "] []"


ENTRY_PROBE = """
import sys
for blocked in ("jax", "jaxlib", "flax", "optax", "autoposeestimation_tpu",
                "PIL", "matplotlib", "pyrealsense2", "cv2", "yaml"):
    sys.modules[blocked] = None
from autoposeestimation_tpu_torch import graft_entry
from autoposeestimation_tpu_torch.parallel import dryrun, trainers
try:
    graft_entry.entry()
    raised = False
except RuntimeError as exc:
    raised = "device='cpu'" in str(exc)
try:
    trainers.run_trainers("toy", 1)
    raised_trainers = False
except RuntimeError as exc:
    raised_trainers = "device='cpu'" in str(exc)
print(raised, raised_trainers,
      graft_entry.dryrun_multichip is dryrun.dryrun_multichip)
"""


def test_graft_entry_without_jax_or_a_card():
    """`graft_entry` (the counterpart of `__graft_entry__.py`) and
    `parallel/trainers.py` import with JAX, the JAX package and the host
    extras blocked; without a card `entry()` and `run_trainers()` raise,
    naming device='cpu', and `dryrun_multichip` is the dry run's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", ENTRY_PROBE], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "True", "True"]


@pytest.mark.cuda
def test_serve_stream_never_syncs_the_host():
    """`serve_stream` at batch 1 and 2 on the card, every dispatch and
    read under `torch.cuda.set_sync_debug_mode("error")`: it raises on any
    call that makes the host wait for the stream (a `.item()`, a pageable
    copy, a `nonzero`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the host-sync check is CUDA's")
    from autoposeestimation_tpu_torch.pipeline import predict
    from autoposeestimation_tpu_torch.utils import synthetic
    from autoposeestimation_tpu_torch.utils.io import Intrinsics

    cfg = synthetic.SynthConfig(img_h=96, img_w=128, fx=220.0, fy=220.0)
    spheres = [synthetic.SphereObject("a", np.asarray([40.0, 0.0, 35.0]),
                                      35.0, (200, 40, 40))]
    frames = []
    for cam in synthetic.ring_cameras(cfg, np.zeros(3))[:3]:
        color, depth, _ = synthetic.render(cfg, cam, spheres)
        frames.append((color, np.round(depth).astype(np.uint16), {
            "intr": Intrinsics(width=128, height=96, ppx=64.0, ppy=48.0,
                               fx=220.0, fy=220.0), "depth_scale": 0.001}))
    models = predict.build_models(
        1, np.zeros((1, 8, 3), np.float32), ("a",), num_points=64, crop=32,
        refine_iters=1, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in (1, 2):
        list(predict.serve_stream(frames, models, in_flight=2, batch=batch,
                                  generator=gen))      # builds and warms up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = list(predict.serve_stream(frames, models, in_flight=2,
                                             batch=batch, generator=gen))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert len(outs) == 3
