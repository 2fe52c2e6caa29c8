"""The SegNet training cell `train.segnet_ycb22`, added as new files: its
traced path at a tiny size on the CPU, its FLOP count by name, the plain
reference's independence, and, on the card, its two faults."""
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from harness import files
from harness import trace

BENCH = files.HERE
ROOT = os.path.dirname(BENCH)
CELL = "train.segnet_ycb22"
SMALL_LAYOUT = {
    "rings": [{"radius_mm": 90, "count": 2, "height_mm": 40,
               "sphere_mm": 45}],
    "camera": {"ring_radius_mm": 500, "height_mm": 450, "focal_px": 140}}


def tiny_cell(root: str = BENCH) -> files.Cell:
    """The cell at 64x96, batches of 2, float32 (in which the program and
    the reference meet to round-off), over a pool of 3 batches."""
    cell = files.Cell(CELL, root)
    cell.config = dict(cell.config, image_hw=[64, 96], batch_size=2,
                       dtype="float32")
    cell.traffic = dict(copy.deepcopy(cell.traffic), pool=3, trace_units=2,
                        layout=SMALL_LAYOUT)
    return cell


def _cpu_traced(work):
    """`harness/trace.py::traced` for the CPU: the work once with the
    port's tracer on, under a stand-in device trace."""
    from autoposeestimation_tpu_torch.utils import timing

    timing.reset()
    timing.enable()
    try:
        units = work()
    finally:
        timing.disable()
    return trace.Trace(1.0, 0.5, {"kernel": (100, 0.4)}, [], []), units


def test_the_traced_path_runs_at_a_tiny_size(monkeypatch):
    import run as R
    from autoposeestimation_tpu_torch.utils import timing

    monkeypatch.setattr(trace, "traced", _cpu_traced)
    cell = tiny_cell()
    try:
        out = R.run(cell, 2 ** 31 + 9, 0.3, True, "cpu", time.perf_counter())
    finally:
        timing.reset()
    w = out["window"]
    assert w["failed"] == 0 and w["kinds"] == {"segnet": w["units"]}
    assert w["samples"] == 2 * w["units"]
    assert set(out["metrics"]) == {
        "device_idle_pct.train", "launches_per_step", "mfu_pct.train",
        "forward_ms_per_step", "backward_ms_per_step",
        "optimizer_ms_per_step", "index_pool_ms_per_step"}
    flops = cell.flops()["segnet_step"]
    assert out["metrics"]["mfu_pct.train"]["value"] == pytest.approx(
        100 * flops * w["units"] / w["seconds"] / 989e12)
    assert out["metrics"]["launches_per_step"]["value"] == 50.0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values()), \
        out["checks"]


def test_the_count_is_the_configurations_own_file():
    cell = files.Cell(CELL)
    with open(os.path.join(BENCH, "counts", "flops.json")) as f:
        assert "segnet_ycb22" not in json.load(f)
    with open(os.path.join(BENCH, "counts", "segnet_ycb22",
                           "segnet_step.json")) as f:
        frozen = json.load(f)
    assert cell.flops() == {"segnet_step": frozen["flops"]}
    assert frozen["at"] == {"traffic": "segnet_b3_pool16", "batch_size": 3,
                            "image_hw": [480, 640]}


def test_count_writes_segnet_step_and_leaves_flops_json(tmp_path):
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = (bench / "counts" / "flops.json").read_bytes()
    written = bench / "counts" / "segnet_ycb22" / "segnet_step.json"
    frozen = written.read_bytes()
    written.unlink()
    subprocess.run([sys.executable, str(bench / "counts" / "count.py"),
                    "--config", "segnet_ycb22", "--kind", "segnet_step",
                    "--traffic", "segnet_b3_pool16"], check=True,
                   capture_output=True, timeout=300)
    assert written.read_bytes() == frozen
    assert (bench / "counts" / "flops.json").read_bytes() == before


PROBE = r"""
import sys
sys.path[:0] = [{bench!r}]
from reference import segnet
print("FOUND", sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"jax", "jaxlib", "flax", "optax",
                          "autoposeestimation_tpu",
                          "autoposeestimation_tpu_torch"}}))
"""


def test_the_reference_imports_neither_package():
    with open(os.path.join(BENCH, "reference", "segnet.py"), "rb") as f:
        assert b"allow_tf32 = False" in f.read()
    res = subprocess.run([sys.executable, "-c", PROBE.format(bench=BENCH)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "FOUND []"


def test_the_seeds_weights_load_into_both_networks():
    """`segnet_weights.seeded_state`: one state that the program's SegNet and
    the reference load alike; kernels LeCun normal truncated at two standard
    deviations (sqrt(1 / fan-in) within 5 %), zero biases, unit BatchNorm;
    the same seed the same draw, another seed another."""
    import math

    import torch

    from autoposeestimation_tpu_torch.models import segnet as port
    from harness.segnet_weights import TRUNCATED_STD, seeded_state
    from reference import segnet as RS

    cfg = files.Cell(CELL).config
    state = seeded_state(cfg, 2 ** 31 + 11, "cpu")
    port.SegNet(cfg["classes"]).load_state_dict(state)
    RS.SegNet(cfg["classes"]).load_state_dict(state)
    for k, v in state.items():
        if k.endswith("weight") and v.dim() == 4:
            std = math.sqrt(1.0 / (v.shape[1] * v.shape[2] * v.shape[3]))
            assert abs(float(v.std()) / std - 1) < 0.05, k
            assert float(v.abs().max()) <= 2 * std / TRUNCATED_STD * (
                1 + 1e-6), k
        else:
            one = (".bns." in k and k.endswith(".weight")
                   or k.endswith(".running_var"))
            assert torch.equal(v, torch.full_like(v, 1.0 if one else 0.0)), k
    again = seeded_state(cfg, 2 ** 31 + 11, "cpu")
    other = seeded_state(cfg, 2 ** 31 + 12, "cpu")
    k = "encoder.0.convs.0.weight"
    assert torch.equal(again[k], state[k])
    assert not torch.equal(other[k], state[k])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["control", "half_batch"])
def test_a_fault_fails_a_limit_at_full_size(card, kind):
    """The float8 control and the half batch, against the reference on
    the program's first steps at the cell's sizes, each read above at
    least one of the cell's limits."""
    from harness import segnet_controls

    cell = files.Cell(CELL)
    got = segnet_controls.readings(cell, 2147483749, card, kind)
    over = {k: v for k, v in got.items()
            if k in cell.limits and v > cell.limits[k]["limit"]}
    assert over, got
