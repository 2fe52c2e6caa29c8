"""Nothing the benchmark runs loads JAX or the JAX package; top-level
module names are compared whole."""
import os
import subprocess
import sys

import run as R

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

PROBE = r"""
import sys, time
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
import torch
torch.set_num_threads(2)
import tiny, run as R
cell = tiny.tiny_cell("{cell}")
out = R.run(cell, 5, 0.3, False, "cpu", time.perf_counter())
print("FOUND", R.forbidden_modules())
"""


def _probe(cell):
    code = PROBE.format(root=ROOT, bench=BENCH,
                        tests=os.path.join(BENCH, "tests"), cell=cell)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1]


def test_serving_run_loads_no_jax():
    assert _probe("live.autopose_5obj") == "FOUND []"


def test_training_run_loads_no_jax():
    assert _probe("train.autopose_5obj") == "FOUND []"


def test_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "autoposeestimation_tpu_torch_x",
                        types.ModuleType("x"))
    assert "autoposeestimation_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "autoposeestimation_tpu.ops.cca",
                        types.ModuleType("y"))
    assert "autoposeestimation_tpu" in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert "jaxlib" in R.forbidden_modules()


def test_without_a_card_there_is_no_result(tmp_path):
    """The measurement path fails where there is no card (or fewer than the
    cell asks for): a non-zero exit and nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "live.autopose_5obj", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_last_line_schema():
    """The result line: the contract's keys, the numbers compared last,
    every metric with a value and a unit, one JSON object."""
    import json
    import time

    import tiny

    cell = tiny.tiny_cell("live.autopose_5obj")
    out = R.run(cell, 11, 0.3, False, "cpu", time.perf_counter())
    device = {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": out["peak"]}
    line = json.loads(json.dumps(R.result_line(out, device, "none")))
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] is True and line["failed"] == 0
