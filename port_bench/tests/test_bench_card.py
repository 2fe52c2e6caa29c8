"""On the card, at each cell's own size: the control comes out not
correct on three seeds, and a checkout that holds only the benchmark gives
no result. Run there with

    python3 -m pytest port_bench/tests/test_bench_card.py -m cuda
"""
import os
import shutil
import subprocess
import sys

import pytest

import run as R
from harness import controls
from harness.files import Cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SEEDS = (2147483659, 2147483693, 2147483713)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["live.autopose_5obj",
                                  "stream.densefusion_ycb21",
                                  "train.autopose_5obj"])
def test_control_fails_at_full_size(name, card):
    cell = Cell(name, BENCH)
    for seed in SEEDS:
        values = (controls.train_control(cell, seed, card, seconds=10.0)
                  if cell.entry == "train" else
                  controls.serve_control(cell, seed, card))
        checks = R.judge(values, cell.limits)
        assert not R.is_correct(checks, {"failed": 0}), (seed, checks)


@pytest.mark.cuda
def test_benchmark_alone_gives_no_result(tmp_path, card):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "live.autopose_5obj", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""
