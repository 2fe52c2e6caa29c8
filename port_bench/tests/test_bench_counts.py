"""FLOP counts found by name: a configuration's entry of counts/flops.json
merged with its counts/<config>/<kind>.json files, and the readers that
need a count left out where there is none."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import files

BENCH = files.HERE
ROOT = os.path.dirname(BENCH)
CELLS = {"live.autopose_5obj": "autopose_5obj",
         "stream.densefusion_ycb21": "densefusion_ycb21",
         "train.autopose_5obj": "autopose_5obj"}


def _copy(tmp_path):
    """A copy of the benchmark to add files to; (its folder, its
    BENCHMARK.json's content)."""
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return bench, json.loads((tmp_path / "BENCHMARK.json").read_text())


def _new_config(tmp_path, bench, b, name="autopose_3obj"):
    """A configuration that flops.json does not hold, with a live cell."""
    cfg = json.loads((bench / "configs" / "autopose_5obj.json").read_text())
    cfg.update(name=name, num_objects=3, seg_classes=4)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "limits" / f"live.{name}.json").write_text(
        (bench / "limits" / "live.autopose_5obj.json").read_text())
    b["configs"].append({"name": name, "source": "x",
                         "file": f"port_bench/configs/{name}.json",
                         "reduced": ["num_objects"], "why": "x"})
    b["workloads"].append({"name": f"live.{name}", "config": name,
                           "traffic": "live_pool16", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "live.autopose_5obj" in m.get("workloads", []):
            m["workloads"].append(f"live.{name}")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return f"live.{name}"


def _count_file(bench, config, kind, flops):
    (bench / "counts" / config).mkdir(exist_ok=True)
    (bench / "counts" / config / f"{kind}.json").write_text(json.dumps(
        {"flops": flops, "rule": "x", "at": {}}))


class _Ctx:
    """What the mfu readers read of a run."""

    def __init__(self, cell, kinds=None):
        self.cell, self.flops = cell, cell.flops()
        self.window = {"seconds": 2.0, "units": 10,
                       "kinds": kinds or {"estimator": 8, "refiner": 2}}


def test_a_new_config_gets_its_count_from_its_own_file(tmp_path):
    bench, b = _copy(tmp_path)
    name = _new_config(tmp_path, bench, b)
    _count_file(bench, "autopose_3obj", "frame", 123_000_000_000)
    cell = files.Cell(name, str(bench))
    assert cell.flops() == {"frame": 123_000_000_000}
    value = cell.metric_readers()["mfu_pct.serve"].read(_Ctx(cell))
    assert value == pytest.approx(100 * 123e9 * 10 / 2.0 / 989e12)


def test_a_kind_counted_twice_raises(tmp_path):
    bench, _ = _copy(tmp_path)
    _count_file(bench, "autopose_5obj", "frame", 1)
    with pytest.raises(ValueError, match="frame"):
        files.Cell("live.autopose_5obj", str(bench))


@pytest.mark.parametrize("metric", ["mfu_pct.serve", "mfu_pct.train"])
def test_no_count_gives_nothing_to_read(tmp_path, metric):
    bench, b = _copy(tmp_path)
    name = _new_config(tmp_path, bench, b)
    cell = files.Cell(name, str(bench))
    assert cell.flops() == {}
    reader = files.load_module(str(bench / "metrics" / f"{metric}.py"),
                               "count_test_" + metric.replace(".", "_"))
    assert reader.read(_Ctx(cell)) is None


def test_a_step_kind_without_a_count_is_left_out():
    cell = files.Cell("train.autopose_5obj")
    reader = cell.metric_readers()["mfu_pct.train"]
    assert reader.read(_Ctx(cell, {"estimator": 4, "other": 1})) is None
    assert reader.read(_Ctx(cell, {"estimator": 4})) > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_accepted_configs_read_flops_json(cell):
    """Every kind of flops.json reads its number there; the other kinds
    are the configuration's own files."""
    with open(os.path.join(BENCH, "counts", "flops.json")) as f:
        table = json.load(f)[CELLS[cell]]
    got = files.Cell(cell).flops()
    assert {k: got[k] for k in table} == table
    folder = os.path.join(BENCH, "counts", CELLS[cell])
    own = sorted(f[:-5] for f in os.listdir(folder)) if os.path.isdir(
        folder) else []
    assert sorted(set(got) - set(table)) == own


def test_a_new_step_kind_of_an_accepted_config_is_counted_by_name(
        tmp_path):
    bench, _ = _copy(tmp_path)
    _count_file(bench, "autopose_5obj", "seg_step", 159_000_000_000)
    cell = files.Cell("train.autopose_5obj", str(bench))
    with open(os.path.join(BENCH, "counts", "flops.json")) as f:
        table = json.load(f)
    assert cell.flops() == {**table["autopose_5obj"],
                            "seg_step": 159_000_000_000}
    value = cell.metric_readers()["mfu_pct.train"].read(
        _Ctx(cell, {"seg": 30}))
    assert value == pytest.approx(100 * 159e9 * 30 / 2.0 / 989e12)


KIND = '''"""The U-Net's forward over one frame, for the count's test."""
import torch

from counts import rules
from reference import nets as R


def at(cfg, traffic):
    return {"image_hw": cfg["image_hw"], "frames": traffic["pool"]}


def flops(cfg, traffic):
    with torch.device("meta"):
        net = R.UNet(cfg["seg_classes"], cfg["unet_decoder_channels"],
                     cfg["unet_encoder_stages"])
        image = torch.empty(1, 3, *cfg["image_hw"])
        with rules.counting() as mode:
            net(image)
    return int(mode.get_total_flops())
'''


def test_count_writes_a_kind_and_recounts_only_flops_json(tmp_path):
    bench, b = _copy(tmp_path)
    _new_config(tmp_path, bench, b)
    before = (bench / "counts" / "flops.json").read_bytes()
    script = str(bench / "counts" / "count.py")
    subprocess.run([sys.executable, script], check=True,
                   capture_output=True, timeout=300)
    assert (bench / "counts" / "flops.json").read_bytes() == before
    (bench / "counts" / "kinds").mkdir()
    (bench / "counts" / "kinds" / "unet_frame.py").write_text(KIND)
    subprocess.run([sys.executable, script, "--config", "autopose_3obj",
                    "--kind", "unet_frame", "--traffic", "live_pool16"],
                   check=True, capture_output=True, timeout=300)
    got = json.loads((bench / "counts" / "autopose_3obj" / "unet_frame.json")
                     .read_text())
    cfg = json.loads((bench / "configs" / "autopose_3obj.json").read_text())
    mix = json.loads((bench / "traffic" / "live_pool16.json").read_text())
    assert got["at"] == {"traffic": "live_pool16",
                         "image_hw": cfg["image_hw"], "frames": mix["pool"]}
    assert 0 < got["flops"] < json.loads(before)["autopose_5obj"]["frame"]
    assert (bench / "counts" / "flops.json").read_bytes() == before
    cell = files.Cell("live.autopose_3obj", str(bench))
    assert cell.flops() == {"unet_frame": got["flops"]}
