"""BENCHMARK.json against the contract, and every item found by name in a
file of its own, including one added without editing a file."""
import json
import os
import re
import shutil
import time

import pytest

from harness import files

ROOT = os.path.dirname(files.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves(cell):
    c = files.Cell(cell)
    assert c.config["name"] == c.spec["config"]
    assert hasattr(c.driver(), "Driver")
    readers = c.metric_readers()
    assert readers and all(hasattr(r, "read") for r in readers.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.limits


def _cpu_traced(work):
    """`harness/trace.py::traced` for the CPU: the work once, under a
    stand-in trace."""
    from harness import trace

    units = work()
    return trace.Trace(1.0, 0.5, {"kernel": (100, 0.4)}, [], []), units


def test_a_new_cell_by_new_files_alone(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a cell, a per-layer metric, its
    limits and its FLOP count added as new files and entries; no existing
    file edited. The new cell's traced path runs to its metrics, the
    count read by name."""
    bench = tmp_path / "port_bench"
    shutil.copytree(files.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    b = _bench()
    cfg = json.loads((bench / "configs" / "autopose_5obj.json").read_text())
    cfg.update(name="autopose_3obj", num_objects=3, seg_classes=4)
    (bench / "configs" / "autopose_3obj.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "live_pool16.json")
                         .read_text())
    traffic["pool"] = 8
    (bench / "traffic" / "live_pool8.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.traced_units)\n")
    (bench / "limits" / "live.autopose_3obj.json").write_text(
        (bench / "limits" / "live.autopose_5obj.json").read_text())
    b["configs"].append({"name": "autopose_3obj", "source": "x",
                         "file": "port_bench/configs/autopose_3obj.json",
                         "reduced": ["num_objects"], "why": "x"})
    b["workloads"].append({"name": "live.autopose_3obj",
                           "config": "autopose_3obj",
                           "traffic": "live_pool8", "chips": 1, "why": "x"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "live.autopose_5obj" in m.get("workloads", []):
            m["workloads"].append("live.autopose_3obj")
    b["per_layer"].append({"name": "frames_traced", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "frames_per_s",
                           "workloads": ["live.autopose_3obj"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = files.Cell("live.autopose_3obj", str(bench))
    assert cell.config["num_objects"] == 3 and cell.traffic["pool"] == 8
    readers = cell.metric_readers()
    assert "frames_traced" in readers and "mfu_pct.serve" in readers

    class Ctx:
        traced_units = 7

    assert readers["frames_traced"].read(Ctx()) == 7.0
    assert cell.flops() == {}
    (bench / "counts" / "autopose_3obj").mkdir()
    (bench / "counts" / "autopose_3obj" / "frame.json").write_text(
        json.dumps({"flops": 300_000_000_000, "rule": "x", "at": {}}))
    from harness import trace
    import run as R
    import tiny

    monkeypatch.setattr(trace, "traced", _cpu_traced)
    cell = tiny.tiny_cell("live.autopose_3obj", root=str(bench))
    out = R.run(cell, 2 ** 31 + 9, 0.3, True, "cpu", time.perf_counter())
    w = out["window"]
    assert out["metrics"]["mfu_pct.serve"]["value"] == pytest.approx(
        100 * 300e9 * w["units"] / w["seconds"] / 989e12)
    assert out["metrics"]["frames_traced"]["value"] == out["units"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        files.Cell("no.such_cell")
