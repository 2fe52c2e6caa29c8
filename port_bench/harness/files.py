"""Everything of one item in files of its own, found by name:

  BENCHMARK.json                 the cells, their configurations and traffic
                                 mixes, and the metrics each reports
  configs/<config>.json          a configuration's sizes
  traffic/<traffic>.json         a traffic mix: the entry it drives and its
                                 parameters
  drivers/<entry>.py             set-up, the timed loop and the check of an
                                 entry
  metrics/<metric>.py            one reader of a per-layer metric
  limits/<cell>.json             the limits of a cell's `correct`
  counts/<config>/<kind>.json    the frozen FLOPs of one kind of unit (a
                                 frame, a step) of a configuration, written
                                 by `counts/count.py` from
  counts/kinds/<kind>.py         the count of that kind of unit; the kinds
                                 counted before these files existed are in
                                 counts/flops.json, by configuration

`root` is the benchmark's folder; BENCHMARK.json lies one level up."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its files resolved."""

    def __init__(self, name: str, root: str = HERE,
                 benchmark: str = None):
        self.root = root
        bench = read_json(benchmark or os.path.join(root, os.pardir,
                                                    "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        self.config = read_json(os.path.join(
            root, "configs", self.spec["config"] + ".json"))
        self.traffic = read_json(os.path.join(
            root, "traffic", self.spec["traffic"] + ".json"))
        self.entry = self.traffic["entry"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.limits = read_json(os.path.join(root, "limits",
                                             name + ".json"))["limits"]
        self._flops = config_flops(root, self.spec["config"])

    def flops(self) -> Dict[str, int]:
        """{kind: FLOPs of one unit} of the cell's configuration: its entry
        of counts/flops.json and every counts/<config>/<kind>.json; {}
        where it has none."""
        return dict(self._flops)

    def driver(self):
        return load_module(os.path.join(self.root, "drivers",
                                        self.entry + ".py"),
                           f"port_bench_driver_{self.entry}")

    def metric_readers(self) -> Dict[str, object]:
        return {m["name"]: load_module(
            os.path.join(self.root, "metrics", m["name"] + ".py"),
            "port_bench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}


def config_flops(root: str, config: str) -> Dict[str, int]:
    """The FLOP counts of `config` (see `Cell.flops`). A kind counted in
    both places raises ValueError."""
    counts = os.path.join(root, "counts")
    table = read_json(os.path.join(counts, "flops.json")).get(config, {})
    out = dict(table)
    folder = os.path.join(counts, config)
    if os.path.isdir(folder):
        for fname in sorted(os.listdir(folder)):
            if not fname.endswith(".json"):
                continue
            kind = fname[:-len(".json")]
            if kind in out:
                raise ValueError(f"{config}'s {kind} is counted in "
                                 f"counts/flops.json and in {fname}")
            out[kind] = read_json(os.path.join(folder, fname))["flops"]
    return out


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

