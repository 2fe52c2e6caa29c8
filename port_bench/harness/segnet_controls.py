"""The readings that set the upper end of `train.segnet_ycb22`'s limits:
the control (the reference in the program's place, its convolutions'
operands rounded to float8) and the fault of steps that leave half of
each batch out (`half_batch`). A state left unchanged reads 1 by the
training measure and needs no run. The window numbers come from the steps
after a state that the program held in a window of `--seconds` (the cell's
`run_seconds` by default); the stack numbers from the program's first
step, each stack of the control alone on the program's inputs.

    python3 port_bench/harness/segnet_controls.py --workload <cell>
        --seeds 1 2 3 [--kind control|half_batch] [--seconds S]

prints one JSON line of readings a seed, on the card."""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import files  # noqa: E402
from reference import segnet as RS  # noqa: E402


def half(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    n = batch["image"].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def readings(cell, seed: int, device, kind: str = "control",
             seconds: float = 0.0) -> Dict[str, float]:
    """The cell's numbers of the control (`kind` 'control') or of the
    half-batch fault ('half_batch') against the reference: the first
    steps, the stacks (the control only) and, with `seconds` > 0, the
    steps recorded in a window of the program of that length."""
    from drivers import segnet_train as D

    cfg, traffic = cell.config, cell.traffic
    fault = ({"quant": RS.fp8_round} if kind == "control" else
             {"batch_map": half})
    driver = D.Driver(cfg, traffic, seed, device)
    if seconds > 0:
        driver.window(seconds)
    driver.release()
    out = D.compare(
        D.reference_steps(cfg, traffic, seed, device, driver.initial,
                          **fault),
        D.reference_steps(cfg, traffic, seed, device, driver.initial))
    if kind == "control":
        net = D.reference_net(cfg, driver.initial, device)
        control = D.reference_net(cfg, driver.initial, device, RS.fp8_round)
        out.update(D.stack_gaps(D.stack_outputs(control, driver.capture),
                                D.stack_outputs(net, driver.capture)))
    rec = driver.in_window
    if rec is not None:
        got = D.compare(
            D.reference_steps(cfg, traffic, seed, device, driver.initial,
                              rec, **fault),
            D.reference_steps(cfg, traffic, seed, device, driver.initial,
                              rec))
        out.update({f"window_{k}": v for k, v in got.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kind", default="control",
                    choices=("control", "half_batch"))
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    cell = files.Cell(args.workload, HERE)
    seconds = args.seconds
    if seconds is None:
        seconds = files.read_json(os.path.join(
            HERE, os.pardir, "BENCHMARK.json"))["run_seconds"]
    for seed in args.seeds:
        values = readings(cell, seed, "cuda", args.kind, seconds)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "readings": values,
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
