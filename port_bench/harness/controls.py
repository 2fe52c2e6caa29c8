"""The readings that set the upper end of each limit of `correct`: the
control (the reference in the program's place, computed in float8), and
for a training cell the fault of a step that leaves half of its batch out
and takes the mean over the rest. A state left unchanged reads 1 by the
training measure and needs no run. A training cell's window numbers come
from the steps after a state that the program held in a window of
`--seconds` (the cell's `run_seconds` by default).

    python3 port_bench/harness/controls.py --workload <cell> --seeds 1 2 3
        [--kind control|half_batch] [--seconds S]

prints one JSON line of readings a seed, on the card."""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
from typing import Dict

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import files, serving  # noqa: E402
from harness import weights as W  # noqa: E402
from reference import nets as R  # noqa: E402
from reference import serve as RS  # noqa: E402
from reference import train as RT  # noqa: E402


def serve_control(cell, seed: int, device, quant=R.fp8_round
                  ) -> Dict[str, float]:
    """The widest readings of the control over as many frames of the pool
    as a run checks, drawn from the seed."""
    cfg, traffic = cell.config, cell.traffic
    pool = serving.Pool(cfg, traffic, seed, device)
    judge = serving.reference_judge(cfg, seed, pool.model_points, device,
                                    serving.tie_margin(cell.limits))
    states = W.seeded_states(cfg, seed, device)
    nets = W.reference_nets(cfg, device)
    for name, net in nets.items():
        net.load_state_dict(states[name])
        R.set_quant(net.eval(), quant)
    nets = (nets["unet"], nets["posenet"], nets["refiner"])
    rng = random.Random(seed)
    worst: Dict[str, float] = {}
    for _ in range(traffic["check_frames"]):
        frame = pool.frame(rng.randrange(pool.count), device)
        out = RS.frame_outputs(nets, frame, cfg)
        out["masks"] = out["masks"] & out["found"][:, None, None]
        for name, value in judge.judge(frame, out).items():
            worst[name] = max(worst.get(name, 0.0), value)
    return worst


def _half(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    n = batch["obj_idx"].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def train_control(cell, seed: int, device, kind: str = "control",
                  seconds: float = 0.0) -> Dict[str, float]:
    """The training numbers of the control (`kind` 'control') or of the
    half-batch fault ('half_batch') against the reference: the first
    steps, and with `seconds` > 0 the steps recorded in a window of the
    program of that length, under `window_` names."""
    from drivers import train as D

    cfg, traffic = cell.config, cell.traffic
    fault = ({"quant": R.fp8_round} if kind == "control" else
             {"batch_map": _half})
    out = RT.compare(D.reference_steps(cfg, traffic, seed, device, **fault),
                     D.reference_steps(cfg, traffic, seed, device))
    if seconds > 0:
        driver = D.Driver(cfg, traffic, seed, device)
        driver.window(seconds)
        rec = driver.in_window
        driver.release()
        got = RT.compare(D.replay_steps(cfg, traffic, seed, device, rec,
                                        **fault),
                         D.replay_steps(cfg, traffic, seed, device, rec))
        out.update({f"window_{k}": v for k, v in got.items()})
    return out


def main(argv=None) -> int:
    from harness.files import Cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kind", default="control",
                    choices=("control", "half_batch"))
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, HERE)
    seconds = args.seconds
    if seconds is None:
        seconds = files.read_json(os.path.join(
            HERE, os.pardir, "BENCHMARK.json"))["run_seconds"]
    for seed in args.seeds:
        if cell.entry == "train":
            values = train_control(cell, seed, "cuda", args.kind, seconds)
        else:
            values = serve_control(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "readings": values,
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
