"""Run one cell of the benchmark once:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout. Set-up (weights, traffic, the program's
objects, warm-up), then a window of `--seconds`, then the check of what the
window produced against the plain reference. With `--trace 0` the result
carries the cell's end-to-end metrics; with `--trace 1` its per-layer ones,
read from a window of the same length (the rates) and a short traced
window after it (the device's activity). The last line of standard output
is one JSON object; the numbers compared for `correct`, each beside its
limit, are the last lines of standard error and the result's last key.

It exits without a result when there is no card, fewer cards than the
cell asks for, the program cannot be imported, or JAX or the JAX package
was loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "autoposeestimation_tpu")


def cache_env(checkout: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the hand kernels build into `build/kernels/` there)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(checkout, "build",
                                                  "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        checkout, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # one process, few threads: the program's host work is one dispatch
    # thread, and idle intra-op threads only take cores from it
    os.environ["OMP_NUM_THREADS"] = "1"


def quiet_host() -> None:
    """Before the window: the set-up's objects collected once and frozen,
    so that the collector's passes in the window scan only what the window
    makes."""
    gc.collect()
    gc.freeze()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of `FORBIDDEN`, compared
    whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer reader reads: the cell, its untraced window, the
    trace and the units in it, and the frozen FLOP counts."""

    def __init__(self, cell, window, trace, traced_units, flops):
        self.cell, self.window, self.trace = cell, window, trace
        self.traced_units, self.flops = traced_units, flops


def judge(values: dict, limits: dict) -> dict:
    """{name: {value, limit}}, every limit of the cell with its reading."""
    return {name: {"value": values.get(name, math.nan),
                   "limit": lim["limit"]} for name, lim in limits.items()}


def is_correct(checks: dict, window: dict) -> bool:
    return window["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of `cell` on `device`: the result object but `device`."""
    import torch

    from harness import trace as tr

    driver = cell.driver().Driver(cell.config, cell.traffic, seed, device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    quiet_host()
    setup_s = time.perf_counter() - t_start
    window = driver.window(seconds)
    metrics, extra = {}, {}
    if not trace:
        values = driver.end_to_end(window)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        trace_obj, units = tr.traced(driver.traced_units)
        ctx = Context(cell, window, trace_obj, units, cell.flops())
        units_of = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, reader in cell.metric_readers().items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units_of[name]}
        extra = {"busy_s": trace_obj.busy_s, "window_s": trace_obj.window_s,
                 "units": units,
                 "breakdown": {"device_ops": trace_obj.device_ops,
                               "idle_gaps": trace_obj.idle_gaps}}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.unfreeze()
    driver.release()
    t_check = time.perf_counter()
    checks = judge(driver.check(cell.limits), cell.limits)
    timing = {"setup_s": setup_s, "window_s": window["seconds"],
              "units": window["units"],
              "check_s": time.perf_counter() - t_check}
    if trace:      # the profiler's cost: the traced window's rate
        timing["traced_units_per_s"] = extra["units"] / extra["window_s"]
    return {"window": window, "metrics": metrics, "peak": peak,
            "checks": checks, "timing": timing, **extra}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(out: dict, device: dict, card: str) -> dict:
    line = {"correct": is_correct(out["checks"], out["window"]),
            "attempted": out["window"]["attempted"],
            "failed": out["window"]["failed"],
            "metrics": out["metrics"], "device": device, "card": card}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(CHECKOUT)
    for path in (CHECKOUT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness.files import Cell

    cell = Cell(args.workload, HERE)
    import torch

    torch.set_num_threads(1)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s): found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import autoposeestimation_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"the program is not importable: {err}", file=sys.stderr)
        return 3
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
              T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["peak"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    line = result_line(out, device, power_limit())
    print("timing " + json.dumps(out["timing"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
