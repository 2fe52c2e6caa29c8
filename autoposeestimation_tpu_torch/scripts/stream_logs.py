"""Live training-curve dashboard: poll a per-epoch JSON log (rewritten
whole each epoch by `utils/timing.py::JsonCurveLog`) and redraw its
curves; a one-line terminal summary when matplotlib or a display is not
there.

    python -m autoposeestimation_tpu_torch.scripts.stream_logs LOG.json
        [--interval 5] [--once]
"""
import argparse
import json
import os
import sys
import time


def read_curves(path):
    try:
        with open(path) as f:
            return json.load(f).get("curves", {})
    except (OSError, json.JSONDecodeError):
        return {}


def terminal_summary(curves):
    parts = []
    for key, vals in sorted(curves.items()):
        if vals and isinstance(vals[-1], (int, float)):
            parts.append(f"{key}={vals[-1]:.4g} (n={len(vals)})")
    print(" | ".join(parts) or "(no curves yet)", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path")
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument("--once", action="store_true")
    args = parser.parse_args(argv)

    plt = None
    if os.environ.get("DISPLAY") or sys.platform == "darwin":
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            plt = None

    while True:
        curves = read_curves(args.path)
        if plt is not None and curves:
            plt.clf()
            for key, vals in sorted(curves.items()):
                if vals and isinstance(vals[0], (int, float)):
                    plt.plot(vals, label=key)
            plt.legend(fontsize=7)
            plt.xlabel("epoch")
            plt.pause(0.01)
        else:
            terminal_summary(curves)
        if args.once:
            return
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
