"""Promotion gate for `DFConfig.sym_bf16` (bf16 distances in the training
kernel of the symmetric loss).

The gate compares the sym_bf16 twin of the multi-object demo
(`train_multi_demo --sym-bf16`: the same 5-object scene with one
symmetric class and the same trainer; only the kernel's arithmetic
differs) with the exact-arithmetic run, from their artifacts and curve
logs, and prints one JSON verdict line.

A twin trained for fewer epochs than the exact run is compared with the
exact run's best-so-far at the same epoch (its per-epoch `test_dists`
curve), not with its final number.

Checks (all must hold):
  1. refine phase reached; the decay and refine transitions fired by
     margin (a fallback trigger means the optimizer crawled).
  2. `grad_norm_max` over all epochs <= 10.
  3. best test ADD within `--tol-add-mm` (default 1.5) of the exact run's
     best-so-far at the twin's epoch budget.
  4. serving: every class found in every held-out composite frame, and
     per-class ADD(-S) within `--tol-serve-mm` (default 3.0) of the exact
     run's per-class table.

    python -m autoposeestimation_tpu_torch.scripts.gate_symbf16
        --exact A.json --exact-curves A_curves.json
        --twin B.json --twin-curves B_curves.json
        [--exact-serve S.json --twin-serve T.json]
"""
import argparse
import json
import os
import sys


def _load(path):
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exact", required=True,
                   help="train_multi_demo artifact of the exact run")
    p.add_argument("--exact-curves", required=True,
                   help="its curve log (<artifact>_curves.json)")
    p.add_argument("--twin", required=True,
                   help="train_multi_demo --sym-bf16 artifact")
    p.add_argument("--twin-curves", required=True,
                   help="its curve log")
    p.add_argument("--tol-add-mm", type=float, default=1.5)
    p.add_argument("--tol-serve-mm", type=float, default=3.0)
    p.add_argument("--exact-serve", default=None,
                   help="attribute_serving artifact for the exact run; "
                        "with --twin-serve, the serving check compares "
                        "these served_s* tables instead of the demo "
                        "artifacts' own")
    p.add_argument("--twin-serve", default=None,
                   help="attribute_serving --serve-only artifact for the "
                        "sym_bf16 twin on the same held-out frames")
    args = p.parse_args(argv)

    if os.path.abspath(args.exact) == os.path.abspath(args.twin):
        print(json.dumps({"gate": "sym_bf16_promotion", "error":
                          "--exact and --twin are the same file; the twin "
                          "run must write its own artifact"}))
        return 2

    exact, twin = _load(args.exact), _load(args.twin)
    exact_td = _load(args.exact_curves)["curves"]["test_dists"]
    twin_curves = _load(args.twin_curves)["curves"]
    checks = {}

    pt = twin["pose_training"]
    if not pt.get("sym_bf16"):
        print(json.dumps({"gate": "sym_bf16_promotion", "error":
                          "twin artifact was not trained with --sym-bf16"}))
        return 2
    tr = pt.get("transitions", {})
    checks["refine_phase_reached"] = bool(pt["refine_phase_reached"])
    checks["transitions_by_margin"] = (
        tr.get("decay", {}).get("trigger") == "margin"
        and tr.get("refine", {}).get("trigger") == "margin")

    gn = max(twin_curves.get("grad_norm_max", [float("inf")]))
    checks["grad_norm_max_le_10"] = gn <= 10.0

    # trainer epochs are 1-indexed and test_dists has one entry per epoch
    # (index i = epoch i+1): a twin of E epochs meets the exact run's
    # first E per-epoch test distances
    epochs = int(pt["epochs"])
    exact_best_at_e = min(exact_td[:min(epochs, len(exact_td))])
    delta_mm = (pt["best_test_add_m"] - exact_best_at_e) * 1e3
    checks["best_add_within_tol"] = delta_mm <= args.tol_add_mm

    if args.exact_serve and args.twin_serve:
        # the held-out comparison of attribute_serving artifacts; the
        # product serving condition is the first of "conditions"
        ex_art, tw_art = _load(args.exact_serve), _load(args.twin_serve)
        cond = tw_art["conditions"][0]
        serve_n = tw_art["n_frames"]
        serve_rows = {c: (tw_art["per_class"][c][cond],
                          ex_art["per_class"][c][cond])
                      for c in tw_art["per_class"]}
    else:
        cond = "demo_n9"
        serve_n = 9
        serve_rows = {c: (row, exact["serving"]["per_class"][c])
                      for c, row in twin["serving"]["per_class"].items()}

    serve_ok, per_class = True, {}
    for c, (row, ex) in serve_rows.items():
        found_all = row["found"] == row["of"]
        d_mm = (row.get("add_mean_m") or float("inf")) * 1e3 \
            - ex["add_mean_m"] * 1e3
        ok = found_all and d_mm <= args.tol_serve_mm
        per_class[c] = {"found_all": found_all,
                        "add_delta_vs_exact_mm": round(d_mm, 2), "ok": ok}
        serve_ok = serve_ok and ok
    checks["serving_per_class_ok"] = serve_ok

    verdict = {
        "gate": "sym_bf16_promotion",
        "twin_epochs": epochs,
        "twin_best_test_add_m": pt["best_test_add_m"],
        "exact_best_at_same_epoch_m": round(exact_best_at_e, 5),
        "best_add_delta_mm": round(delta_mm, 2),
        "twin_grad_norm_max": round(gn, 2),
        "serving_condition": cond,
        "serving_n_frames": serve_n,
        "per_class": per_class,
        "checks": checks,
        "promote": all(checks.values()),
    }
    print(json.dumps(verdict))
    return 0 if verdict["promote"] else 1


if __name__ == "__main__":
    sys.exit(main())
