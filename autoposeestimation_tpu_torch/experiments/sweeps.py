"""Training sweeps and their evaluation (port of
`autoposeestimation_tpu/experiments/sweeps.py`, reference
experiments/train_pose_estimation_exp.py and eval_exp.py): train
DenseFusion once per point of a grid of p_viewpoints / p_extra_data /
label_mode with a wall-time stats JSON, evaluate every trained run of a
directory into <exp>_exp_eval_results.json, and read back each run's best
test distance.

Training runs `train()` (the estimator steps through
`csrc/sym_moments_train.cu`, the test passes through `csrc/sym_moments.cu`
on the card); evaluation runs `experiments/eval.py::evaluate`. Both run on
`device` (cuda unless given). `eval_exp` reads the `pose_model.npz` /
`pose_refine_model.npz` that either package wrote."""
from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .. import weights
from ..data import loader, pose_dataset
from ..train import checkpoints
from ..train import densefusion as dft
from ..utils import io
from . import eval as eval_mod


def train_pose_estimation_exp(root: str, ds_name: str,
                              p_viewpoints_grid: Sequence[float] = (1.0,),
                              p_extra_data_grid: Sequence[float] = (0.0,),
                              label_modes: Sequence[str] = ("new_pred",),
                              epochs: int = 3,
                              cfg: Optional[dft.DFConfig] = None,
                              out_base: Optional[str] = None,
                              device=None) -> Dict:
    """Train one run per grid point into `<out_base>/pv<p>_pe<p>_<mode>`;
    returns (and writes as sweep_stats.json) the runs' wall times and best
    test distances."""
    classes = io.read_lines(os.path.join(
        io.dataset_dir(root, "pose_estimation", ds_name), "classes.txt"))
    out_base = out_base or os.path.join(root, "experiments", "pose_runs",
                                        ds_name)
    stats: Dict = {"runs": [], "total_seconds": 0.0}
    for pv, pe, mode in itertools.product(p_viewpoints_grid,
                                          p_extra_data_grid, label_modes):
        run_name = f"pv{pv}_pe{pe}_{mode}"
        run_cfg = cfg or dft.DFConfig()
        t0 = time.time()
        state = dft.create_trainer(num_obj=len(classes), cfg=run_cfg,
                                   device=device)
        train_ds = pose_dataset.PoseDataset(
            root, ds_name, mode="train", num_pt=run_cfg.num_points,
            num_pt_mesh=run_cfg.num_points_mesh, label_mode=mode,
            p_viewpoints=pv, p_extra_data=pe)
        test_ds = pose_dataset.PoseDataset(
            root, ds_name, mode="test", num_pt=run_cfg.num_points,
            num_pt_mesh=run_cfg.num_points_mesh)
        out_dir = os.path.join(out_base, run_name)
        dft.train(state,
                  lambda: loader.Loader(train_ds, run_cfg.batch_size),
                  lambda: loader.Loader(test_ds, run_cfg.batch_size,
                                        shuffle=False, drop_last=False),
                  out_dir=out_dir, epochs=epochs)
        elapsed = time.time() - t0
        stats["runs"].append({
            "name": run_name, "p_viewpoints": pv, "p_extra_data": pe,
            "label_mode": mode, "seconds": elapsed,
            "best_test": state.best_test,
        })
        stats["total_seconds"] += elapsed
    io.write_json(os.path.join(out_base, "sweep_stats.json"), stats)
    return stats


def eval_exp(root: str, ds_name: str, runs_dir: Optional[str] = None,
             exp_name: str = "exp", cfg: Optional[dft.DFConfig] = None,
             device=None) -> Dict:
    """Evaluate every trained run under `runs_dir` on the dataset's test
    split (with the refiner where the run saved one); writes
    `<runs_dir>/<exp_name>_exp_eval_results.json`."""
    cfg = cfg or dft.DFConfig()
    classes = io.read_lines(os.path.join(
        io.dataset_dir(root, "pose_estimation", ds_name), "classes.txt"))
    runs_dir = runs_dir or os.path.join(root, "experiments", "pose_runs",
                                        ds_name)
    test_ds = pose_dataset.PoseDataset(
        root, ds_name, mode="test", num_pt=cfg.num_points,
        num_pt_mesh=cfg.num_points_mesh)

    results: Dict = {}
    for run in sorted(os.listdir(runs_dir)):
        run_dir = os.path.join(runs_dir, run)
        model_path = os.path.join(run_dir, "pose_model.npz")
        if not os.path.isdir(run_dir) or not os.path.exists(model_path):
            continue
        state = dft.create_trainer(num_obj=len(classes), cfg=cfg,
                                   device=device)
        state.posenet.load_state_dict(weights.posenet_state_dict(
            checkpoints.load_checkpoint(model_path)["variables"]))
        refine_path = os.path.join(run_dir, "pose_refine_model.npz")
        refine = os.path.exists(refine_path)
        if refine:
            state.refiner.load_state_dict(weights.refiner_state_dict(
                checkpoints.load_checkpoint(refine_path)["variables"]))
        results[run] = eval_mod.evaluate(
            dft.EvalModels(state.posenet, state.refiner, state.w,
                           cfg.with_sym),
            lambda: loader.Loader(test_ds, cfg.batch_size, shuffle=False,
                                  drop_last=False),
            classes, refine=refine, iteration=cfg.iteration)
    out_path = os.path.join(runs_dir, f"{exp_name}_exp_eval_results.json")
    io.write_json(out_path, results)
    return results


def plot_pose_exp_results(runs_dir: str) -> Dict:
    """Each run's best and final test distance and the best one's epoch,
    from its losses.json (reference plot_pose_exp_results.py:62-94, the
    data; drawing it is the caller's)."""
    out: Dict = {}
    for run in sorted(os.listdir(runs_dir)):
        path = os.path.join(runs_dir, run, "losses.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            curves = json.load(f).get("curves", {})
        test = curves.get("test_dists", [])
        if not test:
            continue
        best_idx = int(np.argmin(test))
        out[run] = {
            "best_test_dis": float(test[best_idx]),
            "best_epoch": best_idx,
            "final_test_dis": float(test[-1]),
            "n_epochs": len(test),
        }
    return out
