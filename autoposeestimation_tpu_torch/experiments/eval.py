"""ADD(-S) evaluation over a test split (port of
`autoposeestimation_tpu/experiments/eval.py`): per-class mean ADD(-S), the
share under 2 cm and, where batches carry `target_t`, the translation
error."""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from ..train import densefusion as dft
from ..utils import transforms as T


def add_from_pose(quat, position, gt_rotation, gt_translation, model_points,
                  symmetric: bool = False) -> float:
    """ADD (ADD-S when `symmetric`) between a predicted pose (unit
    quaternion wxyz + translation, meters) and a ground-truth rotation
    matrix + translation, over `model_points` (M, 3) meters."""
    rot = T.quat_to_mat(torch.as_tensor(np.asarray(quat, np.float32))).numpy()
    pred = model_points @ rot.T + np.asarray(position)
    gt = model_points @ np.asarray(gt_rotation).T + np.asarray(gt_translation)
    if symmetric:
        d = np.linalg.norm(pred[:, None, :] - gt[None, :, :], axis=-1)
        return float(d.min(axis=1).mean())
    return float(np.linalg.norm(pred - gt, axis=-1).mean())


def evaluate(state: dft.EvalModels, test_batches: Callable[[], Iterable],
             classes, refine: bool = True, iteration: int = 2,
             success_threshold: float = 0.02) -> Dict:
    """Returns {cls: {'dis', 't_err', '<2', '>=2', 'p'}, 'overall':
    {'p', 'n'}}. `test_batches` returns a fresh iterator of batches in the
    JAX package's layout (numpy or tensors, img (B, S, S, 3)), which go to
    the device of `state.posenet`'s parameters."""
    results = {cls: {"dis": [], "t_err": [], "<2": 0, ">=2": 0}
               for cls in classes}
    use_refine = refine and state.refiner is not None
    dev = next(state.posenet.parameters()).device
    for batch in test_batches():
        batch = dft.to_device(batch, dev)
        dis, _, trans = dft.eval_step_full(
            state.posenet, state.refiner, batch, state.w, use_refine,
            iteration, state.with_sym)
        obj = batch["obj_idx"].cpu().numpy()
        if "target_t" in batch:
            t_err = np.linalg.norm(trans.cpu().numpy()
                                   - batch["target_t"].cpu().numpy(), axis=1)
        else:
            t_err = np.full(len(obj), np.nan)
        for d, te, o in zip(dis.cpu().numpy().tolist(), t_err.tolist(),
                            obj.tolist()):
            cls = classes[int(o)]
            results[cls]["dis"].append(d)
            results[cls]["t_err"].append(te)
            results[cls]["<2" if d < success_threshold else ">=2"] += 1

    total_less = sum(v["<2"] for v in results.values())
    total_more = sum(v[">=2"] for v in results.values())
    for v in results.values():
        n = v["<2"] + v[">=2"]
        v["p"] = round(v["<2"] / n * 100, 2) if n else float("nan")
        v["dis"] = (round(float(np.mean(v["dis"])), 5) if v["dis"]
                    else float("nan"))
        te = np.asarray(v["t_err"], np.float64)
        v["t_err"] = (round(float(np.nanmean(te)), 5)
                      if te.size and not np.all(np.isnan(te))
                      else float("nan"))
    results["overall"] = {
        "p": round(total_less / max(total_less + total_more, 1) * 100, 2),
        "n": total_less + total_more,
    }
    return results
