"""ADD(-S) on the public benchmarks, YCB-Video and LineMOD (port of
`autoposeestimation_tpu/experiments/legacy_eval.py`, after upstream
DenseFusion's tools/eval_ycb.py and eval_linemod.py): the estimator and
refiner over a benchmark's test list, per-class ADD(-S) and the benchmark's
success rule (< 2 cm for YCB, < 10 % of the object's diameter for LineMOD),
written as JSON.

Each batch goes through `train/densefusion.py::eval_step` on the device of
the trainer's networks, whose `pose_loss` runs `csrc/sym_moments.cu` on the
card. The rounding and the JSON are the JAX package's. An object index
that the PoseNet has no head for raises ValueError before the batch is
launched (the JAX package's gather clamps it silently)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..data import legacy_datasets, loader
from ..train import densefusion as dft
from ..utils import io


def _check_indices(state: dft.TrainerState, obj_idx) -> None:
    num_obj = state.posenet.head_r.num_obj
    bad = sorted({int(o) for o in np.asarray(obj_idx).reshape(-1)
                  if not 0 <= int(o) < num_obj})
    if bad:
        raise ValueError(f"object indices {bad} out of range for a PoseNet "
                         f"of {num_obj} objects")


def _scores(state: dft.TrainerState, dataset, batch_size: int,
            class_of: Callable[[int], str],
            threshold_of: Callable[[int], float], classes: List[str]
            ) -> Dict:
    """{cls: {'dis': mean rounded to 5 digits, 'hit', 'miss',
    'success_rate': %}} over the dataset's batches."""
    results: Dict = {cls: {"dis": [], "hit": 0, "miss": 0}
                     for cls in classes}
    for batch in loader.Loader(dataset, batch_size, shuffle=False,
                               drop_last=False):
        _check_indices(state, batch["obj_idx"])
        dis = dft.eval_step(state.posenet, state.refiner,
                            dft.to_device(batch, state.device), state.w,
                            state.refine_start, state.cfg.iteration,
                            state.cfg.with_sym)
        for d, obj in zip(dis.cpu().numpy().tolist(),
                          np.asarray(batch["obj_idx"]).tolist()):
            cls = class_of(int(obj))
            results[cls]["dis"].append(d)
            key = "hit" if d < threshold_of(int(obj)) else "miss"
            results[cls][key] += 1
    for v in results.values():
        n = v["hit"] + v["miss"]
        v["success_rate"] = round(v["hit"] / n * 100, 2) if n else float("nan")
        v["dis"] = (round(float(np.mean(v["dis"])), 5) if v["dis"]
                    else float("nan"))
    return results


def _run_eval(state: dft.TrainerState, dataset, classes: List[str],
              batch_size: int, threshold_fn) -> Dict:
    results = _scores(state, dataset, batch_size, lambda o: classes[o],
                      threshold_fn, classes)
    total_hit = sum(v["hit"] for v in results.values())
    total = sum(v["hit"] + v["miss"] for v in results.values())
    results["overall"] = {
        "success_rate": round(total_hit / max(total, 1) * 100, 2),
        "n": total,
    }
    return results


def eval_ycb(state: dft.TrainerState, root: str, data_list: List[str],
             classes: List[str], batch_size: int = 8,
             out_path: Optional[str] = None,
             success_threshold: float = 0.02) -> Dict:
    """YCB-Video: success where ADD(-S) < 2 cm (upstream eval_ycb.py)."""
    ds = legacy_datasets.YCBPoseDataset(
        root, data_list, classes, num_pt=state.cfg.num_points,
        num_pt_mesh=state.cfg.num_points_mesh)
    results = _run_eval(state, ds, classes, batch_size,
                        lambda obj: success_threshold)
    if out_path:
        io.write_json(out_path, results)
    return results


def eval_linemod(state: dft.TrainerState, root: str, objects: List[int],
                 batch_size: int = 8, out_path: Optional[str] = None,
                 diameter_fraction: float = 0.1) -> Dict:
    """LineMOD: success where ADD < 10 % of the object's diameter
    (upstream eval_linemod.py). A sample's object index is its LineMOD id
    - 1, so every id must be <= the PoseNet's object count."""
    _check_indices(state, [o - 1 for o in objects])
    ds = legacy_datasets.LineModPoseDataset(
        root, objects, mode="test", num_pt=state.cfg.num_points,
        num_pt_mesh=state.cfg.num_points_mesh)
    diameters = {}
    for obj in objects:
        pts = ds.cld[obj]
        center = pts.mean(axis=0)
        diameters[obj - 1] = 2.0 * float(np.linalg.norm(pts - center,
                                                        axis=1).max())
    classes = [f"obj_{o:02d}" for o in objects]
    # obj_idx in samples is (obj - 1); map positions in `classes`
    idx_map = {o - 1: i for i, o in enumerate(objects)}
    results = _scores(state, ds, batch_size, lambda o: classes[idx_map[o]],
                      lambda o: diameter_fraction * diameters[o], classes)
    if out_path:
        io.write_json(out_path, results)
    return results
