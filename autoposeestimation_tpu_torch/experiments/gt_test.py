"""Segmentation-label quality against hand-labelled ground truth (port of
`autoposeestimation_tpu/experiments/gt_test.py`, reference
experiments/gt_test.py): for a repeatable random ~20 % of the frames,
compare each label mode ('gen' / 'pred' / 'new_pred') with the ground-truth
masks by pixelwise IoU, accuracy, precision and recall, and the share of
frames with IoU >= 0.5. Host-side numpy; the draw is Python's
`random.Random(seed)`, as in the JAX package."""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import io


def compute_metrics(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    p = pred > 0
    g = gt > 0
    tp = float(np.sum(p & g))
    fp = float(np.sum(p & ~g))
    fn = float(np.sum(~p & g))
    tn = float(np.sum(~p & ~g))
    return {
        "iou": tp / max(tp + fp + fn, 1.0),
        "accuracy": (tp + tn) / max(tp + tn + fp + fn, 1.0),
        "precision": tp / max(tp + fp, 1.0),
        "recall": tp / max(tp + fn, 1.0),
    }


def select_samples_for_gt_test(root: str, objects: Sequence[str],
                               p: float = 0.2, seed: int = 0,
                               persist: bool = False) -> List[str]:
    """A repeatable random p-fraction of the frames of each object run.
    Returns 'obj/run/stem' strings.

    With `persist`, the selection is marked in each sample's acquisition
    meta.json (`gt_test_sample: true`), as the reference does, and a
    selection persisted before is reused instead of drawn anew."""
    rng = random.Random(seed)
    selected = []
    for obj in objects:
        for run in io.list_runs(root, obj):
            if run in ("background", "extra"):
                continue
            run_dir = os.path.join(io.data_dir(root), obj, run)
            ids = io.list_sample_ids(run_dir)
            persisted = []
            if persist:
                for stem in ids:
                    meta = io.read_sample_meta(
                        os.path.join(run_dir, stem + ".meta.json"))
                    if meta.get("gt_test_sample"):
                        persisted.append(stem)
            if persisted:
                chosen = persisted
            else:
                k = max(int(len(ids) * p), 1)
                chosen = sorted(rng.sample(ids, k))
                if persist:
                    for stem in chosen:
                        path = os.path.join(run_dir, stem + ".meta.json")
                        meta = io.read_sample_meta(path)
                        meta["gt_test_sample"] = True
                        io.write_sample_meta(path, meta)
            selected.extend(f"{obj}/{run}/{stem}" for stem in chosen)
    return selected


def gt_test(root: str, objects: Sequence[str],
            modes: Sequence[str] = ("gen", "pred", "new_pred"),
            gt_mode: str = "gt", samples: Optional[List[str]] = None,
            iou_threshold: float = 0.5) -> Dict:
    """Evaluate every label mode against the `<stem>.<gt_mode>.label.png`
    masks. Returns {mode: {metric: mean, 'iou>=0.5': rate, 'n': count}}."""
    samples = samples if samples is not None else select_samples_for_gt_test(
        root, objects)
    out: Dict = {}
    for mode in modes:
        acc: Dict[str, List[float]] = {"iou": [], "accuracy": [],
                                       "precision": [], "recall": []}
        n_above = 0
        n = 0
        for stem in samples:
            gt_path = os.path.join(io.label_dir(root),
                                   f"{stem}.{gt_mode}.label.png")
            pred_path = os.path.join(io.label_dir(root),
                                     f"{stem}.{mode}.label.png")
            if not (os.path.exists(gt_path) and os.path.exists(pred_path)):
                continue
            m = compute_metrics(io.read_label(pred_path),
                                io.read_label(gt_path))
            for k, v in m.items():
                acc[k].append(v)
            n_above += int(m["iou"] >= iou_threshold)
            n += 1
        out[mode] = {k: float(np.mean(v)) if v else float("nan")
                     for k, v in acc.items()}
        out[mode]["iou>=0.5"] = n_above / n if n else float("nan")
        out[mode]["n"] = n
    return out
