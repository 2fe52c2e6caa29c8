"""Acquisition maintenance (port of
`autoposeestimation_tpu/acquisition/maintenance.py`, reference
data_generation/clean_extra_data.py and fix_symmetric.py): delete the extra
samples whose object_pose rotation is not their run's, and rewrite the
`symmetric` flag of every meta file."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..utils import io


def fix_symmetric(root: str, object_name: str, symmetric: int = 0) -> int:
    """Rewrite `symmetric` in every meta.json of the object. Returns the
    number of files updated."""
    n = 0
    base = os.path.join(io.data_dir(root), object_name)
    for run in io.list_runs(root, object_name):
        run_dir = os.path.join(base, run)
        for fn in os.listdir(run_dir):
            if not fn.endswith(".meta.json"):
                continue
            path = os.path.join(run_dir, fn)
            meta = io.read_sample_meta(path)
            meta["symmetric"] = int(symmetric)
            io.write_sample_meta(path, meta)
            n += 1
    return n


def clean_extra_data(root: str, object_name: str) -> Dict[str, int]:
    """Split the timestamped extra samples into one segment a run at the
    largest timestamp gaps (the pauses while the object is turned), then
    delete each sample whose object_pose rotation is not that of its
    segment's run. Returns {'kept': n, 'deleted': n}."""
    extra_dir = os.path.join(io.data_dir(root), object_name, "extra")
    if not os.path.isdir(extra_dir):
        return {"kept": 0, "deleted": 0}

    runs = [r for r in io.list_runs(root, object_name)
            if r not in ("background", "extra")]
    run_rotations = []
    for run in runs:
        run_dir = os.path.join(io.data_dir(root), object_name, run)
        ids = io.list_sample_ids(run_dir)
        if not ids:
            continue
        meta = io.read_sample_meta(
            os.path.join(run_dir, ids[0] + ".meta.json"))
        run_rotations.append(np.asarray(meta["object_pose"])[:3, :3])

    stems = sorted(io.list_sample_ids(extra_dir), key=float)
    if not stems or not run_rotations:
        return {"kept": 0, "deleted": 0}
    times = np.asarray([float(s) for s in stems])
    n_splits = len(run_rotations) - 1
    if n_splits > 0 and len(times) > 1:
        gaps = np.diff(times)
        split_points = np.sort(np.argsort(gaps)[-n_splits:]) + 1
    else:
        split_points = []
    segments = np.split(np.arange(len(stems)), split_points)

    kept = deleted = 0
    for seg_idx, seg in enumerate(segments):
        want = run_rotations[min(seg_idx, len(run_rotations) - 1)]
        for i in seg:
            stem = stems[i]
            meta = io.read_sample_meta(
                os.path.join(extra_dir, stem + ".meta.json"))
            got = np.asarray(meta["object_pose"])[:3, :3]
            if np.allclose(got, want, atol=1e-9):
                kept += 1
            else:
                deleted += 1
                for suffix in (".color.png", ".depth.png", ".meta.json"):
                    p = os.path.join(extra_dir, stem + suffix)
                    if os.path.exists(p):
                        os.remove(p)
    return {"kept": kept, "deleted": deleted}
