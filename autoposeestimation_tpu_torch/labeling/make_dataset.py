"""The train/test split writer (port of
`autoposeestimation_tpu/labeling/make_dataset.py`): every Nth labelled
sample of a run goes to the test list (N = round(1 / p_test)), the samples
of an `extra` run (pose datasets with `use_extra_data` only) to the extra
list, and classes.txt lists the objects. The lists are byte-identical to
the JAX package's."""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ..utils import io


def make_train_and_test_dataset(root: str, object_names: Sequence[str],
                                data_set_type: str, save_name: str,
                                p_test: float = 0.2, mode: str = "pred",
                                use_extra_data: bool = False) -> dict:
    """Write `<root>/label_generator/data_sets/<data_set_type>/<save_name>/`
    from the `<mode>` labels; returns the list lengths."""
    save_dir = io.dataset_dir(root, data_set_type, save_name)
    os.makedirs(save_dir, exist_ok=True)
    train: List[str] = []
    test: List[str] = []
    extra: List[str] = []

    for object_name in object_names:
        object_path = os.path.join(io.label_dir(root), object_name)
        dirs = sorted(os.listdir(object_path))
        if "extra" in dirs and (data_set_type == "segmentation"
                                or not use_extra_data):
            dirs.remove("extra")

        for d in dirs:
            run_mode = "new_pred" if d == "extra" else mode
            tag = f".{run_mode}.label.png"
            samples = sorted(s[: -len(tag)]
                             for s in os.listdir(os.path.join(object_path, d))
                             if s.endswith(tag))
            if not samples:
                continue
            if d == "extra":
                extra.extend(f"{object_name}/{d}/{s}" for s in samples)
            else:
                step = int(np.round(len(samples) / (len(samples) * p_test)))
                for i, s in enumerate(samples):
                    (test if i % step == 0 else train).append(
                        f"{object_name}/{d}/{s}")

    io.write_lines(os.path.join(save_dir, "train_data_list.txt"), train)
    io.write_lines(os.path.join(save_dir, "test_data_list.txt"), test)
    if use_extra_data:
        io.write_lines(os.path.join(save_dir, "extra_train_data_list.txt"),
                       extra)
    io.write_lines(os.path.join(save_dir, "classes.txt"), list(object_names))
    return {"train": len(train), "test": len(test), "extra": len(extra)}
