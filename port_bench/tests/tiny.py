"""A cell of the benchmark cut to a size the CPU runs in seconds: two
objects, 96x128 frames, 64 points, crops of 32, batches of 2. The widths
of the networks stay as published."""
from __future__ import annotations

import copy
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness.files import Cell  # noqa: E402

SMALL_LAYOUT = {
    "rings": [{"radius_mm": 90, "count": 2, "height_mm": 40,
               "sphere_mm": 45}],
    "camera": {"ring_radius_mm": 500, "height_mm": 450, "focal_px": 140}}


def tiny_cell(name: str, dtype: str = "float32", root: str = BENCH) -> Cell:
    """`name` (of the benchmark in `root`) cut small; in float32 the
    symmetric loss's distances are float32 too, so that a sound run reads
    float32's rounding (at 32 model points the bf16 distances' other
    matches move a leaf's gradient by tens of per cent)."""
    cell = Cell(name, root)
    cfg = copy.deepcopy(cell.config)
    cfg.update(num_objects=2, seg_classes=3, image_hw=[96, 128],
               num_points=64, num_points_mesh=32, crop=32, dtype=dtype)
    cfg["train"].update(batch_size=2, sym_bf16=dtype != "float32")
    cell.config = cfg
    traffic = copy.deepcopy(cell.traffic)
    traffic.update(pool=4, trace_units=2)
    if "warmup" in traffic:
        traffic.update(warmup=min(traffic["warmup"], 4), check_frames=3,
                       layout=SMALL_LAYOUT)
    cell.traffic = traffic
    if dtype == "float32" and "seg_gap" in cell.limits:
        # the tie margin of the logits: in float32 the program's logits
        # meet the reference's to about 1e-6, not to bfloat16's 0.05
        cell.limits = copy.deepcopy(cell.limits)
        cell.limits["seg_gap"]["limit"] = 1e-3
    return cell
