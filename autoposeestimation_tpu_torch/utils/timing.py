"""Stage timing, per-epoch JSON curve logs and trace capture (port of
`autoposeestimation_tpu/utils/timing.py`).

`StageTimer` collects named stage durations on the host clock; its keys are
the live path's `elapsed_times` ({'segmentation', 'pose_estimation',
'total'} in `full_prediction`). `JsonCurveLog` is the file the live
dashboards re-read whole on every update (`scripts/stream_logs.py`).
`maybe_profile(trace_dir)` records a `torch.profiler` trace of the host and
the card into `trace_dir` as a Chrome trace."""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Named stage durations in seconds; `total()` adds the time since the
    timer was made."""

    def __init__(self) -> None:
        self._start = time.perf_counter()
        self.elapsed: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed[name] = time.perf_counter() - t0

    def total(self, name: str = "total") -> Dict[str, float]:
        self.elapsed[name] = time.perf_counter() - self._start
        return self.elapsed


class JsonCurveLog:
    """Epoch-curve log rewritten wholesale each update."""

    def __init__(self, path: Optional[str],
                 config: Optional[Dict] = None) -> None:
        self.path = path
        self.data: Dict = dict(config or {})
        self.data.setdefault("curves", {})

    def append(self, **values) -> None:
        for key, val in values.items():
            self.data["curves"].setdefault(key, []).append(
                float(val) if hasattr(val, "__float__") else val
            )
        self.flush()

    def set(self, **values) -> None:
        self.data.update(values)
        self.flush()

    def flush(self) -> None:
        if self.path is None:    # kept in memory (a rank that does not write)
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.data, f)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A `torch.profiler` trace of the host and, where there is one, the
    card while the block runs, written as `trace.json` (Chrome's trace
    format) into `trace_dir`; nothing when `trace_dir` is None."""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
