"""Stage timing, spans and counters, per-epoch JSON curve logs and trace
capture (port of `autoposeestimation_tpu/utils/timing.py`).

`StageTimer` collects named stage durations on the host clock; its keys are
the live path's `elapsed_times` ({'segmentation', 'pose_estimation',
'total'} in `full_prediction`). `JsonCurveLog` is the file the live
dashboards re-read whole on every update (`scripts/stream_logs.py`).
`maybe_profile(trace_dir)` records a `torch.profiler` trace of the host and
the card into `trace_dir` as a Chrome trace.

The tracer: `span(name, **attrs)` marks a stage of the program and
`count(name, n)` counts an event there. Tracing is on while `enable()` is in
force or while a `torch.profiler` records; off, `span` returns one shared
object that does nothing (no clock is read, nothing is kept) and `count`
returns at once. On, a span keeps its name, attributes, id, its parent's
id, the id of its unit of work (a frame, a stream call, a training step:
every span of one unit shares it) and its start and end on
`time.perf_counter_ns`; `Records.epoch_ns` puts those on the profiler's
clock. Under a profiler a span also enters `record_function(name)`, so it
lies on the profiler's timeline beside the kernels (and in
`maybe_profile`'s trace). A count belongs to the unit of the innermost open
span. Spans and counts read no device value: neither waits for the card.
The last 65,536 finished spans are kept (`Records.dropped` counts the
ones pushed out) until `reset()`; `records()` reads them."""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

_profiler_enabled = torch.autograd._profiler_enabled
_now = time.perf_counter_ns
CAPACITY = 65536


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    unit: int
    start_ns: int           # time.perf_counter_ns
    end_ns: int
    attrs: Dict


class Records(NamedTuple):
    spans: List[Span]                                # in the order they ended
    counters: Dict[str, int]                         # name -> total
    counts: Dict[str, Dict[Optional[int], int]]      # name -> unit -> n
    dropped: int
    anchor: Tuple[int, int]     # (perf_counter_ns, time_ns) read together

    def epoch_ns(self, t: int) -> int:
        """A span's `perf_counter_ns` time on the epoch clock, which
        `torch.profiler`'s `kineto_results.trace_start_ns()` uses."""
        return self.anchor[1] + t - self.anchor[0]


def _anchor() -> Tuple[int, int]:
    return _now(), time.time_ns()


class _Off:
    """The span while tracing is off."""

    __slots__ = ()
    unit = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    """A span while tracing is on: `unit` True opens a new unit of work, an
    id joins that unit, None takes the parent's (a new one at the root)."""

    __slots__ = ("tracer", "name", "unit", "attrs", "id", "parent", "start",
                 "rf")

    def __init__(self, tracer: "Tracer", name: str, unit, attrs: Dict):
        self.tracer, self.name, self.unit, self.attrs = (tracer, name, unit,
                                                         attrs)

    def __enter__(self):
        t = self.tracer
        stack = t.stack()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.unit is True or (self.unit is None and top is None):
            self.unit = next(t.units)
        elif self.unit is None:
            self.unit = top.unit
        self.id = next(t.ids)
        stack.append(self)
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = self.tracer
        t.stack().pop()
        if len(t.spans) == CAPACITY:
            t.dropped += 1
        t.spans.append(Span(self.name, self.id, self.parent, self.unit,
                            self.start, end, self.attrs))
        return False


class Tracer:
    """The spans and counts of one process (the module's functions are this
    class's methods on one instance)."""

    def __init__(self) -> None:
        self.on = False
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.units = itertools.count(1)
        self.reset()

    def stack(self) -> List[_Live]:
        """This thread's open spans."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def span(self, name: str, unit=None, **attrs):
        if not (self.on or _profiler_enabled()):
            return _OFF
        return _Live(self, name, unit, attrs)

    def count(self, name: str, n: int = 1) -> None:
        if not (self.on or _profiler_enabled()):
            return
        stack = self.stack()
        unit = stack[-1].unit if stack else None
        by_unit = self.counts.setdefault(name, {})
        by_unit[unit] = by_unit.get(unit, 0) + n

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        self.spans = collections.deque(maxlen=CAPACITY)
        self.dropped = 0
        self.counts: Dict[str, Dict[Optional[int], int]] = {}
        self.anchor = _anchor()

    def records(self) -> Records:
        counts = {name: dict(by_unit) for name, by_unit in self.counts.items()}
        return Records(list(self.spans),
                       {name: sum(c.values()) for name, c in counts.items()},
                       counts, self.dropped, self.anchor)


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
enable = _TRACER.enable
disable = _TRACER.disable
reset = _TRACER.reset
records = _TRACER.records


class StageTimer:
    """Named stage durations in seconds; `total()` adds the time since the
    timer was made. `stage(key, span=name)` also opens the span `name`."""

    def __init__(self) -> None:
        self._start = time.perf_counter()
        self.elapsed: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, span: Optional[str] = None):
        t0 = time.perf_counter()
        try:
            with _OFF if span is None else _TRACER.span(span):
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
    format) into `trace_dir`, the program's spans in it; nothing when
    `trace_dir` is None."""
    if trace_dir is None:
        yield
        return
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
