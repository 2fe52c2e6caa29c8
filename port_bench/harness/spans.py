"""What the readers of the program's spans and counter share: the records
of the port's tracer (`utils/timing.py::records`), cut to the units of the
first traced window.

The program records spans and counts only while a profiler records (or
its tracing is enabled), and `run.py` profiles nothing before the traced
windows (`harness/trace.py`). The first `ctx.traced_units` frames or steps
that the tracer holds are therefore those of the first traced window,
which records the device alone, so that the host runs near its own speed.
A unit is one `frame` span (a frame), one `stream.dispatch` span (its
`frames` frames) or one `step` span (a step). Times are host time in that
window, not scaled to the untraced one.

Each reader returns None where there is nothing to read: a program without
the tracer, no unit recorded, or none of the spans it reads."""
from __future__ import annotations

from typing import Dict, Iterable, Optional

UNIT_SPANS = ("frame", "stream.dispatch", "step")


def records():
    """The tracer's records, or None where the program has no tracer."""
    try:
        from autoposeestimation_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "records", None)
    return None if read is None else read()


def first_units(rec, amount: int) -> Dict[int, int]:
    """{unit id: frames (1 a step)} of the first units, in the order they
    started, until they hold `amount` frames or steps."""
    heads = sorted((s for s in rec.spans if s.name in UNIT_SPANS),
                   key=lambda s: s.unit)
    units: Dict[int, int] = {}
    for s in heads:
        if sum(units.values()) >= amount:
            break
        units[s.unit] = s.attrs.get("frames", 1)
    return units


def ms_per_unit(ctx, names: Iterable[str]) -> Optional[float]:
    """Host ms of the spans named `names` in the first traced window, over
    its frames or steps."""
    rec = records()
    if rec is None:
        return None
    units = first_units(rec, ctx.traced_units)
    names = set(names)
    ns = [s.end_ns - s.start_ns for s in rec.spans
          if s.unit in units and s.name in names]
    if not ns:
        return None
    return sum(ns) * 1e-6 / sum(units.values())


def count_per_unit(ctx, name: str) -> Optional[float]:
    """The counter `name` in the first traced window, over its frames or
    steps."""
    rec = records()
    if rec is None:
        return None
    units = first_units(rec, ctx.traced_units)
    if not units:
        return None
    by_unit = rec.counts.get(name, {})
    return sum(by_unit.get(u, 0) for u in units) / sum(units.values())
