"""The traced windows: `torch.profiler` over a fixed amount of work,
reduced to what the per-layer readers need.

The device is read from a window that records the device's activity alone
(kernels, copies, fills), so that the host runs at its own speed: host ops
recorded by the profiler slow a host-bound loop by tens of per cent. The
window runs from one marker kernel, launched once the device is idle, to
another launched once it is idle again; busy_s is the union of the
device's activity between them, window_s their distance. Kernel counts
and times by name come from the same events.

A second window of the same work records the host's ops as well, inside
one host span, and only labels the device's idle gaps: each by the
innermost host operation that was running at the middle of the gap."""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

SPAN = "port_bench.window"
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


class Trace:
    def __init__(self, window_s: float, busy_s: float,
                 kernels: Dict[str, Tuple[int, float]], device_ops: List,
                 idle_gaps: List):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels          # name -> (launches, seconds)
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps

    @property
    def launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds
        `fragment`."""
        hits = [v for k, v in self.kernels.items() if fragment in k]
        return sum(n for n, _ in hits), sum(s for _, s in hits)


def _union_seconds(starts: np.ndarray, ends: np.ndarray) -> float:
    if starts.size == 0:
        return 0.0
    order = np.argsort(starts)
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    gaps = np.clip(s[1:] - run_end[:-1], 0, None)
    return float((run_end[-1] - s[0] - gaps.sum()) * 1e-6)


def _device(events) -> List:
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != SPAN and not getattr(e, "is_user_annotation",
                                               False)]


def _clipped(dev, w0: float, w1: float):
    starts = np.array([max(e.time_range.start, w0) for e in dev], float)
    ends = np.array([min(e.time_range.end, w1) for e in dev], float)
    return starts, ends, ends > starts


def reduce_device(events, top: int = 10) -> Trace:
    """A device-only trace -> a `Trace` of the window between its two
    markers (no idle gaps labelled)."""
    dev = _device(events)
    marks = sorted((e for e in dev if MARKER in e.name),
                   key=lambda e: e.time_range.start)
    if len(marks) < 2:
        raise RuntimeError("the traced window's markers are missing")
    w0, w1 = marks[0].time_range.start, marks[-1].time_range.end
    dev = [e for e in dev if MARKER not in e.name]
    starts, ends, keep = _clipped(dev, w0, w1)
    busy = _union_seconds(starts[keep], ends[keep])
    kernels: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    for e, s, t, k in zip(dev, starts, ends, keep):
        if k:
            kernels[e.name][0] += 1
            kernels[e.name][1] += (t - s) * 1e-6
    device_ops = sorted(([k, v[1]] for k, v in kernels.items()),
                        key=lambda kv: -kv[1])[:top]
    kernels = {k: (v[0], v[1]) for k, v in kernels.items()
               if not k.startswith(("Memcpy", "Memset"))}
    return Trace((w1 - w0) * 1e-6, busy, kernels, device_ops, [])


def idle_gaps(events, top: int = 10, label: int = 64) -> List:
    """A trace of host ops and the device inside the `SPAN` host span ->
    the longest idle gaps of the device, summed by the innermost host op
    running at their middle."""
    span = [e for e in events if e.name == SPAN]
    if not span:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    dev = _device(events)
    host = [e for e in events if e.device_type
            != torch.autograd.DeviceType.CUDA and e.name != SPAN]
    starts, ends, keep = _clipped(dev, w0, w1)
    s, e = starts[keep], ends[keep]
    order = np.argsort(s)
    s, e = s[order], np.maximum.accumulate(e[order])
    gap_lo = np.concatenate([[w0], e])
    gap_hi = np.concatenate([s, [w1]])
    lengths = gap_hi - gap_lo
    pick = np.argsort(-lengths)[:label]
    h_start = np.array([x.time_range.start for x in host], float)
    h_end = np.array([x.time_range.end for x in host], float)
    h_dur = h_end - h_start
    by_name: Dict[str, float] = collections.defaultdict(float)
    for i in pick:
        if lengths[i] <= 0:
            continue
        mid = 0.5 * (gap_lo[i] + gap_hi[i])
        inside = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        name = ("(host, between recorded ops)" if inside.size == 0 else
                host[inside[np.argmin(h_dur[inside])]].name)
        by_name[name] += lengths[i] * 1e-6
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:top]


def traced(work: Callable[[], int]) -> Tuple[Trace, int]:
    """Run `work` (which returns the units it completed) twice under the
    profiler: once with the device alone recorded, between two markers,
    for the `Trace`; once with the host's ops too, for its idle gaps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        units = work()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    trace = reduce_device(prof.events())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            work()
            torch.cuda.synchronize()
    trace.idle_gaps = idle_gaps(prof.events())
    return trace, units
