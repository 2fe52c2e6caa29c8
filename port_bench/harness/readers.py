"""The arithmetic the per-layer readers share. Each returns None where its
run has nothing to read, and the metric is then left out of the line."""
from __future__ import annotations

from typing import Optional

from harness.stats import PEAK_BF16_FLOPS


def idle_pct(ctx) -> Optional[float]:
    """The share of the measured window in which nothing ran on the
    device: the device's busy time a unit in the traced window (which the
    profiler does not stretch) times the units a second of the untraced
    window (which the profiler would: it slows the host's launches)."""
    t, w = ctx.trace, ctx.window
    if ctx.traced_units <= 0 or t.busy_s <= 0 or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / ctx.traced_units
                    * w["units"] / w["seconds"])


def launches_per_unit(ctx) -> Optional[float]:
    """Kernels launched in the traced window over its units."""
    if ctx.traced_units <= 0 or ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / ctx.traced_units


def mfu_pct(ctx, flops: float) -> Optional[float]:
    """`flops` of work done in the untraced window over its seconds, as a
    share of the bf16 dense peak."""
    w = ctx.window
    if w["seconds"] <= 0 or flops <= 0:
        return None
    return 100.0 * flops / w["seconds"] / PEAK_BF16_FLOPS
