"""The statistics of a window: a rate over the whole window and a
percentile over all of its units."""
from __future__ import annotations

import math
from typing import Sequence

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16, data sheet (700 W)


def rate(units: float, seconds: float) -> float:
    """Units over the whole window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks
    (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

