"""The arithmetic of the end-to-end metrics, apart from any device."""
from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """All the work completed in a window over the window's whole time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

