"""The arithmetic of the end-to-end metrics, apart from any device so that
it is tested on synthetic timings."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work over the whole window (all the work the window completed, all
    its time)."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between the two
    nearest ranks, numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_unit_ms(seconds: float, units: int) -> float:
    """Milliseconds per completed unit over the whole window."""
    if units <= 0:
        raise ValueError("no unit completed in the window")
    return 1e3 * seconds / units

