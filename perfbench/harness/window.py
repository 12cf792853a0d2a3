"""Window arithmetic: what of each request falls inside the measured
window, and percentiles over all requests."""

from __future__ import annotations

import math


def overlap(a0: float, a1: float, w0: float, w1: float) -> float:
    """Length of [a0, a1] inside [w0, w1]."""
    return max(0.0, min(a1, w1) - max(a0, w0))


def prorated(n: float, t0: float, t1: float, w0: float, w1: float) -> float:
    """The part of ``n`` units of work spread evenly over [t0, t1] that lies
    inside [w0, w1]; work done in an instant counts where it falls."""
    if t1 <= t0:
        return float(n) if w0 <= t1 < w1 else 0.0
    return n * overlap(t0, t1, w0, w1) / (t1 - t0)


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) of ``values`` by linear interpolation
    between the closest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def in_window(t: float | None, w0: float, w1: float) -> bool:
    return t is not None and w0 <= t < w1
