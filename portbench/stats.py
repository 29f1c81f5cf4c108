"""Window statistics over every request, and the spread of repeated runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) of all ``values``, linearly
    interpolated between order statistics (numpy's default); None for no
    values."""
    xs = sorted(values)
    if not xs:
        return None
    at = (len(xs) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def spread(values) -> float:
    """Interquartile distance over the median, with the quartiles of
    ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else math.inf
