"""Order statistics over all the samples of a window."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest sample with at
    least q % of all samples at or below it."""
    if not values:
        raise ValueError("percentile of no samples")
    if not 0 < q <= 100:
        raise ValueError(f"q must lie in (0, 100], got {q}")
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)), 1) - 1]


def spread(values) -> float:
    """The distance between the first and third quartiles (``statistics.quantiles``,
    n=4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def quarter_means(values) -> tuple[float, float]:
    """The mean of the first and of the last quarter of a sequence (at least one each)."""
    k = max(len(values) // 4, 1)
    return statistics.fmean(values[:k]), statistics.fmean(values[-k:])
