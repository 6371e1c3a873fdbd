"""Statistics of the end-to-end metrics and of the bounds."""
from __future__ import annotations

import statistics


def p95(values: list[float]) -> float:
    """The 95th percentile (`statistics.quantiles`, exclusive method)."""
    return statistics.quantiles(values, n=20)[18]


def spread(values: list[float]) -> float:
    """Distance between the first and third quartile over the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
