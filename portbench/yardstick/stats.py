"""The arithmetic of the end-to-end metrics: a rate over all the work
and all the time of the window, a percentile over all passes, and the
quartile spread that sets a bound."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(nbytes_per_pass: int, spans: Sequence[tuple]) -> float:
    """Bytes a second of the passes ``spans`` ((start, end) host
    seconds, back to back): every pass's bytes over the time from the
    first start to the last end."""
    if not spans:
        raise ValueError("no pass completed")
    elapsed = spans[-1][1] - spans[0][0]
    return len(spans) * nbytes_per_pass / elapsed


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of every value, linear between the two
    nearest ranks (numpy's default method)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def quartile_spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile, as
    ``statistics.quantiles(values, n=4)`` gives them, over the
    median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
