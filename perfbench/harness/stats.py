"""Percentiles as the benchmark reports them."""

from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float | None:
    """The ``q``-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least ``q`` of the sample at or under it. None when empty."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(q * len(vals)) - 1)]
