"""Arithmetic of the end-to-end metrics, kept apart so that tests can hold
it to hand-worked numbers."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the two
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError('no values')
    pos = (len(v) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


