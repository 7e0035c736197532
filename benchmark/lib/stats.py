"""Percentiles over every sample given."""

import math


def percentile(values, q):
    """The ``q``-th percentile (0-100) of all ``values``, by linear
    interpolation between order statistics (numpy's default). None for
    no values."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)

