"""Order statistics of a run's samples."""

import statistics


def percentile(values, q):
    """The q-th percentile (0 < q < 100) of ``values``, interpolated between
    order statistics (``statistics.quantiles``' inclusive method)."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    cuts = statistics.quantiles(vals, n=100, method="inclusive")
    return cuts[int(round(q)) - 1]


def rate(count, seconds):
    """``count`` over all of a window's ``seconds``."""
    return count / seconds
