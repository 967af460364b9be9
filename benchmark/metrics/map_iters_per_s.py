"""map_iters_per_s: train iterations completed in the window over the
window's seconds (the window closes with a synchronize of the mapper's
stream)."""

from benchmark.yardstick import stats


def read(rec):
    if rec.kind != "map" or not rec.units:
        return None
    return stats.rate(rec.units, rec.window_s)
