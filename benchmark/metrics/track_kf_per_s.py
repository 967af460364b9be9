"""track_kf_per_s: keyframes completed in the window over the window's
seconds (host clock; the window ends with the last keyframe's
synchronize)."""

from benchmark.yardstick import stats


def read(rec):
    if rec.kind != "track" or not rec.units:
        return None
    return stats.rate(rec.units, rec.window_s)
