"""track_kf_ms_p90: the 90th percentile of every keyframe's time in the
window, from handing the frame to Tracker.step to its return and
synchronize."""

from benchmark.yardstick import stats


def read(rec):
    if rec.kind != "track" or not rec.samples:
        return None
    return 1e3 * stats.percentile(rec.samples, 90)
