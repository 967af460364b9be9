"""device_idle_pct.track: 1 - (union of device-activity intervals) over the
profiled stretch's wall time, in percent, in a tracking cell."""


def read(rec):
    t = rec.trace
    if rec.kind != "track" or t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
