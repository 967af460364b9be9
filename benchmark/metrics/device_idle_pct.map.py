"""device_idle_pct.map: as device_idle_pct.track, in the mapper cell."""


def read(rec):
    t = rec.trace
    if rec.kind != "map" or t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
