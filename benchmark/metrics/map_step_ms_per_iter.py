"""map_step_ms_per_iter: device time under the span around
mapper._map_train_step, over the profiled stretch, per iteration."""


def read(rec):
    t = rec.trace
    if rec.kind != "map" or t is None or not rec.stretch_units:
        return None
    s = t.span_device_s.get("map.step")
    return None if not s else 1e3 * s / rec.stretch_units
