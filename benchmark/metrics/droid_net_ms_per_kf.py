"""droid_net_ms_per_kf: device time of the work launched under the spans
that hooks on the DROID net's encoders and update module open, over the
profiled stretch, per keyframe."""


def read(rec):
    t = rec.trace
    if rec.kind != "track" or t is None or not rec.stretch_units:
        return None
    s = t.span_device_s.get("droid_net")
    return None if not s else 1e3 * s / rec.stretch_units
