"""dpt_device_ms_per_kf: device time of the work launched inside the
program's span ``mono_prior.dpt`` (the DPT's forward) over the profiled
stretch, per keyframe."""


def read(rec):
    t = rec.trace
    if rec.kind != "track" or t is None or not rec.stretch_units:
        return None
    s = t.span_device_s.get("mono_prior.dpt")
    return None if not s else 1e3 * s / rec.stretch_units
