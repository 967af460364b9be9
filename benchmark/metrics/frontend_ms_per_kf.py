"""frontend_ms_per_kf: synchronized host span around Frontend.__call__,
summed over the traced run's window, per keyframe."""


def read(rec):
    s = rec.host_s.get("layer.frontend")
    if rec.kind != "track" or not s or not rec.units:
        return None
    return 1e3 * s / rec.units
