"""online_ba_ms_per_kf: synchronized host span around Backend.dense_ba
(the online BA), summed over the traced run's window, per keyframe."""


def read(rec):
    s = rec.host_s.get("layer.online_ba")
    if rec.kind != "track" or not s or not rec.units:
        return None
    return 1e3 * s / rec.units
