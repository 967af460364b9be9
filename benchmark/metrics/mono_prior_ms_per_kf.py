"""mono_prior_ms_per_kf: synchronized host span around the mono-prior
predictor that MotionFilter calls (the DPT and its .npy cache), summed over
the traced run's window, per keyframe."""


def read(rec):
    s = rec.host_s.get("layer.mono_prior")
    if rec.kind != "track" or not s or not rec.units:
        return None
    return 1e3 * s / rec.units
