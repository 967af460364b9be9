"""launches_per_kf: kernels in the profiled stretch per keyframe."""


def read(rec):
    t = rec.trace
    if rec.kind != "track" or t is None or not rec.stretch_units:
        return None
    return t.kernels / rec.stretch_units
