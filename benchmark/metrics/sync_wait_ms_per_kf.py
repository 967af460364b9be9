"""sync_wait_ms_per_kf: host milliseconds inside the program's ``sync.*``
spans (the host waiting for the card to drain its queue, and the copy)
over the profiled stretch, per keyframe."""

from benchmark.yardstick.program import registry, summed


def read(rec):
    reg = registry(rec) if rec.kind == "track" else None
    s = reg and summed(reg[0], "sync.", "host_s")
    return 1e3 * s / rec.stretch_units if s else None
