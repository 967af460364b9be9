"""host_syncs_per_kf: calls that block the host on the card (the program's
``sync.*`` counters: device-to-host reads and copies from pageable host
memory) over the profiled stretch, per keyframe."""

from benchmark.yardstick.program import registry, summed


def read(rec):
    reg = registry(rec) if rec.kind == "track" else None
    n = reg and summed(reg[1], "sync.")
    return n / rec.stretch_units if n else None
