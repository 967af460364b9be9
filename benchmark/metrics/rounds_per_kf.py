"""rounds_per_kf: GRU + BA rounds run (the program's counter
``tracker.rounds``, one per round of ``fused.graph_update_rounds``) over
the profiled stretch, per keyframe."""

from benchmark.yardstick.program import registry


def read(rec):
    reg = registry(rec) if rec.kind == "track" else None
    n = reg and reg[1].get("tracker.rounds")
    return n / rec.stretch_units if n else None
