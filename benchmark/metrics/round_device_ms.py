"""round_device_ms: device time of the work launched inside the program's
round spans (``tracker.round.*``) over the profiled stretch, per round
(``tracker.rounds``)."""

from benchmark.yardstick.program import registry, summed


def read(rec):
    reg = registry(rec) if rec.kind == "track" else None
    if not reg:
        return None
    s = summed(rec.trace.span_device_s, "tracker.round.")
    n = reg[1].get("tracker.rounds")
    return 1e3 * s / n if s and n else None
