"""round_host_ms: host milliseconds inside the program's round spans
(``tracker.round.pose_depth`` and ``tracker.round.depth_scale``,
unsynchronized: dispatch and blocking reads) over the profiled stretch,
per round (``tracker.rounds``)."""

from benchmark.yardstick.program import registry, summed


def read(rec):
    reg = registry(rec) if rec.kind == "track" else None
    if not reg:
        return None
    s = summed(reg[0], "tracker.round.", "host_s")
    n = reg[1].get("tracker.rounds")
    return 1e3 * s / n if s and n else None
