"""ba_edges_per_round: edges of each round's BA (the program's counter
``tracker.ba_edges``: the inactive block and the active edges, added once a
round) over the profiled stretch, per round (``tracker.rounds``)."""

from benchmark.yardstick.program import registry


def read(rec):
    reg = registry(rec) if rec.kind == "track" else None
    if not reg:
        return None
    n, e = reg[1].get("tracker.rounds"), reg[1].get("tracker.ba_edges")
    return e / n if n and e else None
