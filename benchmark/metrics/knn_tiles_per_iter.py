"""knn_tiles_per_iter: point tiles the kNN scanned (the program's counter
``knn.tiles``, ``n_scan // tile`` per ``knn_search`` call: in this cell the
mapper's render and ``sample_near_cloud``) over the profiled stretch, per
train iteration."""

from benchmark.yardstick.program import registry


def read(rec):
    reg = registry(rec) if rec.kind == "map" else None
    n = reg and reg[1].get("knn.tiles")
    return n / rec.stretch_units if n else None
