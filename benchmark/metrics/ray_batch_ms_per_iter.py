"""ray_batch_ms_per_iter: host milliseconds inside the program's span
``mapper.ray_batch`` (each step's pixel sampling on the host and its upload
to the card) over the profiled stretch, per train iteration."""

from benchmark.yardstick.program import registry


def read(rec):
    reg = registry(rec) if rec.kind == "map" else None
    s = reg and reg[0].get("mapper.ray_batch")
    return 1e3 * s["host_s"] / rec.stretch_units if s else None
