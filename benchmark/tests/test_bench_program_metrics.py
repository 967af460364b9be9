"""The readers of the program's own spans and counters (``metrics/`` over
``yardstick/program.py``): a traced tiny run gives each a value or None
without raising, a second traced run in the same process reads the same
round count (the program's sums hold one profiler session), and an untraced
record reads as nothing."""

import pytest

from benchmark import harness
from benchmark.loops import map as map_loop, track as track_loop
from benchmark.tests import tiny

NEW = ("rounds_per_kf", "ba_edges_per_round", "round_host_ms",
       "round_device_ms", "host_syncs_per_kf", "sync_wait_ms_per_kf",
       "dpt_device_ms_per_kf", "knn_tiles_per_iter", "ray_batch_ms_per_iter")
SECONDS = {"tum-track": 12.0, "replica-map": 6.0}


def _traced(cell, monkeypatch):
    """A traced tiny run of ``cell`` -> (its result, its record)."""
    loop = track_loop if cell.endswith("track") else map_loop
    inner, recs = loop.run, []

    def run(ctx):
        out = inner(ctx)
        recs.append(out[0])
        return out
    monkeypatch.setattr(loop, "run", run)
    res = tiny.run(cell, seconds=SECONDS[cell], trace=True)
    return res, recs[-1]


@pytest.mark.parametrize("cell", ["tum-track", "replica-map"])
def test_new_readers_read_a_traced_tiny_run(cell, monkeypatch):
    tiny.small_dpt(monkeypatch)
    res, rec = _traced(cell, monkeypatch)
    assert rec.trace is not None and rec.stretch_units > 0
    bench = harness.Bench()
    vals = {m: bench.reader(m)(rec) for m in NEW}
    if cell == "tum-track":
        assert vals["rounds_per_kf"] == 12.0
        assert vals["ba_edges_per_round"] > 0
        assert vals["host_syncs_per_kf"] > 0
        assert vals["knn_tiles_per_iter"] is None
        assert res["metrics"]["rounds_per_kf"]["value"] == 12.0
    else:
        assert vals["knn_tiles_per_iter"] > 0
        assert vals["ray_batch_ms_per_iter"] > 0
        assert vals["rounds_per_kf"] is None
    # the CPU has no device time under the program's spans
    assert vals["round_device_ms"] is None
    assert vals["dpt_device_ms_per_kf"] is None
    rec.trace = None
    assert all(bench.reader(m)(rec) is None for m in NEW)


def test_two_traced_runs_read_the_same_rounds(monkeypatch):
    tiny.small_dpt(monkeypatch)
    first = tiny.run("tum-track", seconds=SECONDS["tum-track"], trace=True)
    second = tiny.run("tum-track", seconds=SECONDS["tum-track"], trace=True)
    assert (first["metrics"]["rounds_per_kf"]["value"]
            == second["metrics"]["rounds_per_kf"]["value"] == 12.0)
