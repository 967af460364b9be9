"""The harness finds configurations, cells, limits and metrics by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.Bench()


def test_every_entry_has_its_files(bench):
    spec = bench.spec
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert bench.config(c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        assert bench.traffic(w["traffic"])["loop"] in ("track", "map")
        assert bench.limits(w["name"])["limits"]
        bench.loop(bench.traffic(w["traffic"])["loop"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_contract_shapes(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    cells = len(spec["workloads"])
    # a full check of 24 cells fits its 43,200 s
    assert ((2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    names = set()
    e2e = {m["name"] for m in spec["end_to_end"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        names.add(w["name"])
    assert len(names) == cells
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(e for e in spec["end_to_end"]
                         if e["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in e2e
    for w in spec["workloads"]:
        assert bench.metrics(w["name"], False)
        assert bench.metrics(w["name"], True)


def test_metrics_filtered_by_workloads(bench):
    rm = {m["name"] for m in bench.metrics("replica-map", True)}
    assert "knn_ms_per_iter" in rm and "track_mfu" not in rm
    tt = {m["name"] for m in bench.metrics("tum-track", True)}
    assert "depth_agree_roofline_pct" not in tt
    assert {m["name"] for m in bench.metrics("tum-track", False)} == {
        "track_kf_per_s", "track_kf_ms_p90", "setup_s"}


def test_additions_need_no_edit(tmp_path, bench):
    """A configuration, a cell and a metric added as files and entries in
    a copy are found without editing any file that was there."""
    root = tmp_path / "repo"
    here = root / "benchmark"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(bench.spec))
    cfg = bench.config("tum")
    cfg["name"] = "scannet"
    cfg["config"]["cam"].update(H_out=240, W_out=320)
    (here / "configs" / "scannet.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "scannet", "source": "s",
                            "file": "benchmark/configs/scannet.json",
                            "reduced": [], "why": "w"})
    tr = bench.traffic("track-circuit")
    tr["frames"] = 90
    (here / "traffic" / "long-circuit.json").write_text(json.dumps(tr))
    spec["workloads"].append({"name": "scannet-track", "config": "scannet",
                              "traffic": "long-circuit", "chips": 1,
                              "why": "w"})
    (here / "limits" / "scannet-track.json").write_text(
        json.dumps({"limits": {"dba": 1e-3}}))
    (here / "metrics" / "kf_count.py").write_text(
        "def read(rec):\n    return rec.units\n")
    spec["per_layer"].append({"name": "kf_count", "unit": "keyframes",
                              "better": "higher", "source": "host_clock",
                              "layer": "tracker loop",
                              "moves": "track_kf_per_s",
                              "workloads": ["scannet-track"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    b = harness.Bench(root=str(root), here=str(here))
    cell = b.cell("scannet-track")
    assert b.config(cell["config"])["config"]["cam"]["W_out"] == 320
    assert b.traffic(cell["traffic"])["frames"] == 90
    assert b.limits("scannet-track")["limits"] == {"dba": 1e-3}
    names = [m["name"] for m in b.metrics("scannet-track", True)]
    assert "kf_count" in names and "knn_ms_per_iter" not in names
    rec = harness.Record("track", {}, units=5)
    assert b.reader("kf_count")(rec) == 5
    for f in os.listdir(harness.HERE):
        p = os.path.join(harness.HERE, f)
        if os.path.isfile(p):
            assert open(p, "rb").read() == (here / f).read_bytes()
