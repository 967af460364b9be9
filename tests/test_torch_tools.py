"""The port's run tools (``glorie_slam_tpu_torch/tools/``) on the CPU, at
small sizes, against the JAX scripts they twin and the JAX artifacts.

* ``utils/synthetic.small_mapping_cfg`` equals the mapper's sections of
  ``tests/synthetic.base_cfg`` key for key (the JAX endurance run builds on
  them).
* The endurance run (``long_run``) at 48x64, 12 frames, with the
  asynchronous mapper at every keyframe: its report has the keys of
  ``logs/long_run_r03.json`` less the XLA compile and warm-up keys
  (``warmed``, ``warm_compiles``, ``late_compile_events``,
  ``late_cold_compiles``) and ``peak_hbm_bytes``, plus ``device``,
  ``peak_device_bytes``, ``kf_series``, ``mapper_overlap`` and
  ``snapshot``; one series row per window; the snapshot probe's bytes equal
  the sum of ``nbytes`` of the tensors each ``VideoSnapshot`` cloned.
* The mapper-schedule run at 48x64, 4 oracle frames and a few iterations:
  the keys of ``logs/mapper_sched_r03.json`` plus ``peak_device_bytes``;
  its report lands under its output directory only. ``convergence`` passes
  on the JAX artifact and fails on a copy whose colour stage was never
  sampled.
* The suite runner: ``parse_metrics_txt`` equals the JAX script's on the
  metrics files the port's ``utils/eval_traj`` wrote; ``scene_configs``
  skips ``demo_*`` and the base config; a run over a good and a broken
  7-Scenes-layout scene exits with 1 and still writes the good scene's row,
  and a run over the good scene alone exits with 0.
"""

import copy
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from glorie_slam_tpu_torch.mapping import async_worker
from glorie_slam_tpu_torch.tools import long_run_synthetic as long_run_mod
from glorie_slam_tpu_torch.tools import mapper_schedule_run as sched_mod
from glorie_slam_tpu_torch.tools import run_suite
from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                   small_mapping_cfg,
                                                   write_7scenes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join(ROOT, "logs")
# the tensors ``VideoSnapshot`` clones from the live video
CLONED = ("poses", "disps_up", "intrinsics", "timestamp", "depth_scale",
          "depth_shift", "_valid_depth_mask")


def _jax_log(name):
    with open(os.path.join(LOGS, name)) as f:
        return json.load(f)


def test_small_mapping_cfg_equals_jax_base_cfg():
    from synthetic import base_cfg as jax_base_cfg

    jax_cfg = jax_base_cfg(H=48, W=64)
    port = small_mapping_cfg()
    assert set(port) == {"setup_seed", "mapping", "rendering",
                         "pointcloud", "model", "meshing"}
    for k in port:
        assert port[k] == jax_cfg[k], k


@pytest.fixture(scope="module")
def endurance(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("long_run"))
    snaps = []

    class Recorded(async_worker.VideoSnapshot):
        def __init__(self, video):
            super().__init__(video)
            snaps.append(self)

    base = async_worker.VideoSnapshot
    async_worker.VideoSnapshot = Recorded
    try:
        report = long_run_mod.long_run(12, out, mapping=True, every_kf=1,
                                       H=48, W=64, device="cpu", window=4)
    finally:
        async_worker.VideoSnapshot = base
    return out, report, snaps


def test_endurance_report_has_the_jax_keys(endurance):
    out, report, _ = endurance
    jax_keys = set(_jax_log("long_run_r03.json"))
    assert set(report) == (jax_keys - {
        "warmed", "warm_compiles", "late_compile_events",
        "late_cold_compiles", "peak_hbm_bytes"}) | {
        "device", "peak_device_bytes", "kf_series", "mapper_overlap",
        "snapshot"}
    assert set(report["mapper_overlap"]) == {
        "mapped_keyframes", "mapper_busy_s", "mapper_steps_per_s",
        "snapshot_lag_s_mean", "snapshot_lag_s_max", "tracker_blocked_s"}
    assert report["device"] == "cpu" and report["peak_device_bytes"] is None
    assert report["n_frames"] == 12 and report["n_keyframes"] == 12
    with open(os.path.join(out, "test", "synth", "logs",
                           "long_run.json")) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert os.path.exists(os.path.join(out, "test", "synth", "video.npz"))


def test_endurance_series_has_one_row_per_window(endurance):
    _, report, _ = endurance
    rows = report["kf_series"]
    assert [r["frame"] for r in rows] == [4, 8, 12]
    assert [r["counter"] for r in rows] == [4, 8, 12]
    # the frontend counts keyframes from its initialisation (warmup 8) on
    assert sum(r["keyframes"] for r in rows) == 12 - 8 + 1
    for r in rows:
        assert r["wall_s"] > 0 and "frontend" in r["phases_s"]


def test_endurance_snapshot_probe_counts_the_cloned_bytes(endurance):
    _, report, snaps = endurance
    s = report["snapshot"]
    assert len(snaps) == s["handshakes"] == \
        report["mapper_overlap"]["mapped_keyframes"] > 0
    assert s["bytes"] == [sum(getattr(x, n).nbytes for n in CLONED)
                          for x in snaps]
    assert s["rows"] == [len(x.timestamp) for x in snaps]
    last = snaps[-1]
    per_row = sum(getattr(last, n)[0].nbytes for n in CLONED
                  if n != "intrinsics")
    assert s["bytes_per_row"] == per_row
    # 7 pose floats, timestamp, scale, shift; disparity and mask per pixel
    replica = (7 + 3) * 4 + 680 * 1200 * (4 + 1)
    assert s["replica_680x1200_300kf_bytes_arithmetic"] == \
        last.intrinsics.nbytes + 305 * replica
    assert s["clone_timer"] == "host_clock"
    assert len(s["clone_ms"]) == s["handshakes"]
    assert async_worker.VideoSnapshot.__name__ == "VideoSnapshot"


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def schedule(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mapper_schedule"))
    before = _digest(os.path.join(LOGS, "mapper_sched_r03.json"))
    report = sched_mod.schedule_run(
        out, light=True, H=48, W=64, n_frames=4, device="cpu",
        cuts={"mapping": dict(iters=2, iters_first=2, geo_iter_first=1,
                              pixels=64, pixels_adding=96)})
    assert _digest(os.path.join(LOGS, "mapper_sched_r03.json")) == before
    return out, report


def test_mapper_schedule_report_has_the_jax_keys(schedule):
    out, report = schedule
    assert set(report) == set(_jax_log("mapper_sched_r03.json")) | {
        "peak_device_bytes"}
    assert set(report["schedule"]) == set(
        _jax_log("mapper_sched_r03.json")["schedule"])
    assert report["schedule"]["geo_iter_ratio"] == 0.4
    assert report["approx_train_iters"] == 2 + 2 + 2 * 2 * 5
    assert report["platform"] == "cpu" and report["n_points"] > 0
    assert np.isfinite(report["final_psnr_kf4"])
    hist = report["loss_history"]
    assert {h["idx"] for h in hist if not h["refine"]} == {0, 2}
    assert {h["idx"] for h in hist if h["refine"]} == {3}
    logs = os.path.join(out, "test", "synth", "logs")
    assert os.listdir(logs) == ["mapper_schedule.json"]
    assert os.path.exists(os.path.join(out, "test", "synth",
                                       "final_point_cloud.npy"))


def test_convergence_holds_the_jax_artifact():
    art = _jax_log("mapper_sched_r03.json")
    res = sched_mod.convergence(art)
    assert res["failures"] == [], res
    json.dumps(res)                              # plain ints
    assert res["keyframes"] == 5 and res["color_sampled"] >= 2
    never = copy.deepcopy(art)
    never["loss_history"] = [h for h in never["loss_history"]
                             if h["stage"] != "color" or h["refine"]]
    res = sched_mod.convergence(never)
    assert res["color_sampled"] == 0
    assert res["failures"] == ["colour stage sampled on 0 keyframes, "
                               "fewer than 2"]
    short = dict(art, approx_train_iters=3999)
    assert sched_mod.convergence(short)["failures"] == [
        "3999 train iterations, fewer than 4000"]


def _jax_run_suite():
    spec = importlib.util.spec_from_file_location(
        "jax_run_suite", os.path.join(ROOT, "scripts", "run_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H, W = 60, 80
SCENE = """\
inherit_from: {base}
scene: {scene}
setting: test
tracking:
  buffer: 16
  warmup: 5
  motion_filter:
    thresh: 0.0
  frontend:
    keyframe_thresh: 0.0
cam:
  H: {H}
  W: {W}
  fx: 64.0
  fy: 64.0
  cx: {cx}
  cy: {cy}
  H_edge: 4
  W_edge: 4
  H_out: 48
  W_out: 64
mono_prior:
  predict_online: False
data:
  input_folder: {data}
  output: {out}
"""


def _write_suite(base, scenes):
    """A configs-like directory: a base YAML inheriting the repo's
    7-Scenes config, a ``demo_`` file and one YAML per (name, data
    folder)."""
    suite = base / "suite"
    suite.mkdir()
    (suite / "base7.yaml").write_text(
        f"inherit_from: {ROOT}/configs/7scenes/7scenes.yaml\n")
    for name, data in (("demo_skip", base / "data"), *scenes):
        (suite / f"{name}.yaml").write_text(SCENE.format(
            base=suite / "base7.yaml", scene=name, H=H, W=W,
            cx=W / 2 - 0.5, cy=H / 2 - 0.5, data=data, out=base / "out"))
    return suite


@pytest.fixture(scope="module")
def suite_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("suite")
    stream = SyntheticStream(n_frames=7, H=H, W=W, seed=2,
                             trajectory="circuit",
                             intrinsics=[64.0, 64.0, W / 2 - 0.5,
                                         H / 2 - 0.5])
    write_7scenes(str(base / "data"), stream)
    suite = _write_suite(base, [("good", base / "data"),
                                ("broken", base / "no_such_folder")])
    args = ["--only_tracking", "--max_frames", "7", "--device", "cpu"]
    out = str(base / "mixed.json")
    rc_mixed = run_suite.main([str(suite), *args, "--out", out])
    with open(out) as f:
        mixed = json.load(f)
    with open(str(base / "mixed.md")) as f:
        table = f.read()
    (suite / "broken.yaml").unlink()
    rc_clean = run_suite.main([str(suite), *args, "--out",
                               str(base / "clean.json")])
    return base, suite, rc_mixed, mixed, table, rc_clean


def test_scene_discovery_skips_demo_and_base(tmp_path):
    suite = _write_suite(tmp_path, [("b", tmp_path), ("a", tmp_path)])
    assert run_suite.scene_configs(str(suite)) == [
        str(suite / "a.yaml"), str(suite / "b.yaml")]
    (suite / "c.yaml").write_text("inherit_from: ./other/base7.yaml\n")
    assert run_suite.scene_configs(str(suite)) == [
        str(suite / n) for n in ("a.yaml", "b.yaml", "c.yaml")]
    assert run_suite.scene_configs(str(tmp_path / "nowhere")) == []


def test_suite_records_a_failed_scene_and_exits_1(suite_runs):
    base, suite, rc_mixed, mixed, table, rc_clean = suite_runs
    assert rc_mixed == 1 and rc_clean == 0
    assert [r["scene"] for r in mixed["results"]] == ["good"]
    assert [f["config"] for f in mixed["failures"]] == [
        str(suite / "broken.yaml")]
    assert mixed["failures"][0]["traceback"]
    good = mixed["results"][0]
    assert good["n_keyframes"] == 7 and "ate_rmse_m" in good["kf"]
    assert "ate_rmse_m" in good["full"] and "phases" in good["phase_times"]
    assert mixed["avg_kf_ate_rmse_m"] == good["kf"]["ate_rmse_m"]
    assert table.splitlines()[2].startswith("| good | 7 |")
    assert len(table.splitlines()) == 4            # header, rule, row, avg


def test_parse_metrics_matches_the_jax_script(suite_runs):
    jax_suite = _jax_run_suite()
    traj = suite_runs[0] / "out" / "test" / "good" / "traj"
    for name in ("metrics_kf_traj.txt", "metrics_full_traj.txt"):
        path = str(traj / name)
        got = run_suite.parse_metrics_txt(path)
        assert got and got == jax_suite.parse_metrics_txt(path), name
    assert run_suite.parse_metrics_txt(str(traj / "missing.txt")) == {}


@pytest.mark.parametrize("tool", ["long_run", "mapper_schedule", "suite"])
def test_tools_need_the_card_unless_told(tool, tmp_path, monkeypatch):
    """Without ``--device cpu`` each tool asks for the card, and raises
    where there is none, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = {
        "long_run": (long_run_mod.main, ["4", str(tmp_path / "o")]),
        "mapper_schedule": (sched_mod.main, [str(tmp_path / "o")]),
        "suite": (run_suite.main, [str(tmp_path)]),
    }[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert os.listdir(tmp_path) == []
