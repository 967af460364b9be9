"""The port's spans and counters (``utils/phase_timer.py``): silent without
a profiler, nested in the profiler's trace with one, counting what ran,
changing no number, and holding one profiler session at a time.

A 48x64 tracker with bench.py's thresholds (every frame a keyframe) runs
on the CPU; online BA is off, so every kept keyframe runs 12 rounds of
``fused.graph_update_rounds`` (8, then 4 in loop closure or 4 more).
"""

import json
import tempfile

import numpy as np
import pytest
import torch

from glorie_slam_tpu_torch.core.depth_video import DepthVideo
from glorie_slam_tpu_torch.geom import ba as ba_mod
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.tracking.tracker import Tracker
from glorie_slam_tpu_torch.utils import phase_timer
from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream, bench_cfg

H, W = 48, 64
WARM = 5            # frames tracked before the profiled ones (warmup 4)


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _tracker(stream):
    cfg = bench_cfg(H=H, W=W, buffer=16)
    tc = cfg["tracking"]
    tc["warmup"] = 4
    tc["frontend"].update(window=5, max_factors=48, enable_online_ba=False)
    tc["backend"].update(loop_window=5, loop_nms=2)
    net = TrackerNet(dtype=torch.float32, seed=1, device="cpu")
    video = DepthVideo(cfg, device="cpu")
    tracker = Tracker(net, video, cfg,
                      mono_predictor=lambda ts, img: stream.depths[int(ts)])
    return tracker, video


def _run(stream, traced):
    """Track WARM frames, one more (profiled when ``traced``: the first
    session), one more, and the last (the second session) -> (video,
    chrome trace events of the first session or None, registry snapshots
    after each session)."""
    tracker, video = _tracker(stream)
    events, snaps = None, []
    for i in range(len(stream)):
        if traced and i in (WARM, WARM + 2):
            prof = _profiler()
            prof.start()
        tracker.step(i, stream)
        if traced and i in (WARM, WARM + 2):
            prof.stop()
            snaps.append(phase_timer.snapshot())
            if events is None:
                events = _events(prof)
    return video, events, snaps


def _events(prof):
    """The user-annotation ranges of ``prof``'s chrome trace."""
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            data = json.load(g)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


@pytest.fixture(scope="module")
def stream():
    return SyntheticStream(n_frames=WARM + 3, H=H, W=W, seed=3,
                           motion_scale=0.02, trajectory="circuit")


@pytest.fixture(scope="module")
def runs(stream):
    """A traced and an untraced run of the same frames, and the BA edges
    that each round of the first session handed to its solve."""
    edges = []
    solve, solve_ss = ba_mod.ba, ba_mod.ba_scale_shift

    def ba(*args, **kw):
        if torch.autograd._profiler_enabled():
            edges.append(len(args[6]))
        return solve(*args, **kw)

    def ba_scale_shift(*args, **kw):
        if torch.autograd._profiler_enabled():
            edges.append(len(args[10]))
        return solve_ss(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(ba_mod, "ba", ba)
    mp.setattr(ba_mod, "ba_scale_shift", ba_scale_shift)
    try:
        traced = _run(stream, True)
    finally:
        mp.undo()
    plain = _run(stream, False)
    return traced, plain, edges


def test_off_records_nothing_and_opens_no_range(stream, monkeypatch):
    before = phase_timer.snapshot()
    opened = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name))
    with phase_timer.span("x"):
        phase_timer.count("y", 3)
    with phase_timer.sync("z", 2):
        pass
    tracker, _ = _tracker(stream)
    for i in range(WARM):
        tracker.step(i, stream)
    assert opened == []
    assert phase_timer.snapshot() == before


def _inside(outer, inner):
    return (outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_trace_nests_the_round_spans(runs):
    (_, events, _), _, _ = runs
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    rounds = (by.get("tracker.round.pose_depth", [])
              + by.get("tracker.round.depth_scale", []))
    assert by["tracker.round.depth_scale"]        # DSPO alternates
    chains = 0
    for fe in by["phase.frontend"]:
        for ur in by["tracker.update_rounds"]:
            if not _inside(fe, ur):
                continue
            for rd in rounds:
                if _inside(ur, rd) and any(_inside(rd, b)
                                           for b in by["tracker.ba"]):
                    chains += 1
    assert chains > 0
    for name in ("tracker.step", "phase.motion_filter", "tracker.gru",
                 "net.update", "tracker.edges", "tracker.loop_closure",
                 "tracker.mono_prior", "sync.kf_dist", "sync.graph_index"):
        assert name in by, name


def test_counters_count_what_ran(runs):
    (_, _, (snap, _)), _, edges = runs
    counts, spans = snap["counts"], snap["spans"]
    assert spans["tracker.step"]["calls"] == 1
    assert counts["tracker.rounds"] == 12 == len(edges[:12])
    assert counts["tracker.ba_edges"] == sum(edges[:12])
    assert counts["sync.kf_dist"] == spans["sync.kf_dist"]["calls"] > 0
    assert counts["sync.image_norm"] == 2 * spans["sync.image_norm"]["calls"]
    assert all(s["host_s"] >= 0 for s in spans.values())


def test_profiler_changes_no_number(runs):
    (traced, _, _), (plain, _, _), _ = runs
    n = plain.counter
    assert traced.counter == n == WARM + 3
    assert torch.equal(traced.poses[:n], plain.poses[:n])
    assert torch.equal(traced.disps[:n], plain.disps[:n])
    np.testing.assert_array_equal(traced.disps_up[:n].numpy(),
                                  plain.disps_up[:n].numpy())


def test_second_session_holds_its_own_counts(runs):
    """The second session (one frame, after an untraced frame) reads its
    own sums: they clear at the first call that finds a new session on."""
    (_, _, (first, snap)), _, edges = runs
    assert len(edges) == 24
    assert snap["counts"]["tracker.rounds"] == 12
    assert snap["counts"]["tracker.ba_edges"] == sum(edges[12:])
    assert snap["spans"]["tracker.step"]["calls"] == 1
    assert first["counts"] != snap["counts"]
