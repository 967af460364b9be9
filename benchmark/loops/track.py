"""Tracking traffic: a closed loop of frames into ``Tracker.step``.

Set-up: the circuit is rendered on the device from the seed; a tracking-only
``SLAM`` is built from the cell's configuration and given the benchmark's
seeded weights (DROID net, DPT); frames go to ``Tracker.step`` until the
tracker has initialized and the frontend's graph holds ``max_factors``
edges. The window then hands frames to ``Tracker.step`` as fast as it
returns, with a synchronize after each, until ``seconds`` have passed; each
keyframe's time runs from the hand-over to that synchronize, and the window
ends with the last keyframe. The keyframe checked against the reference is
drawn from the seed; a traced run profiles a stretch of the window's
keyframes (``trace_keyframes``).
"""

import gc
import os
import time

import numpy as np
import torch

from .. import check, probes as probes_mod, scene, weights
from ..harness import Record
from ..reference import tracking as ref
from ..yardstick import trace as trace_mod


def run(ctx):
    from glorie_slam_tpu_torch.slam import SLAM

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    cfg["only_tracking"] = True
    sync = probes_mod.device_sync(dev)
    stream = scene.make_stream(cfg, tr, ctx.seed, dev,
                               length=cfg["tracking"]["buffer"])
    slam = SLAM(cfg, stream, device=dev)
    w_droid = weights.droid(ctx.seed, dev)
    slam.tracker_net.model.load_state_dict(w_droid)
    est = slam.mono_estimator
    w_dpt = weights.dpt(ctx.seed, dev, size=est.infer_size, **ctx.dpt_kw)
    est.model.load_state_dict(w_dpt)
    p = probes_mod.TrackProbes(slam, dev, ctx.trace)
    tracker, video = slam.tracker, slam.video
    fe = tracker.frontend
    max_factors = cfg["tracking"]["frontend"]["max_factors"]
    lo, hi = tr["check_keyframe"]
    rng = np.random.default_rng(ctx.seed % (1 << 63))
    check_at = int(rng.integers(lo, hi))
    s_lo, s_hi = tr["trace_keyframes"]

    i = 0
    while not (fe.is_initialized and len(fe.graph.ii) >= max_factors):
        if i >= tr["warmup_max_frames"]:
            raise RuntimeError(
                f"the frontend holds {len(fe.graph.ii)} edges after {i} "
                f"frames, short of max_factors {max_factors}")
        tracker.step(i, stream)
        i += 1
    sync()
    p.host_s.clear()
    p.host_n.clear()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t0

    times, prof, rng_tok, stretch_kf = [], None, None, 0
    trace_path = os.path.join(ctx.out_dir, "trace.json")
    te = t0
    while True:
        k = len(times)
        if ctx.trace and k == s_lo and prof is None:
            prof = _profiler(dev)
            prof.start()
            rng_tok = p.open(trace_mod.STRETCH)
            p.stretch = True
        p.armed = k == check_at
        c0 = video.counter
        ts = time.perf_counter()
        tracker.step(i, stream)
        sync()
        te = time.perf_counter()
        p.armed = False
        i += 1
        if video.counter != c0:
            times.append(te - ts)
            stretch_kf += p.stretch
        if p.stretch and len(times) >= s_hi:
            _stop(p, prof, rng_tok, trace_path)
            rng_tok = None
        if te - t0 >= ctx.seconds or i >= len(stream):
            break
        if video.counter >= video.buffer - 1:
            raise RuntimeError(f"the video buffer ({video.buffer}) is full "
                               "inside the window")
    window_s = te - t0
    if rng_tok is not None:
        _stop(p, prof, rng_tok, trace_path)
    if "update" not in p.captured and i < len(stream):
        # the window ended before the drawn keyframe: check the next one
        p.armed = True
        tracker.step(i, stream)
        sync()
        p.armed = False

    info = _device_info(dev)
    p.uninstall()
    rec = Record("track", cfg, units=len(times), samples=times,
                 window_s=window_s, setup_s=setup_s, host_s=dict(p.host_s),
                 host_n=dict(p.host_n), stretch_units=stretch_kf,
                 calls=dict(p.calls), dpt_size=est.infer_size)
    breakdown = None
    if prof is not None:
        rec.trace = trace_mod.reduce(trace_mod.load(trace_path))
        os.remove(trace_path)
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s
        breakdown = {"device_ops": rec.trace.device_ops,
                     "idle_gaps": rec.trace.idle_gaps}
    captured = p.captured
    del slam, tracker, video, fe, est, p, stream
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    nets = {"droid": ref.droid_net(w_droid, dev),
            "dpt": ref.dpt_model(w_dpt, dev, size=rec.dpt_size,
                                 **ctx.dpt_kw)}
    numbers = check.tracking_numbers(captured, nets)
    if ctx.with_control:
        rec.control = check.tracking_numbers(captured, nets, control=True)
    return rec, numbers, info, breakdown


def _profiler(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False)


def _stop(p, prof, tok, path):
    p.sync()
    p.close(tok)
    p.stretch = False
    prof.stop()
    prof.export_chrome_trace(path)


def _device_info(dev):
    if torch.device(dev).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
