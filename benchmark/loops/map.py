"""Mapping traffic: the synchronous ``Mapper.on_keyframe`` over an oracle
video.

Set-up: the circuit is rendered on the device from the seed; the port's
``utils/synthetic.oracle_video`` holds its true poses and depths; the
mono-prior cache holds each frame's true depth (the prior a run reads from
the DPT's ``.npy`` cache); a ``Mapper`` is built from the cell's
configuration with the benchmark's seeded decoder weights. The first
``anchor_keyframes`` keyframes, and more until the cloud holds
``anchor_min_points``, are mapped with their iterations cut to
``setup_iters`` (they anchor the cloud). The kNN scans the cloud in tiles
of 8192 points, so a count that depended on the seed across a tile's edge
would change a step's work by a quarter: the floor keeps every seed's
count within one number of tiles. The next keyframe is mapped at the
configuration's iterations. Its first ``capture_steps`` train steps (the
geometry stage) are set-up and are captured for the reference. Its steps
from there to ``window_geometry_steps`` before the end of its geometry
stage are skipped (the program's loop runs, the train step does not), so
that the window holds geometry and colour steps in a keyframe's share. The
window opens there and takes every later step, the colour stage's first
``capture_steps`` captured too, through the following keyframes, until
``seconds`` have passed. The train-step wrapper then ends the window by
unwinding out of the keyframe call before the next step; only steps
completed inside the window count, and the window closes with a
synchronize of the mapper's stream.
"""

import gc
import os
import sys
import time
import types

import numpy as np
import torch

from .. import check, probes as probes_mod, scene, weights
from ..harness import Record
from ..yardstick import trace as trace_mod
from .track import _device_info, _profiler, _stop


class StopWindow(Exception):
    """Raised from inside the mapper's keyframe call when the window's time
    is up."""


class Clock:
    """The window's clock, driven by the train-step wrapper."""

    def __init__(self, ctx, sync):
        self.ctx, self.sync = ctx, sync
        self.phase = "setup"
        self.t0 = self.t_end = None
        self.start_step = 0
        self.probes = None
        self.prof = self.tok = None
        self.trace_path = os.path.join(ctx.out_dir, "trace.json")
        self.stretch_units = 0
        self.kf_iter = 0
        self.schedule = None
        self.stage_steps = {}

    def begin_keyframe(self, iters, geo_iter, points):
        """A keyframe's optimisation starts (its points added); the first
        one once armed sets where the window opens."""
        self.kf_iter = 0
        if self.phase == "capture" and self.schedule is None:
            tr = self.ctx.traffic
            opens = max(tr["capture_steps"],
                        geo_iter + 1 - tr["window_geometry_steps"])
            self.schedule = {"iters": iters, "geo_iter": geo_iter,
                             "opens_at": opens, "points": points}

    def before_step(self):
        """True where the step is set-up to be skipped."""
        it = self.kf_iter
        self.kf_iter += 1
        if self.phase == "skip":
            if it < self.schedule["opens_at"]:
                return True
            self.sync()
            self.t0 = time.perf_counter()
            self.phase = "window"
            self.start_step = self.probes.steps
        if self.phase == "window" and (time.perf_counter() - self.t0
                                       >= self.ctx.seconds):
            self.end()
            raise StopWindow
        return False

    def end(self):
        self.sync()
        self.t_end = time.perf_counter()
        self.phase = "done"
        if self.tok is not None:
            _stop(self.probes, self.prof, self.tok, self.trace_path)
            self.tok = None

    def after_step(self, n, stage):
        p = self.probes
        if self.phase == "capture" and p.done("geometry"):
            self.phase = "skip"
            return
        if self.phase != "window":
            return
        self.stage_steps[stage] = self.stage_steps.get(stage, 0) + 1
        done = n - self.start_step
        s_lo, s_hi = self.ctx.traffic["trace_iters"]
        if p.stretch:
            self.stretch_units += 1
        if self.ctx.trace and done == s_lo and self.prof is None:
            self.prof = _profiler(self.ctx.device)
            self.prof.start()
            self.tok = p.open(trace_mod.STRETCH)
            p.stretch = True
        elif p.stretch and done == s_hi:
            _stop(p, self.prof, self.tok, self.trace_path)
            self.tok = None


def schedule(mapper, num_joint_iters, frame_pts_add, init, color_refine):
    """(iterations, last geometry iteration) of an ``optimize_map`` call:
    the program's own rule (``Mapper.optimize_map``), copied."""
    n = num_joint_iters
    if not init and not color_refine:
        n = int(np.clip(int(n * frame_pts_add / 300),
                        int(mapper.min_iter_ratio * n), 2 * n))
    geo_iter = mapper.geo_iter_first if init else int(
        n * mapper.geo_iter_ratio)
    return n, geo_iter


def run(ctx):
    from glorie_slam_tpu_torch.mapping.mapper import Mapper
    from glorie_slam_tpu_torch.utils.printer import Printer
    from glorie_slam_tpu_torch.utils.synthetic import oracle_video

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    sync = probes_mod.device_sync(dev)
    n = tr["frames"]
    stream = scene.make_stream(cfg, tr, ctx.seed, dev, length=n)
    prior_dir = f"{cfg['data']['output']}/{cfg['scene']}_priors/depths"
    os.makedirs(prior_dir, exist_ok=True)
    for k in range(n):
        np.save(f"{prior_dir}/{k:05d}.npy", stream.depths[k])
    video = oracle_video(stream, cfg, n, dev)
    H, W, (fx, fy, cx, cy) = scene.output_camera(cfg["cam"])
    out = f"{cfg['data']['output']}/{cfg['setting']}/{cfg['scene']}"
    os.makedirs(out, exist_ok=True)
    host = types.SimpleNamespace(video=video, printer=Printer(n, True),
                                 output=out, H=H, W=W, fx=fx, fy=fy, cx=cx,
                                 cy=cy, stream=stream)
    mapper = Mapper(host, cfg)
    mapper.decoders.load_state_dict(weights.decoders(ctx.seed, cfg, dev))
    clock = Clock(ctx, sync)
    p = probes_mod.MapProbes(dev, ctx.trace, clock,
                             capture=tr["capture_steps"])
    clock.probes = p
    inner_opt = mapper.optimize_map

    def optimize_map(num_joint_iters, cur_idx, cur_depth, cur_gt_color,
                     frame_pts_add, cur_c2w, init, color_refine=False):
        clock.begin_keyframe(*schedule(mapper, num_joint_iters,
                                       frame_pts_add, init, color_refine),
                             int(mapper.npc.pts_num()))
        return inner_opt(num_joint_iters, cur_idx, cur_depth, cur_gt_color,
                         frame_pts_add, cur_c2w, init, color_refine)
    p.replace(mapper, "optimize_map", optimize_map)

    # the mapper reads iters_first when it is built and iters at each
    # keyframe: both are cut for the anchoring keyframes alone
    m = cfg["mapping"]
    iters, first = m["iters"], mapper.iters_first
    m["iters"] = mapper.iters_first = tr["setup_iters"]
    counts = []
    k = 0
    while (k < tr["anchor_keyframes"]
           or (counts[-1] if counts else 0) < tr["anchor_min_points"]):
        if k >= n - 1:
            raise RuntimeError(f"the cloud holds {counts[-1]} points after "
                               f"{k} keyframes, short of anchor_min_points "
                               f"{tr['anchor_min_points']}")
        mapper.on_keyframe(_info(k))
        counts.append(int(mapper.npc.pts_num()))
        k += 1
    m["iters"], mapper.iters_first = iters, first
    anchored, n_anchor = counts[-1], k
    p.armed = True
    clock.phase = "capture"
    try:
        while k < n:
            mapper.on_keyframe(_info(k))
            k += 1
        clock.end()
    except StopWindow:
        pass
    if clock.t0 is None:
        raise RuntimeError("the window never started: the keyframes ran "
                           "out during the captured steps")
    units = p.steps - clock.start_step
    info = _device_info(dev)
    p.uninstall()
    rec = Record("map", cfg, units=units, window_s=clock.t_end - clock.t0,
                 setup_s=clock.t0 - ctx.t0, host_s=dict(p.host_s),
                 host_n=dict(p.host_n), stretch_units=clock.stretch_units,
                 calls=dict(p.calls), anchored_points=anchored,
                 keyframes=k - n_anchor + 1,
                 stage_steps=dict(clock.stage_steps))
    sch = clock.schedule
    print(f"[{ctx.name}] anchored keyframes {n_anchor}, points {counts}; "
          f"first window keyframe: {sch['points']} points, "
          f"{sch['iters']} iterations, geometry to {sch['geo_iter']}, "
          f"window opens at {sch['opens_at']} ({p.skipped} skipped); "
          f"window keyframes {rec.keyframes}, steps {units} "
          f"({', '.join(f'{s} {c}' for s, c in clock.stage_steps.items())})",
          file=sys.stderr)
    breakdown = None
    if clock.prof is not None:
        rec.trace = trace_mod.reduce(trace_mod.load(clock.trace_path))
        os.remove(clock.trace_path)
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s
        breakdown = {"device_ops": rec.trace.device_ops,
                     "idle_gaps": rec.trace.idle_gaps}
    captured = p.captured
    del mapper, video, host, p, stream
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.mapping_numbers(captured, cfg)
    if ctx.with_control:
        rec.control = check.mapping_numbers(captured, cfg, control=True)
    print(f"[{ctx.name}] reference check {time.perf_counter() - t_check!r} "
          f"s", file=sys.stderr)
    return rec, numbers, info, breakdown


def _info(k):
    return {"is_keyframe": True, "video_idx": k, "timestamp": k,
            "end": False}
