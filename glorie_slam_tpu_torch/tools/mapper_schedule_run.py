"""The mapper at the real iteration schedule, on oracle tracking state.

    python -m glorie_slam_tpu_torch.tools.mapper_schedule_run [out_dir]
        [--light] [--device cpu]

Counterpart of ``scripts/mapper_schedule_run.py``. Ten 128x192 frames of a
synthetic stream at their true poses and depths (every pixel valid, every
frame marked for re-anchoring: ``utils/synthetic.oracle_video``) feed a
``Mapper`` at Replica's schedule: ``iters`` 300 (``iters_first`` 400),
``geo_iter_first`` 150, ``geo_iter_ratio`` 0.4, 1000 / 1500 pixels, window
5, 65,536 points. Keyframes 0, 2, 4, 6 and 8 are mapped, then
``final_refine`` (``iters`` x 2 over 5 outer passes, the point-cloud files
saved), then keyframe 4 is rendered and scored by PSNR. ``--light`` keeps
the iteration schedule and cuts the rays and points per step (300 / 500
pixels, 8192 points).

Writes ``{out_dir}/test/synth/logs/mapper_schedule.json`` (and nowhere
else: the JAX script also writes the repo's ``logs/mapper_sched_r03.json``,
this one does not) with the JAX report's keys (``schedule``, ``mapping_s``,
``final_refine_s``, ``approx_train_iters``, ``platform``,
``ms_per_train_iter``, ``final_psnr_kf4``, ``n_points``, ``loss_history``:
the geo and colour losses every 20 iterations) and
``peak_device_bytes``. ``convergence(report)`` holds a report to the
criteria ``tests/test_mapper_schedule.py`` holds the JAX artifact to.

Runs on the card unless ``--device cpu``; without a card it raises.
"""

import argparse
import json
import os
import time
import types

import numpy as np
import torch

from ..config import update_recursive
from ..device import resolve_device
from ..mapping.mapper import Mapper
from ..slam import update_cam
from ..utils import image_metrics
from ..utils.printer import Printer
from ..utils.synthetic import (SyntheticStream, base_cfg, oracle_video,
                               small_mapping_cfg)

SCHEDULE = dict(iters=300, iters_first=400, geo_iter_first=150,
                geo_iter_ratio=0.4, pixels=1000, pixels_adding=1500,
                mapping_window_size=5)
LIGHT = dict(pixels=300, pixels_adding=500)
REFINE_PASSES = 5             # final_refine's outer passes


def schedule_run(out="output/mapper_schedule", light=False, H=128, W=192,
                 n_frames=10, cuts=None, device=None):
    """Map every 2nd of ``n_frames`` oracle frames, refine, render; return
    the report (also written to ``{output}/logs/mapper_schedule.json``).
    ``cuts``: sections merged over the config last (the tests cut the
    schedule and the cloud with it)."""
    dev = resolve_device(device)
    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=9)
    cfg = base_cfg(H=H, W=W, buffer=16, out=out)
    cfg.update(small_mapping_cfg())
    cfg["only_tracking"] = False
    m = cfg["mapping"]
    m.update(SCHEDULE)
    cfg["pointcloud"]["capacity"] = 65536
    if light:
        m.update(LIGHT)
        cfg["pointcloud"]["capacity"] = 8192
    update_recursive(cfg, cuts or {})

    slam = types.SimpleNamespace(
        cfg=cfg, stream=stream, video=oracle_video(stream, cfg, n_frames, dev),
        printer=Printer(0, silence=True),
        output=f"{out}/{cfg['setting']}/{cfg['scene']}")
    os.makedirs(f"{slam.output}/logs", exist_ok=True)
    slam.H, slam.W, slam.fx, slam.fy, slam.cx, slam.cy = update_cam(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mapper = Mapper(slam, cfg)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = clock()
    for t in range(0, n_frames, 2):
        ts = clock()
        mapper.on_keyframe({"is_keyframe": True, "video_idx": t,
                            "timestamp": t, "end": False})
        print(f"[mapper-sched] kf {t}: {clock() - ts:.1f} s "
              f"pts={mapper.npc.pts_num()}", flush=True)
    t_map = clock() - t0

    t0 = clock()
    mapper.final_refine(save_final_pcl=True)
    t_refine = clock() - t0

    # keyframe 4 (the last mapped one when fewer frames are given)
    kf = min(4, 2 * ((n_frames - 1) // 2))
    rendered = mapper.render_keyframe_img(kf, kf, None)
    psnr = None
    if rendered is not None:
        psnr = image_metrics.psnr(np.asarray(stream.frames[kf]),
                                  np.asarray(rendered[1]))

    iters_total = (m["iters_first"] + (n_frames // 2 - 1) * m["iters"]
                   + 2 * m["iters"] * REFINE_PASSES)
    report = {
        "schedule": {k: m[k] for k in (
            "iters", "iters_first", "geo_iter_first", "geo_iter_ratio",
            "mapping_window_size", "pixels")},
        "mapping_s": t_map,
        "final_refine_s": t_refine,
        "approx_train_iters": iters_total,
        "platform": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
        "ms_per_train_iter": 1e3 * (t_map + t_refine) / iters_total,
        "final_psnr_kf4": psnr,
        "n_points": int(mapper.npc.pts_num()),
        "loss_history": mapper.loss_history,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }
    with open(f"{slam.output}/logs/mapper_schedule.json", "w") as f:
        json.dump(report, f, indent=2)
    return report


def _stage_curve(hist, idx, stage):
    seq = [h for h in hist if h["idx"] == idx and h["stage"] == stage
           and not h["refine"]]
    return (np.array([h["geo"] for h in seq]),
            np.array([h["color"] for h in seq]))


def convergence(report):
    """The criteria of ``tests/test_mapper_schedule.py``: the geometry
    stage's geo loss falls (mean of its last two samples under its first
    two) on at least 60% of the mapped keyframes, of which there are at
    least 3; the colour stage's colour loss falls on at least 60% of the
    keyframes it was sampled on (3 samples or more), at least 2 of them;
    ``approx_train_iters`` is at least 4000. Returns the counts and
    ``failures`` (empty when the report passes)."""
    hist = report["loss_history"]
    idxs = sorted({h["idx"] for h in hist if not h["refine"]})
    geo_fell = geo_n = col_fell = col_n = 0
    for idx in idxs:
        geo, _ = _stage_curve(hist, idx, "geometry")
        if len(geo) >= 3:
            geo_n += 1
            geo_fell += int(geo[-2:].mean() < geo[:2].mean())
        _, col = _stage_curve(hist, idx, "color")
        if len(col) >= 3:
            col_n += 1
            col_fell += int(col[-2:].mean() < col[:2].mean())
    failures = []
    if len(idxs) < 3:
        failures.append(f"{len(idxs)} mapped keyframes, fewer than 3")
    if geo_fell < max(1, int(0.6 * len(idxs))):
        failures.append(f"geo loss fell on {geo_fell} of {len(idxs)} "
                        "keyframes")
    if col_n < 2:
        failures.append(f"colour stage sampled on {col_n} keyframes, "
                        "fewer than 2")
    elif col_fell < max(1, int(0.6 * col_n)):
        failures.append(f"colour loss fell on {col_fell} of {col_n} "
                        "keyframes")
    if report["approx_train_iters"] < 4000:
        failures.append(f"{report['approx_train_iters']} train iterations, "
                        "fewer than 4000")
    return {"keyframes": len(idxs), "geo_sampled": geo_n,
            "geo_fell": geo_fell, "color_sampled": col_n,
            "color_fell": col_fell,
            "approx_train_iters": report["approx_train_iters"],
            "failures": failures}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="the glorie_slam_tpu_torch mapper at the real iteration "
                    "schedule on oracle tracking state")
    ap.add_argument("out_dir", nargs="?", default="output/mapper_schedule")
    ap.add_argument("--light", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu on request)")
    args = ap.parse_args(argv)
    report = schedule_run(args.out_dir, light=args.light, device=args.device)
    print("[mapper-sched]", json.dumps(
        {k: v for k, v in report.items() if k != "loss_history"}),
        flush=True)
    print("[mapper-sched] convergence", json.dumps(convergence(report)),
          flush=True)
    return report


if __name__ == "__main__":
    main()
