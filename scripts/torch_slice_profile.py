#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's tracking slice, on one card.

Runs the slice of ``chip_smoke.py`` (bench.py's config, a 320x640 circuit
stream, random-weight bf16 net) and profiles the last ``--profile`` frames
with ``torch.profiler``: device time by kernel name, the device's busy and
idle share of the profiled wall time, and per-phase wall time with a
synchronize at each phase end. Prints one JSON line per table.

    python3 scripts/torch_slice_profile.py --frames 40 --profile 8
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--profile", type=int, default=8,
                    help="profile the last N frames")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 2
    from glorie_slam_tpu_torch.core.depth_video import DepthVideo
    from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
    from glorie_slam_tpu_torch.ops import cuda_corr
    from glorie_slam_tpu_torch.tracking.tracker import Tracker
    from glorie_slam_tpu_torch.utils.phase_timer import PhaseTimer
    from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream, \
        bench_cfg

    H, W = 320, 640
    stream = SyntheticStream(n_frames=args.frames, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")
    cfg = bench_cfg(H=H, W=W, buffer=400)
    video = DepthVideo(cfg)
    net = TrackerNet(seed=1)
    timer = PhaseTimer(sync=True)
    tracker = Tracker(net, video, cfg, timer=timer,
                      mono_predictor=lambda ts, img: stream.depths[int(ts)])
    first = args.frames - args.profile
    for i in range(first):
        tracker.step(i, stream)
    torch.cuda.synchronize()
    for k in cuda_corr.KERNELS:
        k.launches = 0
    timer.total.clear()
    timer.count.clear()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, args.frames):
            tracker.step(i, stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    # device-side events only (kernels, copies, memsets): summing the CPU
    # ops' device totals as well would count each kernel twice
    rows = sorted(((e.key, e.device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0), key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    print(json.dumps({
        "frames_profiled": args.profile, "wall_s": wall,
        "wall_ms_per_frame": 1e3 * wall / args.profile,
        "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
        "device_idle_share": 1 - busy_s / wall,
        "launches": {k.name: k.launches for k in cuda_corr.KERNELS},
        "device": torch.cuda.get_device_name(0)}))
    print(json.dumps({"phases_synced_s": {
        k: {"total_s": v["total_s"], "calls": v["calls"]}
        for k, v in timer.summary().items()}}))
    print(json.dumps({"top_device_kernels": [
        {"name": name[:90], "device_ms": us / 1e3, "calls": n,
         "share_of_busy": us / 1e6 / busy_s}
        for name, us, n in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
