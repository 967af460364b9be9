#!/usr/bin/env python3
"""Where the time goes in one forward of the omnidata DPT, on one card.

Builds ``DPTDepthModel`` at the checkpoint's widths (random weights, seed 0)
at 512x512, as ``MonoDepthEstimator`` runs it (float32, TF32 off), and
profiles ``--iters`` forwards with ``torch.profiler``: device time by
kernel name, grouped into convolutions, matrix products and the rest, and
the device's busy share of the profiled wall time. Then, as levers not
taken by the port, the median forward time (CUDA events) with TF32 allowed
and under bf16 autocast, each with its rel-L2 from the float32 output.
Prints one JSON line per table.

    python3 scripts/dpt_profile.py --iters 5
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def group(name):
    n = name.lower()
    if "conv" in n or "implicit" in n or "winograd" in n or "fft" in n:
        return "convolution"
    if "gemm" in n or "sgemm" in n or "matmul" in n or "cutlass" in n:
        return "matrix product"
    if "norm" in n:
        return "normalization"
    if "softmax" in n:
        return "softmax"
    return "elementwise and other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("dpt_profile: no CUDA device", file=sys.stderr)
        return 2
    from glorie_slam_tpu_torch.device import set_float32_precision
    from glorie_slam_tpu_torch.mapping.dpt import DPTDepthModel

    set_float32_precision()
    dev = torch.device("cuda")
    model = DPTDepthModel(size=args.size).to(dev).eval()
    x = torch.rand((1, 3, args.size, args.size),
                   generator=torch.Generator().manual_seed(0)).to(dev) * 2 - 1

    def median_ms(fn, iters=10):
        for _ in range(2):
            fn()
        times = []
        for _ in range(iters):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    with torch.no_grad():
        ref = model.taps(x)["pre_relu"]
        f32_ms = median_ms(lambda: model(x))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(args.iters):
                model(x)
            t1.record()
            torch.cuda.synchronize()
        wall_ms = t0.elapsed_time(t1)
    kernels = {}
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.device_time_total > 0):
            kernels[ev.key] = (kernels.get(ev.key, 0.0)
                               + ev.device_time_total / 1e3)
    busy = sum(kernels.values())
    groups = {}
    for k, v in kernels.items():
        groups[group(k)] = groups.get(group(k), 0.0) + v
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top]
    print(json.dumps({"forward_ms_f32": f32_ms, "profiled_forwards":
                      args.iters, "profiled_wall_ms": wall_ms,
                      "device_busy_ms": busy,
                      "busy_share": busy / wall_ms,
                      "by_group_ms_per_forward": {
                          k: v / args.iters for k, v in groups.items()}}))
    print(json.dumps({"top_kernels_ms_per_forward": [
        [k[:90], v / args.iters] for k, v in top]}))

    levers = {}
    with torch.no_grad():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            out = model.taps(x)["pre_relu"]
            levers["tf32"] = {"forward_ms": median_ms(lambda: model(x)),
                              "rel_l2": float((out - ref).norm()
                                              / ref.norm())}
        finally:
            set_float32_precision()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = model.taps(x)["pre_relu"].float()
            levers["bf16_autocast"] = {
                "forward_ms": median_ms(lambda: model(x)),
                "rel_l2": float((out - ref).norm() / ref.norm())}
    print(json.dumps({"levers_not_taken": levers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
