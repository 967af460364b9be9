#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glorie_slam_tpu_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. build: the CUDA kernels (one nvcc per source, started together, then
   linked), then the host proximity library, into
   glorie_slam_tpu_torch/_build;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the tracking slice's shapes, with timings (CUDA events) and bounds;
3. reference: the card's path against the CPU path (plain versions, the
   path the tests hold against the JAX package) on 48x64 input: two DSPO
   rounds from one identical state, held tightly, and whole 10-frame
   tracker runs, which must take the same path;
4. pipeline: the tracking slice (bench.py's loop and config: motion filter
   with lookahead, frontend DSPO rounds, loop closure, online BA every 12
   keyframes) on a 320x640 synthetic circuit stream with a random-weight
   bf16 net at full width, ending with save_video, whose read of the
   full-resolution validity mask runs the depth filter. Kernel launch
   counts are zeroed just before and read just after.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that line. Needs no network; uses one card.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
# bench.py runs 60 frames; 40 keep the whole script well inside its time
# limit while window=25 loop closure and ba_freq=12 online BA both fire
PIPELINE_FRAMES = 40


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_all():
    from glorie_slam_tpu_torch import build
    build.kernels_library()
    build.proximity_library()


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

def library_lookup(f1, f2_levels, iis, jjs, coords):
    """Kernel A's function from library calls: per-level correlation
    volumes by torch.bmm of the gathered features (bf16, fp32 accumulate),
    then the 8x8 window cells by torch.gather and the bilinear weights."""
    import torch
    E, npix, _ = coords.shape
    c = torch.nan_to_num(coords)
    a = f1[iis.long()]
    r = torch.arange(8, device=f1.device)
    outs = []
    for lvl, f2 in enumerate(f2_levels):
        _, hl, wl, C = f2.shape
        b = f2[jjs.long()].reshape(E, hl * wl, C)
        vol = torch.bmm(a, b.transpose(1, 2))
        pos = c / (2.0 ** lvl)
        x0, y0 = torch.floor(pos[..., 0]), torch.floor(pos[..., 1])
        fx, fy = pos[..., 0] - x0, pos[..., 1] - y0
        gx = x0.long()[..., None] - 3 + r                     # (E, p, 8)
        gy = y0.long()[..., None] - 3 + r
        ok = (((gy >= 0) & (gy < hl))[..., :, None]
              & ((gx >= 0) & (gx < wl))[..., None, :])
        idx = (gy.clamp(0, hl - 1)[..., :, None] * wl
               + gx.clamp(0, wl - 1)[..., None, :])
        cells = vol.gather(2, idx.reshape(E, npix, 64)).float()
        cells = (cells.reshape(E, npix, 8, 8) * ok) / 16.0
        fx, fy = fx[..., None, None], fy[..., None, None]
        win = ((1 - fy) * ((1 - fx) * cells[..., :7, :7]
                           + fx * cells[..., :7, 1:])
               + fy * ((1 - fx) * cells[..., 1:, :7]
                       + fx * cells[..., 1:, 1:]))          # [b][a]
        outs.append(win.transpose(-1, -2).reshape(E, npix, 49))
    return torch.cat(outs, -1).to(torch.bfloat16)


def check_kernel_a(dev, N=16, E=96, h0=40, w0=80):
    import torch
    from glorie_slam_tpu_torch.ops import corr, cuda_corr

    g = torch.Generator(device="cpu").manual_seed(0)
    npix = h0 * w0
    fm = torch.randn((N, h0, w0, 128), generator=g).to(dev, torch.bfloat16)
    pyr = corr.prep_feat_pyramid(fm)
    f2 = (pyr[0].reshape(N, h0, w0, 128),) + tuple(pyr[1:])
    iis = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    jjs = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    yy, xx = torch.meshgrid(torch.arange(h0), torch.arange(w0),
                            indexing="ij")
    base = torch.stack([xx, yy], -1).reshape(1, npix, 2).float()
    coords = base + 3.0 * torch.randn((E, npix, 2), generator=g)
    coords[:, ::97] = float("nan")                       # NaN centres
    coords[:, 5::53] += 60.0                             # off the plane
    coords[:, 7::61] -= 45.0
    coords = coords.to(dev).contiguous()

    out = cuda_corr.lookup_pyramid(pyr[0], f2, iis, jjs, coords)
    torch.cuda.synchronize()
    ref = cuda_corr.lookup_pyramid_plain(pyr[0], f2, iis, jjs, coords)
    d = (out.float() - ref.float()).abs()
    tol = 1e-2 + 8e-3 * ref.float().abs()                # ~2 bf16 ulps
    if not bool((d <= tol).all()):
        raise AssertionError(
            f"lookup_pyramid disagrees with its plain version: "
            f"max |d| {d.max().item():.4g}, {(d > tol).sum().item()} over")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("lookup_pyramid: non-finite output")

    ms = cuda_ms(lambda: cuda_corr.lookup_pyramid(pyr[0], f2, iis, jjs,
                                                  coords), 20)
    plain_ms = cuda_ms(lambda: cuda_corr.lookup_pyramid_plain(
        pyr[0], f2, iis, jjs, coords), 3, warmup=1)
    lib_ms = cuda_ms(lambda: library_lookup(pyr[0], f2, iis, jjs, coords),
                     3, warmup=1)

    # bound: bytes of each input read once + the output written once;
    # operations: the 128-term dot products of in-plane window cells only
    nbytes = (sum(t.numel() * t.element_size() for t in pyr)
              + coords.numel() * 4 + 2 * E * 4 + out.numel() * 2)
    cells = 0
    c = torch.nan_to_num(coords)
    r = torch.arange(8, device=dev)
    for lvl, lv in enumerate(f2):
        hl, wl = lv.shape[1], lv.shape[2]
        pos = c / (2.0 ** lvl)
        gx = torch.floor(pos[..., 0]).long()[..., None] - 3 + r
        gy = torch.floor(pos[..., 1]).long()[..., None] - 3 + r
        cells += int(((gx >= 0) & (gx < wl)).sum(-1).mul(
            ((gy >= 0) & (gy < hl)).sum(-1)).sum())
    flops = 2 * 128 * cells
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(
        name=cuda_corr.LOOKUP_PYRAMID.name, route="cuda",
        source=cuda_corr.LOOKUP_PYRAMID.source,
        replaces=cuda_corr.LOOKUP_PYRAMID.replaces,
        max_abs_err=float(d.max()), ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms,
        shapes=f"E={E} N={N} {h0}x{w0} C=128 -> ({E},{npix},196) bf16")


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------

def check_kernel_b(dev, N=16, M=8, ht=320, wd=640):
    import torch
    from glorie_slam_tpu_torch.geom import lie
    from glorie_slam_tpu_torch.ops import cuda_corr, depth_filter

    g = torch.Generator(device="cpu").manual_seed(1)
    xi = torch.cumsum(0.02 * torch.randn((N, 6), generator=g), 0)
    poses = lie.exp(xi).to(dev)
    yy, xx = torch.meshgrid(torch.arange(ht), torch.arange(wd),
                            indexing="ij")
    surf = 0.4 + 0.1 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0)
    disps = (surf[None] * (1 + 0.02 * torch.randn((N, ht, wd), generator=g))
             ).to(dev)
    intr = torch.tensor([0.8 * wd, 0.8 * wd, wd / 2 - 0.5, ht / 2 - 0.5],
                        device=dev)
    inds = torch.arange(3, 3 + M, device=dev)
    thr = 0.01 / disps[inds].mean(dim=(1, 2))
    jx, _, cu = depth_filter.pack_agreement_inputs(poses, disps, intr, inds,
                                                   thr)
    out = cuda_corr.depth_agree(disps, jx, cu)
    torch.cuda.synchronize()
    ref = cuda_corr.depth_agree_plain(disps, jx, cu)
    diff = out != ref
    # exact except where |izd - 1/c| sits within 1e-6 * thr of thr
    rec = cu.reshape(M, 6, 4, -1)
    u, v, izd, th = rec.unbind(2)
    u0 = torch.floor(u).clamp(0, wd - 2).long()
    v0 = torch.floor(v).clamp(0, ht - 2).long()
    flat = disps.reshape(-1)
    base = jx.long()[:, :, None] * (ht * wd) + v0 * wd + u0
    near = torch.zeros_like(diff)
    for off in (0, 1, wd, wd + 1):
        gap = ((izd - 1.0 / flat[base + off]).abs() - th).abs()
        near |= gap <= 1e-6 * th
    n_near = int(near.sum())
    if bool((diff & ~near).any()):
        raise AssertionError(
            f"depth_agree disagrees with its plain version at "
            f"{int((diff & ~near).sum())} pixels away from the threshold")
    if not bool(((out == 0) | (out == 1)).all()):
        raise AssertionError("depth_agree: output not 0/1")
    ms = cuda_ms(lambda: cuda_corr.depth_agree(disps, jx, cu), 50)
    plain_ms = cuda_ms(lambda: cuda_corr.depth_agree_plain(disps, jx, cu),
                       5)
    used = torch.unique(jx.long())
    nbytes = (used.numel() * ht * wd * 4 + cu.numel() * 4 + jx.numel() * 4
              + out.numel() * 4)
    # per (source, neighbour, pixel): <= 4 divisions + 4 |.| compares
    flops = 8 * out.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / 67e12
    return dict(
        name=cuda_corr.DEPTH_AGREE.name, route="cuda",
        source=cuda_corr.DEPTH_AGREE.source,
        replaces=cuda_corr.DEPTH_AGREE.replaces,
        max_abs_err=float((out - ref).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, near_threshold=n_near,
        mismatches=int(diff.sum()),
        shapes=f"M={M} x 6 neighbours, {ht}x{wd} -> ({M},6,{ht * wd}) f32")


# ---------------------------------------------------------------------------
# tracker runs
# ---------------------------------------------------------------------------

def run_tracker(device, H, W, n_frames, dtype, cfg_fn, on_frame=None):
    import torch
    from glorie_slam_tpu_torch.core.depth_video import DepthVideo
    from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
    from glorie_slam_tpu_torch.tracking.tracker import Tracker
    from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream

    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")
    cfg = cfg_fn()
    video = DepthVideo(cfg, device=device)
    net = TrackerNet(seed=1, dtype=dtype, device=device)
    tracker = Tracker(net, video, cfg,
                      mono_predictor=lambda ts, img: stream.depths[int(ts)])
    times = []
    for i in range(len(stream)):
        t0 = time.perf_counter()
        tracker.step(i, stream)
        if video.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if on_frame is not None:
            on_frame(i, times[-1], video)
    return tracker, video, times


def _moved(obj, device, **replace):
    """Shallow copy of a DepthVideo or FactorGraph with every tensor moved
    to ``device`` (numpy state copied)."""
    import copy
    import numpy as np
    import torch
    out = copy.copy(obj)
    for k, v in vars(obj).items():
        if isinstance(v, torch.Tensor):
            setattr(out, k, v.to(device))
        elif isinstance(v, np.ndarray):
            setattr(out, k, v.copy())
        elif isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            setattr(out, k, [t.to(device) for t in v])
    out.device = torch.device(device)
    for k, v in replace.items():
        setattr(out, k, v)
    return out


def reference_check():
    """The card's path (CUDA kernels, cuDNN, cuBLAS) against the CPU path
    (plain versions), which the tests hold against the JAX package.

    1. One step from identical state: a 48x64 tracker runs 6 frames on the
       CPU; its video and frontend graph are copied to the card; 2 DSPO
       rounds (a pose_depth and a depth_scale round, so both kernels run
       at 1/8 resolution) then run on each side from the same state. Over
       every frame, poses agree to 1e-5, disparities to 1e-4 relative and
       the 1/8-res validity masks exactly.
    2. Whole runs: the 10-frame tracker on each side must admit every
       frame, close loops and run online BA at the same keyframes, and stay
       finite. Random-weight recurrent rounds amplify float32 rounding (and
       the card's atomics make its sums vary run to run), so the whole
       runs' numbers and edge sets are reported, not held: the step check
       above is the tight one.
    """
    import numpy as np
    import torch
    from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
    from glorie_slam_tpu_torch.tracking import fused
    from glorie_slam_tpu_torch.utils.synthetic import bench_cfg

    def cfg():
        c = bench_cfg(H=48, W=64, buffer=16)
        c["tracking"]["warmup"] = 4
        c["tracking"]["frontend"].update(window=5, max_factors=48)
        c["tracking"]["backend"].update(ba_freq=3, loop_window=5,
                                        loop_nms=2)
        return c

    tc, vc, _ = run_tracker("cpu", 48, 64, 6, torch.float32, cfg)
    g_cpu = tc.frontend.graph
    vg = _moved(vc, "cuda")
    net_g = TrackerNet(seed=1, dtype=torch.float32, device="cuda")
    g_gpu = _moved(g_cpu, "cuda", video=vg, tn=net_g)
    fused.graph_update_rounds(g_cpu, 2, use_inactive=True)
    fused.graph_update_rounds(g_gpu, 2, use_inactive=True)
    n = vc.counter
    step = dict(
        pose=float((vg.poses[:n].cpu() - vc.poses[:n]).abs().max()),
        disp_rel=float(((vg.disps[:n].cpu() - vc.disps[:n]).abs()
                        / vc.disps[:n].abs().clamp(min=1e-3)).max()),
        vm_agree=float((vg.valid_depth_mask_small[:n].cpu()
                        == vc.valid_depth_mask_small[:n]).float().mean()))
    # measured on the H100: pose 6.0e-8, disp_rel 2.0e-7 and 3.0e-7, masks
    # identical; the limits leave over 100x room above those readings
    if (step["pose"] > 1e-5 or step["disp_rel"] > 1e-4
            or step["vm_agree"] < 1.0):
        raise AssertionError(f"card vs CPU DSPO step: {step}")

    runs = [run_tracker(d, 48, 64, 10, torch.float32, cfg)
            for d in ("cuda", "cpu")]
    (tg, vg, _), (tc, vc, _) = runs
    n = vc.counter
    if (vg.counter != n or n != 10
            or tg.frontend.last_loop_t != tc.frontend.last_loop_t
            or tg.prev_ba_idx != tc.prev_ba_idx):
        raise AssertionError("card and CPU runs took different paths")
    pg, pc = vg.poses[:n].cpu().numpy(), vc.poses[:n].numpy()
    dg, dc = vg.disps[:n].cpu().numpy(), vc.disps[:n].numpy()
    if not (np.isfinite(pg).all() and np.isfinite(dg).all()):
        raise AssertionError("non-finite poses or disparities on the card")
    rel = np.abs(dg - dc) / np.maximum(np.abs(dc), 1e-3)
    run = dict(frames=n, same_edges=bool(np.array_equal(
        tg.frontend.graph.ii, tc.frontend.graph.ii)),
        max_pose_diff=float(np.abs(pg - pc).max()),
        median_rel_disp_diff=float(np.median(rel)))
    return dict(step=step, run=run)


def pipeline(n_frames, device="cuda", H=320, W=640):
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.ops import cuda_corr
    from glorie_slam_tpu_torch.utils.synthetic import bench_cfg

    for k in cuda_corr.KERNELS:
        k.launches = 0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def on_frame(i, dt, video):
        print(f"[pipeline] frame {i}: {dt:.3f} s, keyframes "
              f"{video.counter}", flush=True)

    tracker, video, times = run_tracker(
        device, H, W, n_frames, torch.bfloat16,
        lambda: bench_cfg(H=H, W=W, buffer=400), on_frame=on_frame)
    t_save = time.perf_counter()
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        path = os.path.join(tmp, "video.npz")
        video.save_video(path)
        if video.device.type == "cuda":
            torch.cuda.synchronize()
        save_s = time.perf_counter() - t_save
        saved = dict(np.load(path))
    launches = {k.name: k.launches for k in cuda_corr.KERNELS}
    peak = (torch.cuda.max_memory_allocated()
            if video.device.type == "cuda" else None)

    n = video.counter
    if n != n_frames:
        raise AssertionError(f"{n} keyframes for {n_frames} frames")
    if saved["poses"].shape != (n, 4, 4) or \
            saved["valid_depth_masks"].shape != (n, H, W):
        raise AssertionError("saved video has the wrong shapes")
    for key in ("poses", "depths", "timestamps"):
        if not np.isfinite(saved[key]).all():
            raise AssertionError(f"saved {key} are not finite")
    if tracker.frontend.last_loop_t <= 0 or tracker.prev_ba_idx <= 0:
        raise AssertionError("loop closure or online BA did not run")
    for name, count in launches.items():
        if count <= 0 and video.device.type == "cuda":
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    steady = times[-20:]
    return dict(
        frames=n, keyframes=n, launches=launches,
        keyframes_per_s=len(steady) / sum(steady),
        steady_frame_ms=[round(1e3 * t, 2) for t in steady],
        first_frame_s=times[0], save_video_s=save_s,
        loop_closure_at=tracker.frontend.last_loop_t,
        online_ba_at=tracker.prev_ba_idx,
        phases=tracker.timer.summary(), peak_memory_bytes=peak,
        valid_mask_fraction=float(saved["valid_depth_masks"].mean()))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from glorie_slam_tpu_torch.device import set_float32_precision
    from glorie_slam_tpu_torch.ops import cuda_corr

    set_float32_precision()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    build_all()
    phase("build", t0)

    t0 = time.perf_counter()
    results = [check_kernel_a(dev), check_kernel_b(dev)]
    for r in results:
        print("[kernel] " + json.dumps(r), flush=True)
    phase("kernels", t0)

    t0 = time.perf_counter()
    ref = reference_check()
    print("[reference] " + json.dumps(ref), flush=True)
    phase("reference", t0)

    t0 = time.perf_counter()
    pipe = pipeline(PIPELINE_FRAMES)
    print("[pipeline] " + json.dumps(pipe), flush=True)
    phase("pipeline", t0)

    kernels = []
    for r in results:
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": pipe["launches"][r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    assert {k.name for k in cuda_corr.KERNELS} == {k["name"] for k in kernels}
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
