#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glorie_slam_tpu_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. build: the tracking kernels (one nvcc per source, started together,
   then linked), the mapper's kNN kernel (its own library), then the host
   proximity library, into glorie_slam_tpu_torch/_build;
2. kernels: each of the six kernels against its plain PyTorch version on
   the card, at the shapes its path gives it (A-E: the 40x80 grid of a
   320x640 frame, 128 channels, 96 edges; F, the kNN: a mapper train
   step's two calls, ``knn_room``), with timings (CUDA events), bounds and
   a library formulation's time; for kernel A also the mean box size of
   its pixel tiles per level (``cuda_corr.tile_box_stats``); for D and E
   also the sector floor (``cuda_corr.plane_sector_stats``), a
   ``grid_sample`` time, E without and with its range check on the card,
   both on smooth flow, and D at its callers' shapes (``CorrBlock``
   levels 1-3, an ``alt_corr_chunk`` tile); for F the rows that differ
   from the plain version (it raises unless none) and its launches a step;
3. volume: the correlation-volume path (``CorrBlock`` through kernel E,
   run under ``torch.cuda.set_sync_debug_mode("error")`` to show that it
   makes no device sync; ``lookup_pyramid`` without slots and
   ``alt_corr_chunk`` through D)
   and a 3-level feature pyramid (C) on the card, each held against the
   tracker's 4-level feature-store lookup (A) on the same frames and
   coordinates. Launch counts are zeroed before and read after: they are
   the C, D and E launches of the kernels line;
4. reference: the card's path against the CPU path (plain versions, the
   path the tests hold against the JAX package) on 48x64 input: two DSPO
   rounds from one identical state, held tightly, and whole 10-frame
   tracker runs, which must take the same path;
5. pipeline: ``SLAM(cfg, stream).run()`` tracking-only, with bench.py's
   tracking config (motion filter with lookahead, frontend DSPO rounds,
   loop closure, online BA every 12 keyframes) and the final global BA,
   on a 320x640 synthetic circuit stream with a random-weight bf16 net at
   full width and cached mono-depth priors; then video.npz (whose
   full-resolution validity mask runs the depth filter), the keyframe
   ATE, the trajectory filler and the full ATE. Launch counts are zeroed
   before and read after: they are the A and B launches of the kernels
   line. ``LookupProbe`` wraps kernel A's wrapper from here for the run:
   CUDA events around each wrapper call that launches give A's summed
   event-bracketed time and its mean per launch (an upper bound on device
   time: it includes host gaps while the card waits), and the frames that
   the last frame's largest frontend lookup reads are copied, keeping
   level 0 of f2 a view of f1 as on the main path; after the run A is
   held against its plain version on them and timed beside the library
   form and its bound (A's ``pipeline`` entry in the kernels line). The
   peak memory includes that copy (``probe_capture_bytes``);
6. mono prior: the omnidata DPT at the checkpoint's widths (768 dims, 12
   blocks, 12 heads, 256 features) at 512x512 with random weights, on the
   card and on the CPU (``mono_prior_check``): its taps (backbone and
   transformer hooks, ``refinenet1``, the depth before the last ReLU) and
   ``MonoDepthEstimator.predict`` of a 320x640 frame within ``DPT_TOL``,
   the share of depths inside (0, 1), ms per frame (median of 10 calls,
   CUDA events), peak memory, and the bound from the forward's operations
   (``dpt_work``) at the float32 rate (TF32 is off);
7. online prior: ``SLAM(cfg, stream).run()`` tracking-only with
   ``mono_prior.predict_online`` (``online_prior_run``, 20 frames): the
   DPT's calls against the cadence (every ``mapping.every_frame``-th frame)
   and the admissions, its ``.npy`` files, its summed time, and a second
   ``SLAM`` with ``predict_online: False`` reading the same priors from the
   cache;
8. mapping step: one mapping train step (render, losses, gradients, Adam)
   from one 120x160 state at the Replica widths on the card and on the CPU
   (``mapping_step_check``), in both stages, with the kNN's disagreement;
9. mapping: ``SLAM(cfg, stream).run()`` with the mapper on (asynchronous,
   on its worker's CUDA stream) at 320x640 and the Replica widths, with the
   cuts ``MAPPING_FRAMES`` / ``MAPPING_CUTS`` printed (the tracking config
   is bench.py's, multiview filter 0.01 included): ``MapProbe`` gives the
   mapper's seconds per keyframe, the mean train-step ms and the kNN's
   share (CUDA events on the worker's stream); then anchors and points,
   ``final_refine`` seconds, peak memory, the first and last losses; the
   geo loss must fall over the first mapped keyframe, and ``final_refine``
   must run its optimisation. Kernels A and B launch again in its tracking,
   F (the kNN) in its mapping: the kernels line's F launches are this
   run's. ``terminate`` then runs the evaluations, each in its phase: the
   keyframe and full-trajectory render metrics, the TSDF mesh and, against
   a ground-truth PLY of the synthetic plane (``write_plane_mesh``), the
   reconstruction metrics; the phase prints the three metrics files, the
   LPIPS variant, each evaluation's seconds and the mesh's counts, and
   fails if a file is missing. The cached true-depth priors stay: a
   random-weight DPT's priors would starve the mapper;
10. eval modules: TSDF integration of one frame and LPIPS, card against
    CPU (``eval_modules_check``);
11. entry point (``entry_point_phase``): a 7-Scenes-layout scene written
    here (the synthetic circuit at 7-Scenes' 480x640 and camera, PNG
    colour, 16-bit depth, pose files) and a scene YAML inheriting from
    ``configs/7scenes/7scenes.yaml`` (384x512 output, buffer
    ``ENTRY_BUFFER``, DBA, the
    online omnidata DPT at full width; every frame admitted and kept, a
    checkpoint every ``ENTRY_CHECKPOINT_EVERY`` keyframes); ``python -m
    glorie_slam_tpu_torch.cli <yaml> --only_tracking --max_frames 20`` in
    a subprocess, its outputs checked (``cfg.yaml``, ``video.npz``,
    ``traj/``, ``logs/phase_times.json``, ``state.npz``); a second run with ``--resume`` from the mid-run
    checkpoint (keyframes, timestamps, the largest keyframe-pose
    difference from the first run: ``index_add`` sums in atomic order on
    the card, so no bit equality is asserted); the checkpoint loaded into
    a ``SLAM`` here and saved again, equal array for array; frames/s,
    KF/s, read + decode + resize ms per frame, checkpoint seconds and
    bytes, DPT calls, the A and B launches of both runs (read from the
    ``kernel_launches`` of their ``phase_times.json``: each subprocess
    starts at 0), and a
    Replica-layout JPEG frame, which raises the ImportError naming cv2
    (or decodes where cv2 is installed);
12. endurance (``endurance_phase``): ``tools/long_run_synthetic.long_run``
    tracking-only over ``ENDURANCE_FRAMES`` 240x320 frames (loop closure,
    online BA every 20 keyframes, final BA), then with the asynchronous
    mapper (map-light, every ``ENDURANCE_EVERY_KF``-th keyframe) over
    ``ENDURANCE_MAPPED_FRAMES``, the launch counts zeroed before each run
    and read after: the KF/s series per 20 frames with each phase's
    seconds, peak memory, every kernel's launches, the mapper's overlap
    stats and each handshake's snapshot bytes and clone time (CUDA events
    on the tracker's stream);
13. mapper schedule (``mapper_schedule_phase``):
    ``tools/mapper_schedule_run.schedule_run`` at Replica's 400 / 300 / 150
    iterations on 10 oracle frames, with ``--light``'s 300 / 500 pixels and
    8192 points (the JAX artifact's), held to ``convergence`` (the criteria
    of ``tests/test_mapper_schedule.py``): ms per train iteration, the PSNR
    of keyframe 4, the points, the first and last losses per keyframe;
14. suite (``suite_phase``): ``python -m
    glorie_slam_tpu_torch.tools.run_suite`` over a directory of two
    7-Scenes-layout scenes, a ``demo_`` file, a base YAML and a scene whose
    data is missing: exit 1, the two good rows in its JSON and table;
15. sharded (``sharded_phase``): the edge-sharded path (``parallel/``):
    12 DSPO rounds of ``graph_update_rounds`` at 320x640 over 96 active
    edges, then ``Backend.dense_ba(steps=2)`` over 24 keyframes, and a
    whole tracking-only ``SLAM.run`` through the entry point with the
    pipeline phase's config and stream (``SHARD_SLAM_FRAMES`` frames: loop
    closure, online BA and the final BA), on 1 rank and on 2 gloo ranks
    that share the card (4 NCCL ranks too where the machine has 4 cards),
    each rank a process started by ``parallel.launch`` running
    ``tests/torch_drills.card_drill``. Every rank ends bitwise equal to
    the others, and the n-rank results stay within ``SHARD_TOL`` of one
    rank's (the whole run: the same keyframes and frontend edges). The
    comparisons run under deterministic algorithms: on the card
    ``index_add_`` otherwise sums in atomic order. With the batch-invariant
    net and in ``dense_ba`` they are bitwise. Per rank: the seconds, the A
    and B launches (every kernel's zeroed in each rank before each run and
    summed for the kernels line) and the bytes received.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line (each
kernel's ``launches`` on its main path (F's: the mapping phase's), and
``launches_by_path``: the pipeline, volume, both endurance runs, the
mapping phase and the 2-rank sharded runs (the rounds, ``dense_ba`` and
the whole run), summed over their ranks), and
as its last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that line. Needs no network; uses one card.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12               # H100 SXM float32 outside tensor cores
# bench.py runs 60 frames; 40 keep the whole script well inside its time
# limit while window=25 loop closure and ba_freq=12 online BA both fire
PIPELINE_FRAMES = 40
# the mapping phase at the Replica widths: 16 frames (warmup 8, so 8-9
# mapped keyframes; at 12 frames too few had the mapper's 100 valid
# depths) and the optimisation cut from 1500 / 400 / 400 iterations so that
# the phase takes minutes, not hours
MAPPING_FRAMES = 16
MAPPING_CUTS = {"iters_first": 40, "geo_iter_first": 15, "iters": 10,
                "pretrained": None}
# the online-prior run: 20 frames, the DPT at every 5th and every admitted
ONLINE_FRAMES = 20
# the oracle evaluation: 5 frames, keyframes 0, 2 and 4 mapped
ORACLE_FRAMES = 5
ORACLE_KEYFRAMES = (0, 2, 4)
# Depth cut so that the script, with the run tools' phases, stays inside
# its time limit on the slowest hosts seen (a whole run took 986 s of
# command time with the depths on the left; a host 1.4x slower was seen in
# the same PR). The mapper schedule keeps its iteration counts and takes
# the rays and points of ``--light``, as the JAX artifact
# (``logs/mapper_sched_r03.json``) did. Printed at the start.
SCRIPT_CUTS = {
    "oracle evaluation frames (keyframes)": ("7 (0, 3, 6)", "5 (0, 2, 4)"),
    "entry point frames (checkpoint every)": ("30 (10)", "20 (5)"),
    "entry point buffer": (600, 100),
    "endurance tracking-only frames": (420, 60),
    "endurance mapped frames": (200, 60),
    "mapper schedule pixels / pixels_adding / points": (
        "1000 / 1500 / 65536", "300 / 500 / 8192 (--light)"),
}


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
    build.knn_library()
    build.proximity_library()


# ---------------------------------------------------------------------------
# shared inputs, bounds and library formulations
# ---------------------------------------------------------------------------

def edge_inputs(dev, N=16, E=96, h0=40, w0=80, seed=0):
    """Random bf16 frame features (N, h0, w0, 128), edges iis/jjs (E,)
    int32 and level-0 coords (E, h0*w0, 2): the pixel grid plus 3-pixel
    noise, with NaN centres and far off-plane ones mixed in."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    npix = h0 * w0
    fm = torch.randn((N, h0, w0, 128), generator=g).to(dev, torch.bfloat16)
    iis = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    jjs = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    yy, xx = torch.meshgrid(torch.arange(h0), torch.arange(w0),
                            indexing="ij")
    base = torch.stack([xx, yy], -1).reshape(1, npix, 2).float()
    coords = base + 3.0 * torch.randn((E, npix, 2), generator=g)
    coords[:, ::97] = float("nan")                       # NaN centres
    coords[:, 5::53] += 60.0                             # off the plane
    coords[:, 7::61] -= 45.0
    return fm, iis, jjs, coords.to(dev).contiguous()


def window_cells(coords, hl, wl):
    """(x, y) indices (E, npix, 8) of the 8x8 cells each window touches,
    and their in-plane masks; coords in level units (NaN -> 0)."""
    import torch
    c = torch.nan_to_num(coords)
    r = torch.arange(8, device=coords.device)
    gx = torch.floor(c[..., 0]).long()[..., None] - 3 + r
    gy = torch.floor(c[..., 1]).long()[..., None] - 3 + r
    return gx, gy, (gx >= 0) & (gx < wl), (gy >= 0) & (gy < hl)


def in_plane_cells(coords, hl, wl):
    """How many (edge, pixel, cell) window reads land inside the plane."""
    _, _, okx, oky = window_cells(coords, hl, wl)
    return int(okx.sum(-1).mul(oky.sum(-1)).sum())


def bound(nbytes, flops, flop_rate):
    """(least ms, what sets it) at the H100's memory rate and ``flop_rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def bilinear_window(cells, coords):
    """cells (E, npix, 8, 8) [y][x] float, coords level units -> the 7x7
    bilinear window (E, npix, 49), channel a*7 + b (a: x offset)."""
    import torch
    E, npix = cells.shape[:2]
    c = torch.nan_to_num(coords)
    fx = (c[..., 0] - torch.floor(c[..., 0]))[..., None, None]
    fy = (c[..., 1] - torch.floor(c[..., 1]))[..., None, None]
    win = ((1 - fy) * ((1 - fx) * cells[..., :7, :7] + fx * cells[..., :7, 1:])
           + fy * ((1 - fx) * cells[..., 1:, :7]
                   + fx * cells[..., 1:, 1:]))               # [b][a]
    return win.transpose(-1, -2).reshape(E, npix, 49)


def library_level(f1, f2, iis, jjs, coords):
    """One level's lookup from library calls: the correlation volume by
    torch.bmm of the gathered bf16 features (fp32 accumulate), then the
    8x8 window cells by torch.gather and the bilinear weights. f2
    (N, hl, wl, C); coords in level units. Returns (E, npix, 49) f32."""
    import torch
    E, npix, _ = coords.shape
    _, hl, wl, C = f2.shape
    a = f1[iis.long()]
    b = f2[jjs.long()].reshape(E, hl * wl, C)
    vol = torch.bmm(a, b.transpose(1, 2))
    gx, gy, okx, oky = window_cells(coords, hl, wl)
    idx = (gy.clamp(0, hl - 1)[..., :, None] * wl
           + gx.clamp(0, wl - 1)[..., None, :])
    cells = vol.gather(2, idx.reshape(E, npix, 64)).float()
    cells = cells.reshape(E, npix, 8, 8) * (oky[..., :, None]
                                            & okx[..., None, :]) / 16.0
    return bilinear_window(cells, coords)


def library_lookup(f1, f2_levels, iis, jjs, coords):
    """Kernel A's function from library calls: ``library_level`` per
    level, rounded to bf16."""
    import torch
    return torch.cat([library_level(f1, f2, iis, jjs, coords / 2.0 ** lvl)
                      for lvl, f2 in enumerate(f2_levels)],
                     -1).to(torch.bfloat16)


def library_plane(planes, slots, coords):
    """Kernels D/E's function from library calls: the 8x8 window cells of
    plane row slots[e] (row e without slots) by one flat index gather,
    then the bilinear weights. Returns (E, npix, 49) f32."""
    import torch
    E, npix, _ = coords.shape
    _, hl, wl, _ = planes.shape
    rows = (torch.arange(E, device=planes.device) if slots is None
            else slots.long())
    gx, gy, okx, oky = window_cells(coords, hl, wl)
    cell = (gy.clamp(0, hl - 1)[..., :, None] * wl
            + gx.clamp(0, wl - 1)[..., None, :])           # (E, p, 8, 8)
    pix = torch.arange(npix, device=planes.device)[None, :, None, None]
    idx = (rows[:, None, None, None] * (hl * wl) + cell) * npix + pix
    cells = planes.reshape(-1)[idx].float() * (oky[..., :, None]
                                               & okx[..., None, :])
    return bilinear_window(cells, coords)


def kernel_result(kernel, out, ref, ms, plain_ms, lib_ms, bound_ms_by,
                  **extra):
    return dict(name=kernel.name, route="cuda", source=kernel.source,
                replaces=kernel.replaces,
                max_abs_err=float((out.float() - ref.float()).abs().max()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms_by[0],
                bound_by=bound_ms_by[1], library_ms=lib_ms, **extra)


def check_close(name, out, ref, atol, rtol):
    """Raise unless |out - ref| <= atol + rtol * |ref| everywhere and out
    is finite; returns the tolerance as text."""
    import torch
    d = (out.float() - ref.float()).abs()
    tol = atol + rtol * ref.float().abs()
    if not bool((d <= tol).all()):
        raise AssertionError(
            f"{name}: max |d| {d.max().item():.4g}, "
            f"{(d > tol).sum().item()} values over {atol} + {rtol}|ref|")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    return f"{atol} + {rtol}|ref|"


# ---------------------------------------------------------------------------
# kernels A and C: correlation lookups from feature stores
# ---------------------------------------------------------------------------

def store_bytes(f1, f2_levels, iis, jjs):
    """Bytes of the feature-store rows a lookup reads: the source frames'
    level-0 rows and the target frames' rows at each level, each once (at
    level 0 f2 is f1's store: frames used on either side count once)."""
    import torch
    row = f1.shape[-1] * f1.element_size()
    src, dst = torch.unique(iis.long()), torch.unique(jjs.long())
    shared = f2_levels[0].data_ptr() == f1.data_ptr()
    n0 = (torch.unique(torch.cat([src, dst])).numel() if shared
          else src.numel() + dst.numel())
    return (n0 * f1.shape[1] * row
            + sum(dst.numel() * lv.shape[1] * lv.shape[2] * row
                  for lv in f2_levels[1:]))


def measure_lookup_pyramid(f1, f2, iis, jjs, coords):
    """Kernel A on one input set: held against its plain version, timed
    beside the library formulation, with its bound and the box sizes of
    its tiles (``cuda_corr.tile_box_stats``)."""
    import torch
    from glorie_slam_tpu_torch.ops import cuda_corr

    E, npix, _ = coords.shape
    out = cuda_corr.lookup_pyramid(f1, f2, iis, jjs, coords)
    torch.cuda.synchronize()
    ref = cuda_corr.lookup_pyramid_plain(f1, f2, iis, jjs, coords)
    tol = check_close("lookup_pyramid", out, ref, 1e-2, 8e-3)  # ~2 ulps

    ms = cuda_ms(lambda: cuda_corr.lookup_pyramid(f1, f2, iis, jjs,
                                                  coords), 20)
    plain_ms = cuda_ms(lambda: cuda_corr.lookup_pyramid_plain(
        f1, f2, iis, jjs, coords), 3, warmup=1)
    lib_ms = cuda_ms(lambda: library_lookup(f1, f2, iis, jjs, coords), 3,
                     warmup=1)

    # bytes: the store rows read once, coords, the bf16 output written
    # once; operations: the 128-term dot products of in-plane window cells
    nbytes = (store_bytes(f1, f2, iis, jjs) + coords.numel() * 4
              + 2 * E * 4 + out.numel() * 2)
    cells = sum(in_plane_cells(coords / 2.0 ** lvl, lv.shape[1],
                               lv.shape[2]) for lvl, lv in enumerate(f2))
    dims = [tuple(lv.shape[1:3]) for lv in f2]
    return kernel_result(
        cuda_corr.LOOKUP_PYRAMID, out, ref, ms, plain_ms, lib_ms,
        bound(nbytes, 2 * 128 * cells, BF16_FLOPS), tolerance=tol,
        box=cuda_corr.tile_box_stats(coords, dims),
        shapes=f"E={E} N={f1.shape[0]} {dims[0][0]}x{dims[0][1]} C=128 -> "
               f"({E},{npix},196) bf16")


def check_kernel_a(dev, inputs):
    from glorie_slam_tpu_torch.ops import corr

    fm, iis, jjs, coords = inputs
    N, h0, w0, _ = fm.shape
    pyr = corr.prep_feat_pyramid(fm)
    f2 = (pyr[0].reshape(N, h0, w0, 128),) + tuple(pyr[1:])
    return measure_lookup_pyramid(pyr[0], f2, iis, jjs, coords)


def check_kernel_c(dev, inputs):
    """Kernel C at level 0 (the 40x80 store) and level 3 (5x10); the
    kernels line carries level 0's numbers."""
    import torch
    from glorie_slam_tpu_torch.ops import corr, cuda_corr

    fm, iis, jjs, coords = inputs
    N, h0, w0, _ = fm.shape
    E, npix, _ = coords.shape
    pyr = corr.prep_feat_pyramid(fm)
    res = {}
    for lvl in (3, 0):
        hl, wl = (h0, w0) if lvl == 0 else pyr[lvl].shape[1:3]
        f2 = pyr[lvl].reshape(N, hl * wl, 128).contiguous()
        cl = coords / 2.0 ** lvl
        args = (pyr[0], f2, iis, jjs, cl, hl, wl)
        out = cuda_corr.lookup_level(*args)
        torch.cuda.synchronize()
        ref = cuda_corr.lookup_level_plain(*args)
        # float32 sums of the same bf16 products in another order
        tol = check_close(f"lookup_level (level {lvl})", out, ref, 1e-4,
                          1e-4)
        ms = cuda_ms(lambda: cuda_corr.lookup_level(*args), 20)
        plain_ms = cuda_ms(lambda: cuda_corr.lookup_level_plain(*args), 3,
                           warmup=1)
        lib_ms = cuda_ms(lambda: library_level(
            pyr[0], f2.reshape(N, hl, wl, 128), iis, jjs, cl), 3, warmup=1)
        # at level 0, f2 is f1's store itself: it is read once
        store_el = pyr[0].numel() + (f2.numel() if lvl else 0)
        nbytes = (store_el * 2 + coords.numel() * 4 + 2 * E * 4
                  + out.numel() * 4)
        res[lvl] = kernel_result(
            cuda_corr.LOOKUP_LEVEL, out, ref, ms, plain_ms, lib_ms,
            bound(nbytes, 2 * 128 * in_plane_cells(cl, hl, wl), BF16_FLOPS),
            tolerance=tol, shapes=f"level {lvl}: E={E} N={N} f2 {hl}x{wl} C=128 -> "
                   f"({E},{npix},49) f32")
    res[0]["level3"] = {k: res[3][k] for k in (
        "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "shapes")}
    return res[0]


# ---------------------------------------------------------------------------
# kernels D and E: lookups over precomputed correlation planes
# ---------------------------------------------------------------------------

def smooth_coords(E=96, h0=40, w0=80, seed=1):
    """Level-0 coords (E, h0*w0, 2) of smooth flow, by the rule of
    ``tests/test_torch_cuda.py::_flow`` "smooth" (the pixel grid under a
    small per-edge scale and shift and a gentle warp) drawn from
    ``torch.Generator().manual_seed(seed)``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h0, dtype=torch.float32),
                            torch.arange(w0, dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([xx, yy], -1).reshape(1, h0 * w0, 2)
    scale = 1.0 + 0.05 * torch.rand((E, 1, 1), generator=g)
    shift = torch.tensor([1.5, -0.7]) + torch.randn((E, 1, 2), generator=g)
    c = (base - torch.tensor([w0 / 2, h0 / 2])) * scale + torch.tensor(
        [w0 / 2, h0 / 2]) + shift
    return c + 0.3 * torch.sin(base[..., 1:] / 5.0) + 0.1 * torch.randn(
        (E, h0 * w0, 2), generator=g)


def grid_sample_plane(store, slots, coords):
    """D/E's window by one ``F.grid_sample`` call (bilinear, zeros padding,
    align_corners=True) per dtype the installed PyTorch takes, bf16 and
    float32: {dtype: {"ms", "max_abs_err" against the plain version}}.
    The pixel-major (E*npix, 1, hl, wl) copy of the planes and the
    sampling grid (cleaned coordinates, normalised) are made outside the
    timed call. A bf16 call also takes its grid in bf16, which rounds the
    sample positions: its max |d| shows it. cuDNN is off for the call
    (its grid sampler refuses float32 at these sizes), so it is PyTorch's
    own CUDA kernel."""
    import torch
    import torch.nn.functional as F
    from glorie_slam_tpu_torch.ops import cuda_corr

    E, npix, _ = coords.shape
    _, hl, wl, _ = store.shape
    rows = (torch.arange(E, device=store.device) if slots is None
            else slots.long())
    ref = cuda_corr.lookup_plane_slots_plain(store, rows, coords)
    c = torch.nan_to_num(coords)
    cx = c[..., 0].clamp(-16, wl + 16)[..., None, None]
    cy = c[..., 1].clamp(-16, hl + 16)[..., None, None]
    off = torch.arange(-3, 4, device=store.device, dtype=torch.float32)
    gx = (cx + off[None, :]).expand(E, npix, 7, 7)      # [b][a]: x = a
    gy = (cy + off[:, None]).expand(E, npix, 7, 7)      # y = b
    grid = torch.stack([2 * gx / (wl - 1) - 1, 2 * gy / (hl - 1) - 1],
                       -1).reshape(E * npix, 7, 7, 2)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        inp = store[rows].permute(0, 3, 1, 2).reshape(E * npix, 1, hl, wl)
        inp, gd = inp.to(dt).contiguous(), grid.to(dt)

        def call():
            with torch.backends.cudnn.flags(enabled=False):
                return F.grid_sample(inp, gd, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=True)
        name = str(dt).replace("torch.", "")
        try:
            out = call()
        except RuntimeError as exc:            # the dtype is not taken
            res[name] = {"error": str(exc).splitlines()[0]}
            continue
        out = out.float().reshape(E, npix, 7, 7).transpose(-1, -2)
        res[name] = dict(
            ms=cuda_ms(call, 5, warmup=1),
            max_abs_err=float((out.reshape(E, npix, 49) - ref).abs().max()))
        del inp, gd, out
    return res


def measure_plane(kernel, store, slots, coords, label):
    """Kernel D (``slots`` None) or E on one input set: held against its
    plain version, timed beside it and the gather formulation, with its
    bound and the sector floor (``cuda_corr.plane_sector_stats``). E is
    timed two ways: ``ms`` is the kernel alone (``checked=True``, as
    ``CorrBlock`` calls it, its slots checked on the host), ``checked_ms``
    the wrapper with its range check on the card (one device sync)."""
    import torch
    from glorie_slam_tpu_torch.ops import cuda_corr

    E, npix, _ = coords.shape
    _, hl, wl, _ = store.shape
    if slots is None:
        def run():
            return cuda_corr.lookup_plane(store, coords)

        def plain():
            return cuda_corr.lookup_plane_plain(store, coords)
    else:
        def run():
            return cuda_corr.lookup_plane_slots(store, slots, coords,
                                                checked=True)

        def plain():
            return cuda_corr.lookup_plane_slots_plain(store, slots, coords)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    # float32 sums of the same bf16 cells in another order
    tol = check_close(f"{kernel.name} ({label})", out, ref, 1e-4, 1e-4)
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(plain, 3, warmup=1)
    lib_ms = cuda_ms(lambda: library_plane(store, slots, coords), 3,
                     warmup=1)
    # bytes: the in-plane cells the windows need (2 B each), coords,
    # slots, the f32 output; operations: 4 corner multiply-adds per
    # output value, float32
    nbytes = (in_plane_cells(coords, hl, wl) * 2 + coords.numel() * 4
              + (0 if slots is None else E * 4) + out.numel() * 4)
    sec = cuda_corr.plane_sector_stats(coords, hl, wl)
    res = kernel_result(
        kernel, out, ref, ms, plain_ms, lib_ms,
        bound(nbytes, 8 * out.numel(), FP32_FLOPS), tolerance=tol,
        sector_floor_ms=1e3 * sec["floor_bytes"] / HBM_BYTES_PER_S,
        sector_mb=sec["sector_bytes"] / 1e6,
        cells_per_group=sec["cells_per_group"],
        shapes=f"{label}: planes ({store.shape[0]},{hl},{wl},{npix}) bf16"
               + ("" if slots is None else ", shuffled slots")
               + f" -> ({E},{npix},49) f32")
    if slots is not None:
        res["checked_ms"] = cuda_ms(
            lambda: cuda_corr.lookup_plane_slots(store, slots, coords), 20)
    return res


# the mapper train step's two kNN calls: ``sample_near_cloud``'s 25 probes
# and the render's 10 samples on each of the 8192 rays, against the
# ``replica-map`` window's ~35,600 points, some of them exact copies
KNN_RAYS, KNN_PROBES, KNN_SAMPLES = 8192, 25, 10
KNN_POINTS, KNN_COPIES = 35_600, 1_800
KNN_CAPACITY = 1 << 20
KNN_INSTR_PER_PAIR = 6      # 3 for the cross term, q2 + p2, the FMA, a compare


def knn_room(dev, seed=0):
    """kernel F's inputs at the train step's shapes: the five faces of a
    6 x 4 x 3 m room holding ``KNN_POINTS`` points (1 cm noise; the last
    ``KNN_COPIES`` exact copies of the first) in a ``KNN_CAPACITY``-slot
    cloud, and rays from inside it: ``KNN_PROBES`` probes a ray from 0.12
    to 1.2 times the depth of the face it meets, and ``KNN_SAMPLES``
    samples within 5% of that depth."""
    import torch
    g = torch.Generator().manual_seed(seed)
    n = KNN_POINTS - KNN_COPIES
    size = torch.tensor([6.0, 4.0, 3.0])
    p = torch.rand((n, 3), generator=g) * size
    face = torch.randint(0, 5, (n,), generator=g)
    for f, axis, at in ((0, 2, 0.0), (1, 0, 0.0), (2, 0, 6.0), (3, 1, 0.0),
                        (4, 1, 4.0)):
        p[face == f, axis] = at
    pts = torch.full((KNN_CAPACITY, 3), 0.001)
    pts[:n] = p + 0.01 * torch.randn((n, 3), generator=g)
    pts[n:KNN_POINTS] = pts[:KNN_COPIES]
    o = torch.tensor([3.0, 2.0, 1.5])
    d = torch.randn((KNN_RAYS, 3), generator=g)
    d[:, 2] = -d[:, 2].abs()
    d = d / d.norm(dim=1, keepdim=True)
    far = (torch.where(d > 0, size, torch.zeros(3)) - o) / d
    depth = far.nan_to_num(nan=1e9, posinf=1e9).clamp(min=0).min(1).values
    z_probe = 1.2 * depth[:, None] * torch.linspace(0.1, 1.0, KNN_PROBES)
    z_surf = depth[:, None] * torch.linspace(0.95, 1.05, KNN_SAMPLES)
    queries = [(o + d[:, None] * z[..., None]).reshape(-1, 3).to(dev)
               for z in (z_probe, z_surf)]
    return pts.to(dev), queries


def check_kernel_f(dev):
    """Kernel F (``knn.knn_search`` on the card) against its plain version
    at the train step's shapes (``knn_room``): every row's neighbours and
    distances equal, or it raises; both calls' ms (a step's), the plain
    version's, the bound (pairs x ``KNN_INSTR_PER_PAIR`` FP32 instructions
    at the published FP32 rate, one instruction a lane and clock), and the
    launches a step."""
    from glorie_slam_tpu_torch.ops import knn
    pts, queries = knn_room(dev)
    n_scan, _ = knn.scan_slots(pts.shape[0], KNN_POINTS)
    rows, err = 0, 0.0
    for q in queries:
        D, I = knn.knn_search(q, pts, KNN_POINTS)
        Dp, Ip = knn.knn_plain(q, pts, KNN_POINTS, knn.NN_NUM, n_scan)
        rows += int(((D != Dp) | (I != Ip)).any(1).sum())
        err = max(err, float((D - Dp).abs().max()))
    if rows:
        raise AssertionError(f"kernel F: {rows} rows differ from its plain "
                             "version")

    def step():
        for q in queries:
            knn.knn_search(q, pts, KNN_POINTS)

    before = knn.KNN.launches
    ms = cuda_ms(step, 10)
    launches = (knn.KNN.launches - before) / 12
    plain_ms = cuda_ms(lambda: [knn.knn_plain(q, pts, KNN_POINTS, knn.NN_NUM,
                                              n_scan) for q in queries], 2,
                       warmup=1)
    pairs = sum(q.shape[0] for q in queries) * KNN_POINTS
    return dict(name=knn.KNN.name, route="cuda", source=knn.KNN.source,
                replaces=knn.KNN.replaces, max_abs_err=err, rows_differ=rows,
                ms=ms, plain_ms=plain_ms,
                bound_ms=1e3 * pairs * KNN_INSTR_PER_PAIR / (FP32_FLOPS / 2),
                bound_by="operations", library_ms=None,
                launches_per_step=launches,
                shapes={"queries": [q.shape[0] for q in queries],
                        "points": KNN_POINTS, "copies": KNN_COPIES,
                        "k": knn.NN_NUM})


def brief(r):
    """A D/E entry's numbers without the kernel's names."""
    return {k: r[k] for k in (
        "max_abs_err", "tolerance", "ms", "checked_ms", "plain_ms",
        "bound_ms", "sector_floor_ms", "sector_mb", "cells_per_group",
        "library_ms", "shapes") if k in r}


def check_kernels_de(dev, inputs):
    """D on the level-0 pixel-minor volume of the 96 edges (96, 40, 80,
    3200) bf16, about 2 GB; E on the same tensor as a store at the
    bucketed capacity (96) read through a shuffled ``slots``; both with
    ``grid_sample`` as a second library yardstick. Then both on smooth
    flow (``smooth_coords``) over the same volume (it does not depend on
    the coordinates), and D where its callers run it: the ``CorrBlock``
    pyramid's levels 1-3 and one 256-pixel tile of ``alt_corr_chunk``'s
    64-edge chunk. The first two entries' own numbers are the kernels-phase
    inputs'; the others ride along in them."""
    import torch
    from glorie_slam_tpu_torch.ops import corr, cuda_corr
    from glorie_slam_tpu_torch.utils.buckets import bucket

    fm, iis, jjs, coords = inputs
    E, npix, _ = coords.shape
    fcf = fm.permute(0, 3, 1, 2)
    store = corr.all_pairs_corr_lanes(fcf[iis.long()], fcf[jjs.long()])
    if store.shape[0] != bucket(E):
        raise AssertionError("store is not at the bucketed capacity")
    g = torch.Generator(device="cpu").manual_seed(4)
    slots = torch.randperm(E, generator=g).to(dev, torch.int32)
    smooth = smooth_coords(E, *fm.shape[1:3]).to(dev)
    d, e = cuda_corr.LOOKUP_PLANE, cuda_corr.LOOKUP_PLANE_SLOTS
    res_d = measure_plane(d, store, None, coords, "kernels-phase level 0")
    res_e = measure_plane(e, store, slots, coords, "kernels-phase level 0")
    res_d["grid_sample"] = grid_sample_plane(store, None, coords)
    res_e["grid_sample"] = grid_sample_plane(store, slots, coords)
    torch.cuda.empty_cache()
    res_d["smooth"] = brief(measure_plane(d, store, None, smooth,
                                          "smooth level 0"))
    res_e["smooth"] = brief(measure_plane(e, store, slots, smooth,
                                          "smooth level 0"))
    levels = corr.build_pyramid_lanes(store)[1:]
    del store
    torch.cuda.empty_cache()
    res_d["corr_block_levels"] = [
        brief(measure_plane(d, lv, None, coords / 2.0 ** (lvl + 1),
                            f"CorrBlock level {lvl + 1}"))
        for lvl, lv in enumerate(levels)]
    del levels
    # alt_corr_chunk's first tile at level 0: 64 edges, 256 source pixels
    n_alt, tile = 64, corr.ALT_TILE
    h0, w0 = fm.shape[1:3]
    f2 = fcf[jjs[:n_alt].long()].float().reshape(n_alt, 128, h0 * w0) / 4
    f1 = fcf[iis[:n_alt].long()].float().reshape(n_alt, 128, h0 * w0) / 4
    plane = torch.bmm(f2.transpose(1, 2), f1[:, :, :tile]).reshape(
        n_alt, h0, w0, tile).to(torch.bfloat16)
    res_d["alt_corr_tile"] = brief(measure_plane(
        d, plane, None, coords[:n_alt, :tile].contiguous(),
        "alt_corr_chunk tile"))
    torch.cuda.empty_cache()
    return [res_d, res_e]


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
# the correlation-volume path against the feature-store lookup
# ---------------------------------------------------------------------------

def volume_check(dev, inputs, alt_edges=64):
    """CorrBlock (E), lookup_pyramid without slots (D), alt_corr_chunk (D)
    and a 3-level feature pyramid (C) against kernel A's 4-level lookup on
    the same frames and coordinates (the identity tests/test_ops.py:261
    asserts for the JAX package).

    Tolerances: the volume path rounds the fp32 volume to bf16 and pools
    the rounded values; kernel A rounds its output to bf16 from pooled
    bf16 features. Each side is within about one bf16 ulp of the exact
    value, so the two are held to two: 0.02 + 0.016|ref|. C's float32
    output against A's bf16: one rounding, 0.01 + 0.008|ref|."""
    import torch
    from glorie_slam_tpu_torch.ops import corr

    fm, iis, jjs, coords = inputs
    N, h0, w0, C = fm.shape
    E = iis.shape[0]
    c4 = coords.reshape(E, h0, w0, 2)
    ref = corr.lookup_pyramid_feats(corr.prep_feat_pyramid(fm), iis, jjs,
                                    c4)
    fcf = fm.permute(0, 3, 1, 2)
    g = torch.Generator(device="cpu").manual_seed(5)
    perm = torch.randperm(E, generator=g).numpy()
    perm_d = torch.as_tensor(perm, device=dev)
    c4_perm = c4[perm_d]

    _zero_launches()
    t0 = time.perf_counter()
    block = corr.CorrBlock(fcf[iis.long()], fcf[jjs.long()])
    block = block[perm]                       # compact order != slot order
    # the lookup checks its host slots on the host: no device sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_e = block(c4_perm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out_d = corr.lookup_pyramid(block.pyramid, c4)
    out_alt = corr.alt_corr_chunk(fcf, c4[:alt_edges], iis[:alt_edges],
                                  jjs[:alt_edges])
    out_c = corr.lookup_pyramid_feats(corr.prep_feat_pyramid(fm, 3), iis,
                                      jjs, c4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()

    errs = {}
    for name, out, want, atol, rtol in (
            ("CorrBlock (E)", out_e, ref[perm_d], 2e-2, 1.6e-2),
            ("lookup_pyramid (D)", out_d, ref, 2e-2, 1.6e-2),
            ("alt_corr_chunk (D)", out_alt, ref[:alt_edges], 2e-2, 1.6e-2),
            ("3-level feature lookup (C)", out_c, ref[..., :147], 1e-2,
             8e-3)):
        errs[name] = dict(
            max_abs_err=float((out.float() - want.float()).abs().max()),
            tolerance=check_close(name, out, want, atol, rtol))
    for name in ("lookup_level", "lookup_plane", "lookup_plane_slots"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "volume path")
    pyr_bytes = sum(p.numel() * p.element_size() for p in block.pyramid)
    return dict(max_abs_err_vs_a=errs, launches=launches,
                corr_block_sync_free=True,
                seconds=seconds, corr_block_bytes=pyr_bytes,
                capacity=block.capacity,
                shapes=f"E={E} N={N} {h0}x{w0} C={C}, alt chunk "
                       f"{alt_edges} edges")


# ---------------------------------------------------------------------------
# tracker runs
# ---------------------------------------------------------------------------

def run_tracker(device, H, W, n_frames, dtype, cfg_fn):
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


def compact_lookup_inputs(f1, f2_levels, iis, jjs, coords):
    """A copy of a kernel A call's inputs that holds only the frames the
    call reads, with iis/jjs renumbered to them. Where f2's level 0 is
    f1's store, as on the main path, it stays a view of the copied f1, so
    the copy aliases as the original does and ``store_bytes`` counts the
    shared rows once."""
    import torch
    frames = torch.unique(torch.cat([iis, jjs]).long())    # sorted

    def renumber(ix):
        return torch.searchsorted(frames, ix.long()).to(ix.dtype)

    f1c = f1[frames]
    f2c = tuple(lv[frames] for lv in f2_levels)
    if f2_levels[0].data_ptr() == f1.data_ptr():
        f2c = (f1c.view(f2c[0].shape),) + f2c[1:]
    return f1c, f2c, renumber(iis), renumber(jjs), coords.clone()


class LookupProbe:
    """Wraps ``cuda_corr.lookup_pyramid`` (kernel A) from outside the
    package for one ``SLAM.run``: CUDA events around every wrapper call
    that launches, read once after the run (the time between them includes
    the wrapper's host work and any wait for the host while the card is
    idle, so it bounds the kernel's device time from above), and a compact
    copy of the inputs of the largest-E call that the frontend makes on the
    last frame (``frame`` and ``phase`` are set by the caller's step and
    phase wrappers)."""

    def __init__(self, last_frame):
        from glorie_slam_tpu_torch.ops import cuda_corr
        self.cuda_corr = cuda_corr
        self.inner = cuda_corr.lookup_pyramid
        self.last_frame = last_frame
        self.frame, self.phase = -1, None
        self.events, self.captured = [], None

    def __call__(self, f1, f2, iis, jjs, coords):
        import torch
        k = self.cuda_corr.LOOKUP_PYRAMID
        before = k.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(f1, f2, iis, jjs, coords)
        end.record()
        if k.launches > before:
            self.events.append((start, end))
        if (self.frame == self.last_frame and self.phase == "frontend"
                and (self.captured is None
                     or iis.shape[0] > self.captured[2].shape[0])):
            self.captured = compact_lookup_inputs(f1, f2, iis, jjs, coords)
        return out

    def __enter__(self):
        self.cuda_corr.lookup_pyramid = self
        return self

    def __exit__(self, *exc):
        self.cuda_corr.lookup_pyramid = self.inner

    def event_ms(self):
        """Kernel A's summed event-bracketed ms and its launches over the
        run."""
        import torch
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events), len(self.events)


def pipeline(n_frames, H=320, W=640):
    """``SLAM.run`` tracking-only at 320x640 (see the module doc)."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.ops import cuda_corr
    from glorie_slam_tpu_torch.slam import SLAM
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       bench_cfg)

    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        cfg = bench_cfg(H=H, W=W, buffer=400, out=tmp)
        cfg["tracking"]["backend"]["final_ba"] = True
        cfg["mono_prior"] = {"predict_online": False}
        priors = os.path.join(tmp, f"{cfg['scene']}_priors", "depths")
        os.makedirs(priors)
        for i, depth in enumerate(stream.depths):
            np.save(os.path.join(priors, f"{i:05d}.npy"), depth)

        slam = SLAM(cfg, stream)
        tracker, video = slam.tracker, slam.video
        times = []
        step = tracker.step

        def timed_step(i, s):
            probe.frame = i
            t0 = time.perf_counter()
            step(i, s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            print(f"[pipeline] frame {i}: {times[-1]:.3f} s, keyframes "
                  f"{video.counter}", flush=True)

        tracker.step = timed_step
        probe = LookupProbe(n_frames - 1)
        phase_ctx = tracker.timer.phase

        @contextlib.contextmanager
        def named_phase(name):
            probe.phase = name
            try:
                with phase_ctx(name):
                    yield
            finally:
                probe.phase = None

        tracker.timer.phase = named_phase
        filler = slam.traj_filler
        filler_launches = {}

        def counted_filler(s):
            before = cuda_corr.LOOKUP_PYRAMID.launches
            out = filler(s)
            filler_launches["lookup_pyramid"] = (
                cuda_corr.LOOKUP_PYRAMID.launches - before)
            return out

        slam.traj_filler = counted_filler

        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        with probe:
            slam.run()
        torch.cuda.synchronize()
        a_ms, a_launches = probe.event_ms()
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()

        out = slam.output
        saved = dict(np.load(os.path.join(out, "video.npz")))
        ates = {}
        for label in ("kf_traj", "full_traj"):
            with open(os.path.join(out, "traj",
                                   f"metrics_{label}.txt")) as f:
                first = f.readline()
            if not first.startswith("ATE-RMSE [m]: "):
                raise AssertionError(f"metrics_{label}.txt: {first!r}")
            ates[label] = float(first.split(":")[1])
        full = np.load(os.path.join(out, "traj", "full_traj_w2c.npy"))
        with open(os.path.join(out, "logs", "phase_times.json")) as f:
            phases = json.load(f)

    n = video.counter
    if n != n_frames:
        raise AssertionError(f"{n} keyframes for {n_frames} frames")
    if saved["poses"].shape != (n, 4, 4) or \
            saved["valid_depth_masks"].shape != (n, H, W):
        raise AssertionError("saved video has the wrong shapes")
    for key in ("poses", "depths", "timestamps"):
        if not np.isfinite(saved[key]).all():
            raise AssertionError(f"saved {key} are not finite")
    if full.shape != (n_frames, 7) or not np.isfinite(full).all():
        raise AssertionError("full trajectory has the wrong shape or is "
                             "not finite")
    if not all(np.isfinite(v) for v in ates.values()):
        raise AssertionError(f"ATE not finite: {ates}")
    if tracker.frontend.last_loop_t <= 0 or tracker.prev_ba_idx <= 0:
        raise AssertionError("loop closure or online BA did not run")
    for name in ("lookup_pyramid", "depth_agree"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    if filler_launches.get("lookup_pyramid", 0) <= 0:
        raise AssertionError("the trajectory filler launched no lookup")
    if a_launches != launches["lookup_pyramid"] or probe.captured is None:
        raise AssertionError("the probe missed launches of kernel A or the "
                             "last frame's frontend lookups")
    ph = phases["phases"]
    steady = times[-20:]
    return dict(
        frames=n, keyframes=n, launches=launches,
        filler_launches=filler_launches,
        keyframes_per_s=len(steady) / sum(steady),
        steady_frame_ms=[1e3 * t for t in steady],
        first_frame_s=times[0], save_video_s=ph["save_video"]["total_s"],
        final_ba_s=ph["final_ba"]["total_s"],
        trajectory_filler_s=ph["trajectory_filler"]["total_s"],
        eval_traj_s=ph["eval_traj"]["total_s"],
        kf_ate_rmse_m=ates["kf_traj"], full_ate_rmse_m=ates["full_traj"],
        loop_closure_at=tracker.frontend.last_loop_t,
        online_ba_at=tracker.prev_ba_idx,
        phases=phases, peak_memory_bytes=peak,
        valid_mask_fraction=float(saved["valid_depth_masks"].mean()),
        probe_capture_bytes=sum(t.numel() * t.element_size() for t in {
            t.data_ptr(): t for t in (probe.captured[0], *probe.captured[1],
                                      *probe.captured[2:])}.values()),
        lookup_pyramid_event_ms=a_ms,
        lookup_pyramid_event_ms_per_launch=a_ms / a_launches), probe.captured


# ---------------------------------------------------------------------------
# mapping: one train step card vs CPU, and the full-width mapping phase
# ---------------------------------------------------------------------------

def step_mapper(cfg, stream, video):
    """A ``Mapper`` over ``video`` with the SLAM attributes it reads."""
    import types
    from glorie_slam_tpu_torch.mapping.mapper import Mapper
    from glorie_slam_tpu_torch.slam import update_cam
    from glorie_slam_tpu_torch.utils.printer import Printer

    H, W, fx, fy, cx, cy = update_cam(cfg)
    shim = types.SimpleNamespace(video=video, printer=Printer(0, True),
                                 output=cfg["data"]["output"], H=H, W=W,
                                 fx=fx, fy=fy, cx=cx, cy=cy, stream=stream)
    return Mapper(shim, cfg)


def mapping_step_state(H=120, W=160, n_frames=5):
    """A CPU mapper at the Replica widths (c_dim 32, 8 neighbours, 10
    samples per ray, dynamic radii, pixel warping) over the true state of a
    120x160 synthetic stream, frames 0 and 1 anchored, and one batch of
    4096 rays over frames 0-4 (the padded bucket of 5 x 800 pixels) with a
    frustum gradient mask."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch.mapping import sampling
    from glorie_slam_tpu_torch.utils.buckets import bucket
    from glorie_slam_tpu_torch.utils.synthetic import (
        SyntheticStream, base_cfg, mapping_cfg, oracle_video)

    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=5)
    cfg = base_cfg(H=H, W=W, buffer=16, out=tempfile.gettempdir())
    cfg.update(mapping_cfg())
    cfg["mapping"].update(pretrained=None, pixels_adding=2000,
                          pixels_based_on_color_grad=400)
    cfg["pointcloud"]["capacity"] = 1 << 16
    m = step_mapper(cfg, stream, oracle_video(stream, cfg, n_frames, "cpu"))
    for k in (0, 1):
        m.dynamic_r_add, m.dynamic_r_query = sampling.dynamic_radius_maps(
            stream.frames[k], cfg)
        c2w, _, droid = m.get_c2w_and_depth(k, k, None)
        m.anchor_points(droid.numpy(), stream.frames[k], c2w, k)
    frames = []
    for k in range(n_frames):
        _, r_query = sampling.dynamic_radius_maps(stream.frames[k], cfg)
        depth = stream.depths[k]
        frames.append(dict(render_depth=depth, render_mask=depth > 0,
                           gt_color=stream.frames[k], c2w=m._c2w_nerf(k),
                           r_query=r_query / 3.0 * depth))
    c2ws = torch.as_tensor(np.stack([f["c2w"] for f in frames]))
    batch = m._ray_batch(frames, 800, c2ws, bucket(800 * n_frames))
    feat_mask = m._frustum_grad_mask(frames[-1]["c2w"],
                                     frames[-1]["render_depth"])
    imgs = torch.as_tensor(np.stack(stream.frames[:n_frames]))
    return cfg, stream, m, batch, c2ws, imgs, feat_mask


def mapping_step(m, batch, c2ws, imgs, feat_mask, stage):
    """One ``_map_train_step`` of mapper ``m`` from a fresh optimiser ->
    (losses, {name: gradient}, {name: parameter}) on the host."""
    import torch
    from glorie_slam_tpu_torch.mapping import mapper as mapper_mod

    geo, col = m.npc.geo_feats, m.npc.col_feats
    opt = mapper_mod.make_optimizer(m.decoders, geo, col)
    F = c2ws.shape[0]
    met = mapper_mod._map_train_step(
        m.decoders, m.rcfg, opt, geo, col, (0.005, 0.03, 0.005),
        m.npc.cloud_pos, m.npc.count, *batch,
        torch.ones(F, dtype=torch.bool, device=m.device), c2ws, imgs,
        feat_mask, {"geo_decoder": 0.0, "color_decoder": 1.0},
        (m.fx, m.fy, m.cx, m.cy), m.w_losses, stage, True, m.W, m.H)
    named = [("geo_feats", geo), ("col_feats", col)] + list(
        m.decoders.named_parameters())
    grads = {k: p.grad.cpu().clone() for k, p in named}
    params = {k: p.detach().cpu().clone() for k, p in named}
    mapper_mod.release(m.decoders, geo, col)
    return {k: float(v) for k, v in met.items()}, grads, params


def npc_arrays(npc):
    """A cloud's state as numpy, for ``NeuralPointCloud.load_arrays``."""
    names = ("cloud_pos", "geo_feats", "col_feats", "input_pos", "input_rgb",
             "input_depth", "input_video_idx", "input_i", "input_j",
             "full_pcl", "full_mask")
    out = {k: getattr(npc, k).cpu() for k in names}
    out["full_pcl"] = out["full_pcl"].float()
    out = {k: v.numpy() for k, v in out.items()}
    out.update(count=npc.count, count_in=npc.count_in)
    return out


def mapping_step_check(device="cuda"):
    """One mapping train step (render -> losses -> gradients -> Adam) from
    one state on the card and on the CPU (the path the tests hold against
    the JAX package), in each stage, at the tolerances
    ``tests/test_torch_mapper.py`` holds the port to against the JAX
    package, with no entry allowed outside them: losses 1e-5 relative;
    gradients per entry 1e-3 relative plus two float32 spacings of the
    parameter and 1e-3 of the tensor's largest entry; parameters after
    Adam's first step 2e-4, except where the gradient lies within 10x its
    tolerance of zero, where the sign is rounding and the step may land
    anywhere within twice the learning rate. The renderer's kNN must pick
    the same neighbours on both devices (``knn_flips``): anchors are sampled
    with replacement, so copies of a point tie exactly in distance, and
    both devices list them lowest index first."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch.utils.synthetic import oracle_video

    cfg, stream, cpu_m, batch, c2ws, imgs, feat_mask = mapping_step_state()
    dev = torch.device(device)
    gpu_m = step_mapper(cfg, stream, oracle_video(stream, cfg, c2ws.shape[0],
                                                  dev))
    lrs = {"geo_feats": 0.03, "col_feats": 0.005}       # decoders: 0.005
    res = {"count": cpu_m.npc.count, "rays": int(batch[0].shape[0])}
    for stage in ("geometry", "color"):
        gpu_m.npc.load_arrays(npc_arrays(cpu_m.npc))
        gpu_m.decoders.load_state_dict(cpu_m.decoders.state_dict())
        snapshot = ({k: v.clone() for k, v in cpu_m.decoders.state_dict()
                     .items()}, cpu_m.npc.geo_feats.clone(),
                    cpu_m.npc.col_feats.clone())
        before = {"geo_feats": snapshot[1], "col_feats": snapshot[2],
                  **snapshot[0]}
        out_g = mapping_step(gpu_m, [x.to(dev) for x in batch], c2ws.to(dev),
                             imgs.to(dev), feat_mask.to(dev), stage)
        torch.cuda.synchronize()
        out_c = mapping_step(cpu_m, batch, c2ws, imgs, feat_mask, stage)
        # restore the CPU state for the next stage
        cpu_m.decoders.load_state_dict(snapshot[0])
        cpu_m.npc.geo_feats.copy_(snapshot[1])
        cpu_m.npc.col_feats.copy_(snapshot[2])
        loss_rel = max(abs(out_g[0][k] - out_c[0][k])
                       / max(abs(out_c[0][k]), 1e-12)
                       for k in ("geo_loss", "color_loss", "warp_loss"))
        if loss_rel > 1e-5 or out_c[0]["warp_loss"] <= 0:
            raise AssertionError(f"mapping step losses ({stage}): card "
                                 f"{out_g[0]}, CPU {out_c[0]}")
        stats = {}
        for k, g_c in out_c[1].items():
            g_c, g_g = g_c.numpy(), out_g[1][k].numpy()
            p0 = before[k].numpy()
            tol = 2 * np.spacing(np.abs(p0)) + 1e-3 * np.abs(g_c).max()
            bad_g = np.abs(g_g - g_c) > tol + 1e-3 * np.abs(g_c)
            near0 = np.abs(g_c) < 10 * tol
            dp = np.abs(out_g[2][k].numpy() - out_c[2][k].numpy())
            bad_p = np.where(near0, dp > 2 * lrs.get(k, 0.005) + 2e-4,
                             dp > 2e-4)
            stats[k] = (int(bad_g.sum()), int(bad_p.sum()),
                        int((g_c != 0).sum()))
        off = sum(b + c for b, c, _ in stats.values())
        live = sum(nz for _, _, nz in stats.values())
        flips = knn_flips(cpu_m, batch, dev)
        res[stage] = dict(losses_card=out_g[0], losses_cpu=out_c[0],
                          max_loss_rel=loss_rel, entries_off=off,
                          live_entries=live, knn_probes=flips)
        if off or flips["neighbour_lists"] or flips["radius_counts"]:
            raise AssertionError(f"mapping step ({stage}): {res[stage]}, "
                                 f"per tensor (grads off, params off, live):"
                                 f" {stats}")
    res["tolerance"] = (
        "losses 1e-5 rel; every entry: gradients 1e-3 rel + 2 spacings of "
        "the parameter + 1e-3 max, parameters 2e-4 (near-zero gradients: "
        "within 2 lr); kNN neighbour lists equal")
    return res


def knn_flips(m, batch, dev):
    """The renderer's first kNN (the 25 near-cloud probes of every ray) on
    the card and on the CPU: the rows whose neighbour list or radius count
    differs, and the largest distance difference."""
    import torch
    from glorie_slam_tpu_torch.mapping.point_cloud import linspace
    from glorie_slam_tpu_torch.ops import knn

    rays_o, rays_d, depth = batch[0], batch[1], batch[2]
    far = torch.minimum(5 * torch.mean(depth), torch.max(depth * 1.2))
    z = linspace(m.rcfg.near_end, far, 25)
    pts = (rays_o[:, None] + rays_d[:, None] * z[None, :, None]).reshape(-1, 3)
    out = []
    for d in (dev, torch.device("cpu")):
        D, I = knn.knn_search(pts.to(d), m.npc.cloud_pos.to(d), m.npc.count)
        nn = knn.neighbor_count(D, m.rcfg.radius_query)
        out.append((D.cpu(), I.cpu(), nn.cpu()))
    (Dg, Ig, ng), (Dc, Ic, nc) = out
    return {"rows": int(pts.shape[0]),
            "neighbour_lists": int((Ig != Ic).any(1).sum()),
            "radius_counts": int((ng != nc).sum()),
            "max_distance_diff": float((Dg - Dc).abs().max())}


class MapProbe:
    """Wraps ``mapper._map_train_step`` and ``knn.knn_search`` from outside
    the package for one run: CUDA events around every call (recorded on the
    calling thread's stream, so the asynchronous worker's stream when it
    maps), the kNN calls split into those inside a train step, those inside
    the end-of-run evaluations (``local.in_eval``, set by the caller) and
    the rest; and each mapped keyframe's wall time (its ``on_keyframe``
    call, ended with a synchronize of its stream)."""

    def __init__(self, mapper):
        import threading
        from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
        from glorie_slam_tpu_torch.ops import knn as knn_mod
        self.mods = (mapper_mod, knn_mod)
        self.inner = (mapper_mod._map_train_step, knn_mod.knn_search)
        self.mapper, self.inner_kf = mapper, mapper.on_keyframe
        self.local = threading.local()
        self.steps, self.knn_in, self.knn_out, self.kf_s = [], [], [], []
        self.knn_eval = []

    def _timed(self, fn, sink, *a, **kw):
        import torch
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = fn(*a, **kw)
        e.record()
        sink.append((s, e))
        return out

    def step(self, *a, **kw):
        self.local.in_step = True
        try:
            return self._timed(self.inner[0], self.steps, *a, **kw)
        finally:
            self.local.in_step = False

    def knn(self, *a, **kw):
        sink = (self.knn_in if getattr(self.local, "in_step", False)
                else self.knn_eval if getattr(self.local, "in_eval", False)
                else self.knn_out)
        return self._timed(self.inner[1], sink, *a, **kw)

    def on_keyframe(self, info):
        import torch
        t0 = time.perf_counter()
        self.inner_kf(info)
        torch.cuda.current_stream().synchronize()
        if not info.get("end"):
            self.kf_s.append(time.perf_counter() - t0)

    def __enter__(self):
        self.mods[0]._map_train_step = self.step
        self.mods[1].knn_search = self.knn
        self.mapper.on_keyframe = self.on_keyframe
        return self

    def __exit__(self, *exc):
        self.mods[0]._map_train_step, self.mods[1].knn_search = self.inner
        self.mapper.on_keyframe = self.inner_kf

    @staticmethod
    def ms(events):
        return [s.elapsed_time(e) for s, e in events]


EVAL_FILES = ("logs/metrics_render_kf.txt", "logs/metrics_render_full.txt",
              "logs/metrics_recon.txt", "mesh/rendered_mesh_kf.ply")
EVAL_PHASES = ("eval_kf_imgs", "generate_mesh_kf", "eval_imgs",
               "eval_recon")


def write_plane_mesh(out_dir, stream):
    """The synthetic scene's ground truth as an ASCII PLY: the part of the
    plane z = ``PLANE_Z`` that ``stream``'s frames see (the rectangle
    spanned by their corner pixels), as one quad of two triangles."""
    import numpy as np
    from glorie_slam_tpu_torch.mapping import mesher
    from glorie_slam_tpu_torch.utils.synthetic import PLANE_Z

    fx, fy, cx, cy = (float(v) for v in stream.intrinsics)
    H, W = stream.H, stream.W
    corners = []
    for depth, c2w in zip(stream.depths, stream.poses):
        for v, u in ((0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)):
            z = float(depth[v, u])
            p = np.array([(u - cx) / fx * z, (v - cy) / fy * z, z])
            corners.append(c2w[:3, :3] @ p + c2w[:3, 3])
    lo, hi = np.min(corners, 0), np.max(corners, 0)
    path = os.path.join(out_dir, "plane_gt.ply")
    mesher.write_ply_mesh(path, np.array(
        [[lo[0], lo[1], PLANE_Z], [hi[0], lo[1], PLANE_Z],
         [hi[0], hi[1], PLANE_Z], [lo[0], hi[1], PLANE_Z]]),
        np.array([[0, 1, 2], [0, 2, 3]]))
    return path


def read_evaluation(out):
    """A run's evaluation files -> (metrics by file, the mesh's element
    counts). Raises when one is missing; the reconstruction metrics are
    required when the mesh has faces (``SLAM.evaluate`` scores no empty
    mesh)."""
    path = os.path.join(out, EVAL_FILES[3])
    if not os.path.exists(path):
        raise AssertionError(f"evaluation file missing: {EVAL_FILES[3]}")
    mesh = {}
    with open(path) as f:
        for words in map(str.split, f):
            if words[0] == "end_header":
                break
            if words[0] == "element":
                mesh[words[1]] = int(words[2])
    names = EVAL_FILES[:3] if mesh.get("face") else EVAL_FILES[:2]
    missing = [n for n in names if not os.path.exists(os.path.join(out, n))]
    if missing:
        raise AssertionError(f"evaluation files missing: {missing}, mesh "
                             f"{mesh}")
    metrics = {}
    for name in names:
        with open(os.path.join(out, name)) as f:
            metrics[os.path.basename(name)] = dict(
                line.rstrip("\n").split(": ", 1) for line in f)
    return metrics, mesh


def oracle_evaluation(n_frames=ORACLE_FRAMES, keyframes=ORACLE_KEYFRAMES,
                      H=320, W=640,
                      device="cuda"):
    """``SLAM.evaluate`` (the four evaluations, each in its phase) on a
    mapper over the true poses and depths of a 320x640 circuit stream
    (``oracle_video``) at the Replica widths, with ``keyframes`` mapped
    through ``Mapper.on_keyframe`` (``MAPPING_CUTS``), the true trajectory
    as ``video.npz`` and ``traj/full_traj_w2c.npy``, and the plane's
    ground-truth mesh: the renders, the mesh and the reconstruction
    metrics on a state where they mean something (random-weight tracking
    gives the mapping phase depths far off the plane, see ``fused``)."""
    import types

    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch import slam as slam_mod
    from glorie_slam_tpu_torch.mapping.mapper import Mapper
    from glorie_slam_tpu_torch.utils.phase_timer import PhaseTimer
    from glorie_slam_tpu_torch.utils.printer import Printer
    from glorie_slam_tpu_torch.utils.synthetic import (
        SyntheticStream, bench_cfg, mapping_cfg, oracle_video)

    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        cfg = bench_cfg(H=H, W=W, buffer=n_frames + 4, out=tmp)
        cfg.update(mapping_cfg())
        cfg["only_tracking"] = False
        cfg["mapping"].update(MAPPING_CUTS)
        cfg["meshing"] = {"gt_mesh_path": write_plane_mesh(tmp, stream)}
        priors = os.path.join(tmp, f"{cfg['scene']}_priors", "depths")
        os.makedirs(priors)
        for i, depth in enumerate(stream.depths):
            np.save(os.path.join(priors, f"{i:05d}.npy"), depth)
        out = f"{tmp}/{cfg['setting']}/{cfg['scene']}"
        for d in ("logs", "traj"):
            os.makedirs(os.path.join(out, d))
        np.savez(os.path.join(out, "video.npz"), poses=np.stack(stream.poses),
                 timestamps=np.arange(n_frames, dtype=np.float32))
        np.save(os.path.join(out, "traj", "full_traj_w2c.npy"),
                stream.poses_w2c)
        H_, W_, fx, fy, cx, cy = slam_mod.update_cam(cfg)
        run = types.SimpleNamespace(
            video=oracle_video(stream, cfg, n_frames, device),
            printer=Printer(0, True), output=out, H=H_, W=W_, fx=fx, fy=fy,
            cx=cx, cy=cy, stream=stream, cfg=cfg, timer=PhaseTimer(sync=True),
            device=torch.device(device))
        run.mapper = Mapper(run, cfg)
        t0 = time.perf_counter()
        for k in keyframes:
            run.mapper.on_keyframe({"is_keyframe": True, "video_idx": k,
                                    "timestamp": k, "end": False})
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        slam_mod.SLAM.evaluate(run)
        metrics, mesh = read_evaluation(out)
        phases = run.timer.summary()
    if len(run.mapper.keyframe_dict) != len(keyframes) or not mesh.get(
            "face") or "metrics_recon.txt" not in metrics:
        raise AssertionError(f"oracle evaluation: {len(run.mapper.keyframe_dict)}"
                             f" keyframes mapped, mesh {mesh}, {list(metrics)}")
    recon = {k: float(v) for k, v in metrics["metrics_recon.txt"].items()}
    if not all(np.isfinite(v) for k, v in recon.items()
               if not k.startswith("normal")):
        raise AssertionError(f"reconstruction metrics not finite: {recon}")
    return dict(frames=n_frames, keyframes=list(keyframes), map_s=map_s,
                metrics=metrics, mesh=mesh,
                eval_s={k: phases[k]["total_s"] for k in EVAL_PHASES})


def eval_modules_check(H=320, W=640, device="cuda"):
    """TSDF integration of one synthetic frame (its true depth and colour,
    the volume ``generate_mesh_kf`` would bound it with, voxel 0.01) and
    LPIPS of the frame against a noisy copy, on the card and on the CPU.
    The TSDF's voxel centres and transform are float64 on both, so the
    volumes agree to float32 rounding (1e-5) except where a voxel's pixel
    rounds the other way (at most 1e-4 of the voxels); LPIPS to 1e-4
    relative (float32 convolutions summed in another order)."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch.mapping import mesher
    from glorie_slam_tpu_torch.utils import image_metrics
    from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream

    stream = SyntheticStream(n_frames=1, H=H, W=W, seed=3)
    depth, color, c2w = stream.depths[0], stream.frames[0], stream.poses[0]
    fx, fy, cx, cy = (float(v) for v in stream.intrinsics)
    v, u = np.nonzero(depth > 0)
    z = depth[v, u]
    pts = (np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
           @ c2w[:3, :3].T + c2w[:3, 3])
    vols = {}
    for dev in ("cpu", device):
        vol = mesher.TSDFVolume(pts.min(0) - 0.1, pts.max(0) + 0.1,
                                voxel_size=0.01, device=dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol.integrate(depth, color, (fx, fy, cx, cy), c2w)
        if dev != "cpu":
            torch.cuda.synchronize()
        vols[dev] = (vol, time.perf_counter() - t0)
    (cvol, cpu_s), (gvol, card_s) = vols["cpu"], vols[device]
    off = {}
    for name in ("tsdf", "weight", "color"):
        d = np.abs(getattr(gvol, name) - getattr(cvol, name))
        off[name] = float((d > 1e-5).mean())
    lp_cpu, lp = image_metrics.LPIPS(), image_metrics.LPIPS().to(device)
    noisy = np.clip(color + np.random.default_rng(0).normal(
        0, 0.05, color.shape), 0, 1).astype(np.float32)
    l_cpu, l_card = float(lp_cpu(color, noisy)), float(lp(color, noisy))
    lp_rel = abs(l_card - l_cpu) / abs(l_cpu)
    if max(off.values()) > 1e-4 or not lp_rel <= 1e-4:
        raise AssertionError(f"TSDF voxels off {off}, LPIPS rel {lp_rel}")
    return dict(voxels=int(np.prod(gvol.dims)), dims=gvol.dims.tolist(),
                observed=float((cvol.weight > 0).mean()),
                voxels_off=off, integrate_s_card=card_s,
                integrate_s_cpu=cpu_s, lpips_card=l_card, lpips_cpu=l_cpu,
                lpips_rel=lp_rel, lpips_variant=lp.variant)


def mapping_phase(n_frames, H=320, W=640, device="cuda"):
    """``SLAM.run`` with mapping at 320x640 (see ``MAPPING_CUTS``)."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.ops import knn
    from glorie_slam_tpu_torch.slam import SLAM
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       bench_cfg, mapping_cfg)

    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        cfg = bench_cfg(H=H, W=W, buffer=400, out=tmp)
        cfg.update(mapping_cfg())
        cfg["only_tracking"] = False
        cfg["mapping"].update(MAPPING_CUTS)
        cfg["mono_prior"] = {"predict_online": False}
        priors = os.path.join(tmp, f"{cfg['scene']}_priors", "depths")
        os.makedirs(priors)
        for i, depth in enumerate(stream.depths):
            np.save(os.path.join(priors, f"{i:05d}.npy"), depth)

        cfg["meshing"] = {"gt_mesh_path": write_plane_mesh(tmp, stream)}

        slam = SLAM(cfg, stream, device=device)
        if slam.async_mapper is None or (slam.async_mapper.stream is None
                                         and device == "cuda"):
            raise AssertionError("the mapper is not on its worker stream")
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with MapProbe(slam.mapper) as probe:
            evaluate = slam.evaluate

            def probed_evaluate():
                probe.local.in_eval = True
                try:
                    evaluate()
                finally:
                    probe.local.in_eval = False

            slam.evaluate = probed_evaluate
            slam.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _launches()
        out = slam.output
        with open(os.path.join(out, "traj", "metrics_kf_traj.txt")) as f:
            kf_traj = dict(line.rstrip("\n").split(": ", 1) for line in f)
        dump_dir = os.path.join(out, "rendered_every_keyframe")
        dumps = [np.load(os.path.join(dump_dir, f))
                 for f in sorted(os.listdir(dump_dir)) if "depth" in f]
        scale = float(kf_traj["scale"])
        seen = np.concatenate([d[d > 0] for d in dumps]) * scale
        # the TSDF bounds take every depth; it integrates those under 8 m
        fused = dict(
            sim3_scale=scale, depth_dumps=len(dumps),
            scaled_depth_median=float(np.median(seen)),
            scaled_depth_max=float(seen.max()),
            share_past_8m=float((seen >= 8.0).mean()))
        try:
            metrics, mesh_counts = read_evaluation(out)
        except AssertionError as e:
            raise AssertionError(f"{e}; {fused}; keyframe ATE {kf_traj}")
        files = {f: os.path.getsize(os.path.join(out, f)) for f in (
            "final_point_cloud.npy", "npc_cloud.npy", "final_point_cloud.ply",
            "video.npz", *EVAL_FILES) if os.path.exists(os.path.join(out, f))}
        cloud = np.load(os.path.join(out, "final_point_cloud.npy"))
        with open(os.path.join(out, "logs", "phase_times.json")) as f:
            phases = json.load(f)["phases"]
    mapper, stats = slam.mapper, slam.async_mapper.stats
    steps = MapProbe.ms(probe.steps)
    knn_in, knn_out = MapProbe.ms(probe.knn_in), MapProbe.ms(probe.knn_out)
    knn_eval = MapProbe.ms(probe.knn_eval)
    hist = mapper.loss_history
    first_kf = [h for h in hist if h["idx"] == hist[0]["idx"]
                and not h["refine"]]
    if len(first_kf) < 2 or not first_kf[-1]["geo"] < first_kf[0]["geo"]:
        raise AssertionError(f"geo loss did not fall over the first "
                             f"keyframe's optimisation: {first_kf}")
    if not any(h["refine"] for h in hist):
        raise AssertionError("final_refine ran no optimisation step")
    if stats["mapped"] < 4 or len(mapper.keyframe_dict) < 2:
        raise AssertionError(f"too few keyframes mapped: {stats}")
    if cloud.shape != (mapper.npc.count_in, 6) or not np.isfinite(cloud).all():
        raise AssertionError("final point cloud has the wrong shape or is "
                             "not finite")
    feats = mapper.npc.geo_feats[:mapper.npc.count]
    if not bool(torch.isfinite(feats).all()):
        raise AssertionError("non-finite features")
    for name in ("lookup_pyramid", "depth_agree", knn.KNN.name):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched while "
                                 "mapping")
    return dict(
        frames=n_frames, keyframes=slam.video.counter, cuts=MAPPING_CUTS,
        multiview_thresh=cfg["tracking"]["multiview_filter"]["thresh"],
        mapped_keyframes=stats["mapped"],
        mapped_in_keyframe_dict=len(mapper.keyframe_dict),
        mapper_s_per_keyframe=[round(x, 4) for x in probe.kf_s],
        mapper_mean_s_per_keyframe=float(np.mean(probe.kf_s)),
        worker_busy_s=stats["busy_s"], tracker_block_s=stats["block_s"],
        mean_lag_s=float(np.mean(stats["lag_s"])),
        train_steps=len(steps), train_step_mean_ms=float(np.mean(steps)),
        train_step_total_s=sum(steps) / 1e3,
        knn_in_steps_ms=sum(knn_in), knn_calls_in_steps=len(knn_in),
        knn_share_of_steps=sum(knn_in) / sum(steps),
        knn_outside_steps_ms=sum(knn_out), knn_calls_outside=len(knn_out),
        anchors=mapper.npc.count_in, points=mapper.npc.count,
        final_refine_s=phases["final_refine"]["total_s"],
        mapper_phase_s=phases["mapper"]["total_s"],
        frontend_s=phases["frontend"]["total_s"], run_wall_s=wall,
        peak_memory_bytes=peak, launches=launches,
        loss_first=hist[0], loss_last=hist[-1],
        first_keyframe_geo=[first_kf[0]["geo"], first_kf[-1]["geo"]],
        files=files, metrics=metrics, mesh=mesh_counts, fused=fused,
        lpips_variant=metrics["metrics_render_kf.txt"]["lpips_variant"],
        eval_s={k: phases[k]["total_s"] for k in EVAL_PHASES if k in phases},
        knn_in_evaluations_ms=sum(knn_eval),
        knn_calls_in_evaluations=len(knn_eval))


# ---------------------------------------------------------------------------
# the online mono prior: the omnidata DPT at full width, card vs CPU
# ---------------------------------------------------------------------------

DPT_TAPS = ("hook0", "hook1", "t_hook0", "t_hook1", "refinenet1", "pre_relu")
DPT_TOL = 1e-3          # rel-L2, card vs CPU, float32 (TF32 off)


def rel_l2(a, b):
    import torch
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(
        min=1e-30))


def dpt_work(model, x):
    """One forward of ``model`` on ``x`` under forward hooks -> (taps,
    operations by part, bytes). Operations: 2 per multiply-add of every
    convolution, linear layer and attention product (norms, activations
    and resampling add well under 1%); parts: the ResNet backbone, the ViT
    (patch embedding and blocks), the reassembly (readouts, projections and
    the scratch ``layer*_rn`` convs) and the fusion blocks with the head.
    Bytes: every parameter, the input and the output, each once."""
    import torch
    import torch.nn as nn
    from glorie_slam_tpu_torch.mapping import dpt

    ops = {"backbone": 0, "vit": 0, "reassemble": 0, "fusion_head": 0}

    def part(name):
        if name.startswith("pretrained.model.patch_embed.backbone"):
            return "backbone"
        if name.startswith("pretrained.model"):
            return "vit"
        if name.startswith("pretrained.act") or "_rn" in name:
            return "reassemble"
        return "fusion_head"

    def hook(name):
        def count(m, inp, out):
            if isinstance(m, dpt.Attention):
                B, N, D = inp[0].shape
                ops[part(name)] += 4 * B * N * N * D
            elif isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                ops[part(name)] += (2 * out.numel() * kh * kw
                                    * m.in_channels // m.groups)
            else:
                ops[part(name)] += 2 * out.numel() * m.in_features
        return count

    handles = [m.register_forward_hook(hook(name))
               for name, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, nn.Linear, dpt.Attention))]
    try:
        with torch.no_grad():
            taps = model.taps(x)
    finally:
        for h in handles:
            h.remove()
    nbytes = (sum(p.numel() * p.element_size() for p in model.parameters())
              + x.numel() * 4 + taps["depth"].numel() * 4)
    return taps, ops, nbytes


def event_ms(fn, iters, warmup=2):
    """Each of ``iters`` calls of ``fn`` bracketed by CUDA events ->
    (times in ms, the last output)."""
    import torch
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(iters):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return times, out


def mono_prior_check(size=512, H=320, W=640, iters=10, device="cuda",
                     dpt_kw=None):
    """The DPT as the omnidata checkpoint defines it (768 dims, 12 blocks,
    12 heads, 256 features) at ``size`` x ``size``, random weights (seed
    0), on the card and on the CPU: the taps (``DPT_TAPS``) of one frame
    against each other (rel-L2 <= ``DPT_TOL``), ``MonoDepthEstimator.
    predict`` of a 320x640 frame likewise, the share of depths inside
    (0, 1), the per-frame time (median of ``iters`` calls, CUDA events),
    the peak memory, and the bound from the forward's operations and
    bytes. ``dpt_kw`` shrinks the model for a CPU rehearsal."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.mapping import mono_prior
    from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream

    if dpt_kw:
        import functools
        inner = mono_prior.DPTDepthModel
        mono_prior.DPTDepthModel = functools.partial(inner, **dpt_kw)
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
            cfg = {"mono_prior": {"depth": "omnidata"}, "scene": "synth",
                   "data": {"output": tmp}}
            t0 = time.perf_counter()
            est_cpu = mono_prior.MonoDepthEstimator(cfg, size, device="cpu")
            est = mono_prior.MonoDepthEstimator(cfg, size, device=device)
            build_s = time.perf_counter() - t0
    finally:
        if dpt_kw:
            mono_prior.DPTDepthModel = inner
    frame = SyntheticStream(n_frames=1, H=H, W=W, seed=3).frames[0]
    x = mono_prior.resize(torch.as_tensor(frame).permute(2, 0, 1),
                          (size, size), "bilinear")[None]
    x = (x - 0.5) / 0.5
    t0 = time.perf_counter()
    ref, ops, nbytes = dpt_work(est_cpu.model, x)
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        got = est.model.taps(x.to(device))
    errs = {k: rel_l2(got[k], ref[k]) for k in DPT_TAPS}
    d = ref["pre_relu"].clamp(0.0, 1.0)
    inside = float(((d > 0) & (d < 1)).float().mean())
    pred_ref = est_cpu.predict(frame)
    img = torch.as_tensor(frame, device=device)
    torch.cuda.reset_peak_memory_stats()
    times, pred = event_ms(lambda: est.predict(img), iters)
    peak = torch.cuda.max_memory_allocated()
    xd = x.to(device)
    with torch.no_grad():
        fwd_times, _ = event_ms(lambda: est.model(xd), iters)
    pred_err = rel_l2(pred, pred_ref)
    pred_inside = float(((pred_ref > 0) & (pred_ref < 1)).float().mean())
    flops = sum(ops.values())
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOPS)
    for k, e in [*errs.items(), ("predict", pred_err)]:
        if not e <= DPT_TOL:
            raise AssertionError(f"DPT {k}: card vs CPU rel-L2 {e:.3g} > "
                                 f"{DPT_TOL}")
    if pred.shape != (H, W) or not bool(torch.isfinite(pred).all()):
        raise AssertionError("DPT prior has the wrong shape or is not "
                             "finite")
    return dict(
        size=size, frame=[H, W], params=sum(
            p.numel() for p in est.model.parameters()),
        rel_l2_card_vs_cpu=errs, predict_rel_l2=pred_err,
        tolerance=DPT_TOL, depth_inside_0_1=inside,
        prior_inside_0_1=pred_inside,
        predict_ms_median=float(np.median(times)), predict_ms=times,
        forward_ms_median=float(np.median(fwd_times)),
        gflop=flops / 1e9, gflop_by_part={k: v / 1e9 for k, v in ops.items()},
        weight_and_io_mb=nbytes / 1e6, bound_ms=bound_ms, bound_by=bound_by,
        peak_memory_bytes=peak, build_s=build_s, cpu_forward_s=cpu_s)


def online_prior_run(n_frames=20, H=320, W=640, every_frame=5,
                     device="cuda", dpt_kw=None, infer_size=512):
    """``SLAM(cfg, stream).run()`` tracking-only with bench.py's tracking
    config and ``mono_prior.predict_online``: the DPT predicts every
    ``every_frame``-th frame and every admitted frame, once each; its
    calls against that rule, its ``.npy`` files, its summed time (CUDA
    events around ``predict``), and a second ``SLAM`` with
    ``predict_online: False`` reading the same priors from the cache."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch import slam as slam_mod
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       bench_cfg)

    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    make = slam_mod.MonoDepthEstimator
    if dpt_kw:
        import functools
        from glorie_slam_tpu_torch.mapping import mono_prior
        inner = mono_prior.DPTDepthModel
        mono_prior.DPTDepthModel = functools.partial(inner, **dpt_kw)
    slam_mod.MonoDepthEstimator = lambda cfg, **kw: make(cfg, infer_size,
                                                         **kw)
    try:
        with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
            cfg = bench_cfg(H=H, W=W, buffer=400, out=tmp)
            cfg["mono_prior"] = {"depth": "omnidata", "predict_online": True}
            cfg["mapping"] = {"every_frame": every_frame}
            slam = slam_mod.SLAM(cfg, stream, device=device)
            est, mf = slam.mono_estimator, slam.tracker.motion_filter
            calls, admitted, dpt_events, priors = [], [], [], {}
            predict, predictor, admit = (est.predict, mf.mono_predictor,
                                         mf._admit)

            def timed_predict(image):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = predict(image)
                e.record()
                dpt_events.append((s, e))
                return out

            def recorded(tstamp, image):
                calls.append(int(tstamp))
                out = predictor(tstamp, image)
                priors[int(tstamp)] = torch.as_tensor(out).cpu()
                return out

            def recorded_admit(tstamp, *a, **kw):
                admitted.append(int(tstamp))
                return admit(tstamp, *a, **kw)

            est.predict, mf.mono_predictor = timed_predict, recorded
            mf._admit = recorded_admit
            _zero_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            slam.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            peak = torch.cuda.max_memory_allocated()
            files = sorted(os.listdir(est.out_dir))
            with open(os.path.join(slam.output, "logs",
                                   "phase_times.json")) as f:
                phases = json.load(f)["phases"]
            cfg["mono_prior"]["predict_online"] = False
            cached = slam_mod.SLAM(cfg, stream, device=device)
            load = cached.tracker.motion_filter.mono_predictor
            cache_equal = all(np.array_equal(load(t, None), p.numpy())
                              for t, p in priors.items())
    finally:
        slam_mod.MonoDepthEstimator = make
        if dpt_kw:
            mono_prior.DPTDepthModel = inner
    cadence = [t for t in range(n_frames) if t % every_frame == 0]
    expected = sorted(set(cadence) | set(admitted))
    dpt_ms = [s.elapsed_time(e) for s, e in dpt_events]
    if sorted(calls) != expected or len(dpt_ms) != len(expected):
        raise AssertionError(f"DPT calls {calls} ({len(dpt_ms)} predicted) "
                             f"against cadence {cadence} and admissions "
                             f"{admitted}")
    if files != [f"{t:05d}.npy" for t in expected] or not cache_equal:
        raise AssertionError(f"prior cache {files} does not hold the "
                             "predictions")
    for name in ("lookup_pyramid", "depth_agree"):
        if device == "cuda" and launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched")
    return dict(
        frames=n_frames, every_frame=every_frame, infer_size=infer_size,
        keyframes=slam.video.counter, admitted=len(admitted),
        dpt_calls=len(dpt_ms), cadence_frames=cadence,
        npy_files=len(files), cache_read_back_equal=cache_equal,
        dpt_ms_total=sum(dpt_ms), dpt_ms_median=float(np.median(dpt_ms)),
        run_wall_s=wall, dpt_share_of_run=sum(dpt_ms) / 1e3 / wall,
        motion_filter_s=phases["motion_filter"]["total_s"],
        frontend_s=phases["frontend"]["total_s"], launches=launches,
        peak_memory_bytes=peak)


ENTRY_FRAMES = 20
ENTRY_CHECKPOINT_EVERY = 5
ENTRY_BUFFER = 100
SEVEN_SCENES_K = (532.57, 531.54, 319.5, 239.5)   # configs/7scenes/7scenes.yaml
# an 8x8 baseline JPEG (OpenCV, quality 50): the colour frame of the
# Replica-layout probe
TINY_JPEG = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDABALDA4MChAODQ4SERATGCgaGBYWGDEjJR0oOjM9"
    "PDkzODdASFxOQERXRTc4UG1RV19iZ2hnPk1xeXBkeFxlZ2P/2wBDARESEhgVGC8aGi9jQjhC"
    "Y2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2P/wAAR"
    "CAAIAAgDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA"
    "AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK"
    "FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE"
    "hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwCIW1oh8qC3023mRiHE90HxjqMDbg5ooopD"
    "P//Z")
ENTRY_SCENE = """\
inherit_from: {root}/configs/7scenes/7scenes.yaml
scene: synth
setting: smoke
tracking:
  buffer: {buffer}
  checkpoint_every: {every}
  motion_filter:
    thresh: 0.0
  frontend:
    keyframe_thresh: 0.0
data:
  input_folder: {data}
  output: {out}
"""


def run_cli(args, log):
    """``python -m glorie_slam_tpu_torch.cli <args>`` from the checkout, its
    output to ``log``; raises on a non-zero exit. Returns its wall s."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "glorie_slam_tpu_torch.cli", *args],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
            timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"CLI {args} exited {proc.returncode}:\n{tail}")
    return wall


def jpeg_probe(tmp):
    """A Replica-layout scene of one 8x8 JPEG frame: reading it decodes
    through cv2, or raises the ImportError that names cv2 where it is not
    installed."""
    import base64

    import numpy as np
    from glorie_slam_tpu_torch.utils import datasets

    root = os.path.join(tmp, "replica")
    os.makedirs(os.path.join(root, "results"))
    with open(os.path.join(root, "results", "frame000000.jpg"), "wb") as f:
        f.write(base64.b64decode(TINY_JPEG))
    np.savetxt(os.path.join(root, "traj.txt"), np.eye(4).reshape(1, 16))
    cam = {"H": 8, "W": 8, "fx": 8.0, "fy": 8.0, "cx": 3.5, "cy": 3.5,
           "H_out": 8, "W_out": 8, "H_edge": 0, "W_edge": 0,
           "png_depth_scale": 1000.0}
    ds = datasets.get_dataset({"dataset": "replica", "cam": cam, "stride": 1,
                               "max_frames": -1,
                               "data": {"input_folder": root}})
    try:
        color = ds.get_color(0)
    except ImportError as e:
        if "cv2" not in str(e):
            raise
        return {"jpeg": "ImportError", "message": str(e)}
    if color.shape != (8, 8, 3) or not np.isfinite(color).all():
        raise AssertionError("JPEG decoded to a wrong frame")
    return {"jpeg": "decoded with cv2"}


def entry_point_phase(n_frames=ENTRY_FRAMES, every=ENTRY_CHECKPOINT_EVERY,
                      H=480, W=640, device="cuda", scene_extra=""):
    """The CLI on a 7-Scenes-layout scene written here (the synthetic
    circuit rendered at 7-Scenes' 480x640 and its camera, PNG colour and
    16-bit depth in millimetres, pose files) with a scene YAML that inherits
    from ``configs/7scenes/7scenes.yaml`` (384x512 after resize and crop,
    buffer ``ENTRY_BUFFER``, DBA, the online omnidata DPT at full width with random
    weights); cuts: every frame admitted and kept (random weights give no
    meaningful flow), a checkpoint every ``every`` keyframes. Then a second
    CLI run resumed from the mid-run checkpoint, held against the first;
    the checkpoint loaded into a ``SLAM`` here and saved again, equal array
    for array; frame read times; the JPEG probe."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.slam import SLAM
    import yaml
    from glorie_slam_tpu_torch.utils import datasets
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       write_7scenes)

    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        intr = [k * W / 640 for k in SEVEN_SCENES_K]
        stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=3,
                                 motion_scale=0.02, trajectory="circuit",
                                 intrinsics=intr)
        t0 = time.perf_counter()
        write_7scenes(os.path.join(tmp, "data"), stream)
        write_s = time.perf_counter() - t0
        scene = os.path.join(tmp, "synth.yaml")
        with open(scene, "w") as f:
            f.write(ENTRY_SCENE.format(root=ROOT, every=every,
                                       buffer=ENTRY_BUFFER,
                                       data=os.path.join(tmp, "data"),
                                       out=os.path.join(tmp, "out"))
                    + scene_extra)
        out = os.path.join(tmp, "out", "smoke", "synth")
        args = [scene, "--only_tracking", "--max_frames", str(n_frames)]
        if device != "cuda":
            args += ["--device", device]
        first_s = run_cli(args, os.path.join(tmp, "first.log"))
        for f in ("cfg.yaml", "video.npz", "traj/metrics_kf_traj.txt",
                  "traj/full_traj_w2c.npy", "logs/phase_times.json",
                  "state.npz"):
            if not os.path.exists(os.path.join(out, f)):
                raise AssertionError(f"the CLI run wrote no {f}")
        with open(os.path.join(out, "logs", "phase_times.json")) as f:
            times = json.load(f)
        launches = times["kernel_launches"]
        priors = os.path.join(tmp, "out", "synth_priors", "depths")
        dpt_calls = len(os.listdir(priors)) if os.path.isdir(priors) else 0
        state = os.path.join(tmp, "state_mid.npz")
        os.replace(os.path.join(out, "state.npz"), state)
        first = dict(np.load(os.path.join(out, "video.npz")))
        ckpt_meta = json.loads(np.load(state)["__meta__"].tobytes())

        resume_s = run_cli(args + ["--resume", state],
                           os.path.join(tmp, "resume.log"))
        second = dict(np.load(os.path.join(out, "video.npz")))
        with open(os.path.join(out, "logs", "phase_times.json")) as f:
            resume_times = json.load(f)
        resume_launches = resume_times["kernel_launches"]
        resume_times = resume_times["phases"]

        # the checkpoint into a SLAM here, saved again: the same file
        with open(os.path.join(out, "cfg.yaml")) as f:
            cfg = yaml.full_load(f)
        cfg["mono_prior"]["predict_online"] = False   # the state has no DPT
        cfg["silence"] = True
        ds = datasets.get_dataset(cfg)
        slam = SLAM(cfg, ds, device=device)
        t0 = time.perf_counter()
        nxt = slam.load_state(state)
        load_s = time.perf_counter() - t0
        again = os.path.join(tmp, "state_again.npz")
        t0 = time.perf_counter()
        slam.save_state(again, nxt)
        save_s = time.perf_counter() - t0
        A, B = np.load(state), np.load(again)
        differ = sorted(set(A.files) ^ set(B.files))
        buffer_bytes = 0
        for k in sorted(set(A.files) & set(B.files)):
            a, b = A[k], B[k]                 # each decompressed once
            buffer_bytes += a.nbytes
            if a.dtype != b.dtype or not np.array_equal(a, b):
                differ.append(k)
        if differ:
            raise AssertionError(f"state saved again differs: {differ[:8]}")
        file_bytes = os.path.getsize(state)
        del slam
        if device == "cuda":
            torch.cuda.empty_cache()

        # host read + decode + resize per frame (colour and depth)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        read_ms = 1e3 * (time.perf_counter() - t0) / len(ds)
        jpeg = jpeg_probe(tmp)

    kf = int(first["poses"].shape[0])
    same_ts = (second["timestamps"].shape == first["timestamps"].shape
               and np.array_equal(second["timestamps"], first["timestamps"]))
    pose_diff = (float(np.abs(second["poses"] - first["poses"]).max())
                 if same_ts else None)
    phases = times["phases"]
    loop = ("motion_filter", "prefetch", "frontend", "online_ba")
    loop_s = sum(phases[p]["total_s"] for p in loop if p in phases)
    if device == "cuda":
        for name in ("lookup_pyramid", "depth_agree"):
            if launches[name] <= 0 or resume_launches[name] <= 0:
                raise AssertionError(f"kernel {name} never launched in the "
                                     "CLI runs")
    return dict(
        frames=n_frames, size=[H, W], out_size=[cfg["cam"]["H_out"],
                                                cfg["cam"]["W_out"]],
        buffer=cfg["tracking"]["buffer"], ba_type=cfg["tracking"][
            "backend"]["BA_type"], checkpoint_every=every,
        keyframes=kf, resumed_keyframes=int(second["poses"].shape[0]),
        resumed_timestamps_equal=bool(same_ts),
        resumed_max_pose_diff=pose_diff,
        checkpoint_next_frame=ckpt_meta["next_frame"],
        checkpoints_saved=phases.get("checkpoint", {}).get("calls", 0),
        checkpoint_save_s_cli=phases.get("checkpoint", {}).get("total_s"),
        checkpoint_load_s_cli=resume_times.get("load_checkpoint", {}).get(
            "total_s"),
        checkpoint_load_s=load_s, checkpoint_save_s=save_s,
        checkpoint_file_bytes=file_bytes,
        state_arrays_bytes=buffer_bytes,
        cli_first_wall_s=first_s, cli_resume_wall_s=resume_s,
        tracking_loop_s=loop_s, frames_per_s=n_frames / loop_s,
        keyframes_per_s=times.get("keyframe_fps"),
        dpt_calls=dpt_calls, read_decode_resize_ms=read_ms,
        scene_write_s=write_s,
        launches=launches, resume_launches=resume_launches,
        phases={k: round(v["total_s"], 3) for k, v in phases.items()},
        **jpeg)


# ---------------------------------------------------------------------------
# the run tools: endurance, mapper schedule, suite
# ---------------------------------------------------------------------------

# the endurance runs: tracking-only cut from the JAX script's 420 frames
# (SCRIPT_CUTS; the tool runs all 420 on its own), the mapped run at the
# same 120 frames (cut from 200 to make room for the sharded phase)
ENDURANCE_FRAMES = 60
ENDURANCE_MAPPED_FRAMES = 60
ENDURANCE_EVERY_KF = 10
SUITE_FRAMES = 10


def _kernels():
    """Kernels A-E (the tracking library's) and F (the mapper's kNN)."""
    from glorie_slam_tpu_torch.ops import cuda_corr, knn
    return (*cuda_corr.KERNELS, knn.KNN)


def _zero_launches():
    for k in _kernels():
        k.launches = 0


def _launches():
    return {k.name: k.launches for k in _kernels()}


def _allocated(device):
    """Bytes the earlier phases still hold on the card: a tool's peak
    (``max_memory_allocated``) counts them too."""
    import torch
    return torch.cuda.memory_allocated() if device == "cuda" else 0


def endurance_phase(n_frames=ENDURANCE_FRAMES,
                    mapped_frames=ENDURANCE_MAPPED_FRAMES,
                    every_kf=ENDURANCE_EVERY_KF, H=240, W=320,
                    device="cuda"):
    """``tools/long_run_synthetic.long_run``: tracking-only over
    ``n_frames`` frames, then with the asynchronous mapper (``--mapping
    --map-light --every-kf``) over ``mapped_frames``, each with the launch
    counts zeroed before and read after. Checks: every frame a keyframe,
    finite poses, one series row per 20 frames, loop closure and online BA
    ran, A and B launched; in the mapped run every handshake mapped and
    snapshotted."""
    import numpy as np
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.tools.long_run_synthetic import (WINDOW,
                                                                long_run)

    def checked(report, out):
        synth = os.path.join(out, "test", "synth")
        video = np.load(os.path.join(synth, "video.npz"))
        with open(os.path.join(synth, "logs", "phase_times.json")) as f:
            phases = json.load(f)["phases"]
        n = report["n_keyframes"]
        if n != report["n_frames"]:
            raise AssertionError(f"{n} keyframes for {report['n_frames']} "
                                 "frames")
        if not np.isfinite(video["poses"]).all():
            raise AssertionError("poses are not finite")
        if len(report["kf_series"]) != report["n_frames"] // WINDOW:
            raise AssertionError("the KF/s series misses windows")
        if phases.get("online_ba", {}).get("calls", 0) <= 0:
            raise AssertionError("online BA never ran")
        return phases

    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        out = os.path.join(tmp, "tracking")
        held = _allocated(device)
        _zero_launches()
        track = long_run(n_frames, out, H=H, W=W, device=device)
        launches = _launches()
        phases = checked(track, out)
        track["bytes_held_before"] = held

        out = os.path.join(tmp, "mapped")
        held = _allocated(device)
        _zero_launches()
        mapped = long_run(mapped_frames, out, mapping=True, map_light=True,
                          every_kf=every_kf, H=H, W=W, device=device)
        mapped_launches = _launches()
        mapped_phases = checked(mapped, out)
        mapped["bytes_held_before"] = held
    for name in ("lookup_pyramid", "depth_agree"):
        if device == "cuda" and (launches[name] <= 0
                                 or mapped_launches[name] <= 0):
            raise AssertionError(f"kernel {name} never launched in the "
                                 "endurance runs")
    overlap, snap = mapped["mapper_overlap"], mapped["snapshot"]
    handshakes = (mapped["n_keyframes"] - 8 + 1) // every_kf
    if not (overlap["mapped_keyframes"] == snap["handshakes"] ==
            handshakes > 0):
        raise AssertionError(f"{overlap['mapped_keyframes']} jobs mapped, "
                             f"{snap['handshakes']} snapshots, "
                             f"{handshakes} handshakes expected")
    return dict(size=[H, W], tracking=track, launches=launches,
                phases={k: v["total_s"] for k, v in phases.items()},
                mapped=mapped, mapped_launches=mapped_launches,
                mapped_phases={k: v["total_s"]
                               for k, v in mapped_phases.items()})


def print_endurance(e):
    t, m = e["tracking"], e["mapped"]
    gpu = gpu_line()
    print(f"[endurance] {gpu}: tracking-only {t['n_frames']} frames "
          f"{e['size'][0]}x{e['size'][1]}, {t['n_keyframes']} keyframes in {t['wall_s']:.2f} s; "
          f"keyframe_fps {t['keyframe_fps']:.4f}, tracking_only_kf_fps "
          f"{t['tracking_only_kf_fps']:.4f}; peak {t['peak_device_bytes']} "
          f"bytes, {t['bytes_held_before']} of them held by earlier phases; "
          f"launches A {e['launches']['lookup_pyramid']} B "
          f"{e['launches']['depth_agree']}", flush=True)
    print("[endurance] KF/s series (frame, counter, KF/s, window s, "
          "frontend s, online BA s): " + json.dumps([
              (r["frame"], r["counter"], r["kf_per_s"], r["wall_s"],
               r["phases_s"].get("frontend", 0.0),
               r["phases_s"].get("online_ba", 0.0))
              for r in t["kf_series"]]), flush=True)
    print(f"[endurance] phases (s): {json.dumps(e['phases'])}", flush=True)
    s = m["snapshot"]
    print(f"[endurance] {gpu}: mapped (--map-light --every-kf "
          f"{m['every_kf']}) {m['n_frames']} frames, {m['n_keyframes']} "
          f"keyframes in {m['wall_s']:.2f} s, keyframe_fps "
          f"{m['keyframe_fps']:.4f}; peak {m['peak_device_bytes']} bytes "
          f"({m['bytes_held_before']} held by earlier phases); "
          f"launches A {e['mapped_launches']['lookup_pyramid']} B "
          f"{e['mapped_launches']['depth_agree']} F "
          f"{e['mapped_launches']['knn']}; mapper_overlap "
          f"{json.dumps(m['mapper_overlap'])}", flush=True)
    print(f"[endurance] snapshot per handshake: {s['handshakes']} "
          f"handshakes, bytes mean {s['bytes_mean']:.0f} max "
          f"{s['bytes_max']}, {s['bytes_per_row']:.0f} bytes per row; clone "
          f"ms ({s['clone_timer']}) mean {s['clone_ms_mean']:.4f} max "
          f"{s['clone_ms_max']:.4f}; host ms mean {s['host_ms_mean']:.4f}; "
          f"arithmetic at Replica 680x1200 and 300 keyframes: "
          f"{s['replica_680x1200_300kf_bytes_arithmetic']:.0f} bytes",
          flush=True)
    print("[endurance] mapped KF/s series: " + json.dumps([
        (r["frame"], r["counter"], r["kf_per_s"], r["wall_s"])
        for r in m["kf_series"]]), flush=True)


def mapper_schedule_phase(device="cuda"):
    """``tools/mapper_schedule_run.schedule_run`` at the real iteration
    schedule with ``--light``'s rays and points (``SCRIPT_CUTS``), held to
    ``convergence`` (the JAX artifact's criteria); the PSNR must be finite
    and the cloud non-empty."""
    import numpy as np
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.tools.mapper_schedule_run import (
        convergence, schedule_run)

    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    held = _allocated(device)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        report = schedule_run(tmp, light=True, device=device)
    conv = convergence(report)
    if conv["failures"]:
        raise AssertionError(f"the mapper did not converge: {conv}")
    if report["final_psnr_kf4"] is None or \
            not np.isfinite(report["final_psnr_kf4"]) or \
            report["n_points"] <= 0:
        raise AssertionError("no render or no points after the schedule")
    curves = {}
    for h in report["loss_history"]:
        key = f"{h['idx']}{' refine' if h['refine'] else ''}"
        c = curves.setdefault(key, {})
        loss = "geo" if h["stage"] == "geometry" else "color"
        c.setdefault(h["stage"], [h[loss], h[loss]])[1] = h[loss]
    return dict(report={k: v for k, v in report.items()
                        if k != "loss_history"}, bytes_held_before=held,
                convergence=conv, first_last_losses=curves)


SUITE_BASE = """inherit_from: {root}/configs/7scenes/7scenes.yaml
setting: suite
tracking:
  motion_filter:
    thresh: 0.0
  frontend:
    keyframe_thresh: 0.0
data:
  output: {out}
"""
SUITE_SCENE = """inherit_from: {base}
scene: {scene}
data:
  input_folder: {data}
"""


def suite_phase(n_frames=SUITE_FRAMES, H=480, W=640, device="cuda",
                base_extra=""):
    """``python -m glorie_slam_tpu_torch.tools.run_suite`` over a
    configs-like directory written here: a base YAML inheriting
    ``configs/7scenes/7scenes.yaml`` (every frame admitted and kept), two
    scene YAMLs on 7-Scenes-layout scenes (``write_7scenes``), a ``demo_``
    file and a scene whose data folder is missing. With ``--only_tracking
    --max_frames`` it must exit with 1 and write the two good scenes' rows
    (keyframes, ATEs, phase times) to its JSON and markdown table, and the
    broken scene as a failure; the base and demo files are not run."""
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       write_7scenes)

    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        suite = os.path.join(tmp, "7scenes_synth")
        os.makedirs(suite)
        base = os.path.join(suite, "base7.yaml")
        with open(base, "w") as f:
            f.write(SUITE_BASE.format(root=ROOT, out=os.path.join(tmp, "out"))
                    + base_extra)
        intr = [k * W / 640 for k in SEVEN_SCENES_K]
        scenes = {"chess_synth": 4, "fire_synth": 5, "demo_skip": 4,
                  "zz_broken": None}
        for name, seed in scenes.items():
            data = os.path.join(tmp, f"data_{seed}")
            if seed is not None and not os.path.isdir(data):
                write_7scenes(data, SyntheticStream(
                    n_frames=n_frames, H=H, W=W, seed=seed,
                    motion_scale=0.02, trajectory="circuit",
                    intrinsics=intr))
            with open(os.path.join(suite, f"{name}.yaml"), "w") as f:
                f.write(SUITE_SCENE.format(base=base, scene=name, data=data))
        out = os.path.join(tmp, "suite.json")
        args = [sys.executable, "-m", "glorie_slam_tpu_torch.tools.run_suite",
                suite, "--only_tracking", "--max_frames", str(n_frames),
                "--out", out]
        if device != "cuda":
            args += ["--device", device]
        t0 = time.perf_counter()
        proc = subprocess.run(args, cwd=ROOT, env=dict(os.environ,
                                                       PYTHONPATH=ROOT),
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 1:
            raise AssertionError(f"the suite exited {proc.returncode}, not 1"
                                 f":\n{proc.stdout[-3000:]}"
                                 f"{proc.stderr[-3000:]}")
        with open(out) as f:
            agg = json.load(f)
        with open(out[:-len(".json")] + ".md") as f:
            table = f.read().splitlines()
    rows = [r["scene"] for r in agg["results"]]
    if rows != ["chess_synth", "fire_synth"]:
        raise AssertionError(f"suite rows {rows}")
    failed = [os.path.basename(f["config"]) for f in agg["failures"]]
    if failed != ["zz_broken.yaml"]:
        raise AssertionError(f"suite failures {failed}")
    for r in agg["results"]:
        if r["n_keyframes"] != n_frames or "ate_rmse_m" not in r["kf"] or \
                "ate_rmse_m" not in r["full"] or \
                "kernel_launches" not in r.get("phase_times", {}):
            raise AssertionError(f"suite row {r['scene']} is incomplete")
    if len(table) != 5 or not table[2].startswith("| chess_synth |"):
        raise AssertionError(f"suite table: {table}")
    return dict(wall_s=wall, exit_code=proc.returncode, scenes=rows,
                failed=failed, table=table,
                rows=[{k: r[k] for k in ("scene", "n_keyframes",
                                         "keyframe_fps", "wall_s", "kf",
                                         "full")}
                      | {"launches": r["phase_times"]["kernel_launches"]}
                      for r in agg["results"]],
                error=agg["failures"][0]["error"])


# the sharded phase: the frontend's shape at full width (320x640, 40x80 at
# 1/8, 96 active edges from 19 keyframes within 3 frames of each other, 6
# more in the inactive block, the random-weight bf16 net) and dense_ba
# over 24 keyframes of a circuit
SHARD_KEYS = ("poses", "disps", "disps_up", "scale", "shift", "vmask",
              "damping")
_ROUNDS = {"state": {"H": 320, "W": 640, "n": 19, "r": 3, "n_inactive": 6,
                     "buffer": 32, "device": "cuda"},
           "rounds": 12, "alternate": True, "keys": SHARD_KEYS}


def _rounds(rounds=12, alternate=True, dtype=None, batch_invariant=False):
    spec = json.loads(json.dumps(_ROUNDS))
    spec.update(rounds=rounds, alternate=alternate)
    spec["state"].update(dtype=dtype, batch_invariant=batch_invariant)
    return spec


# the whole run: SLAM.run tracking-only with the pipeline phase's config
# and stream (bench.py's tracking config, the final BA, cached true-depth
# priors), 28 frames so that the online BA (every 12 keyframes) and loop
# closure (past the 25-frame window) fire. With the batch-invariant net:
# with the default one, 2 ranks took other frontend edges than one rank
# over 40 frames (poses 0.106 apart; the rounds' bf16 differences, see
# SHARD_TOL, grow over a whole run of random weights), while its ranks
# stayed bitwise equal to each other
SHARD_SLAM_FRAMES = 28
_SLAM = {"n_frames": SHARD_SLAM_FRAMES, "H": 320, "W": 640,
         "config": "bench", "device": "cuda", "batch_invariant": True,
         "stream": {"seed": 3, "motion_scale": 0.02,
                    "trajectory": "circuit"}}
SHARDED = {
    "timed": {
        "rounds": ("rounds", _rounds()),
        "dense_ba": ("dense_ba", {"state": {"H": 320, "W": 640, "n": 24,
                                            "buffer": 32, "device": "cuda"},
                                  "steps": 2})},
    "checks": {
        "rounds_2": ("rounds", _rounds(rounds=2)),
        "pose_depth": ("rounds", _rounds(alternate=False)),
        "rounds_f32": ("rounds", _rounds(dtype="float32")),
        "rounds_nchw": ("rounds", _rounds(batch_invariant=True)),
        "slam": ("slam", _SLAM)},
}
# Held against one rank. The bounds are those of tests/test_torch_parallel.py
# (the JAX mesh test's), and "bitwise" keys must be equal. The batch-invariant
# net's 12 DSPO rounds and dense_ba must be bitwise: the sharding itself is
# exact. The default net's rounds: 2 rounds (one pose_depth, one
# depth_scale), 12 pose_depth rounds and 12 DSPO rounds at the test's bounds.
# The whole run (batch-invariant net): the keyframes (count and timestamps)
# and the frontend's edges at the end of tracking equal to one rank's; its
# poses and disparities are printed.
# On 4 NCCL ranks (a card each) the 12 DSPO rounds' disparities are held to
# the difference that the same 12 rounds show on one rank between the bf16
# and the float32 net (``DTYPE_FLOOR``): cuDNN's channels-last bf16 kernels
# round an edge's result differently with the batch's edge count, and the
# DSPO alternation (the scale fit, the validity refresh) carries that
# rounding on, to 1.30e-2 at 4 ranks; sharding may not move them more than
# the net's precision does. Printed, not held: the float32 net's rounds.
_DSPO = {"poses": 5e-4, "damping": 1e-4, "disps": 1e-2, "scale": 1e-1,
         "shift": 5e-2, "flips": 0.02}
_EXACT = {"bitwise": ("poses", "disps", "disps_up", "scale", "shift",
                      "vmask", "damping")}
DTYPE_FLOOR = "dtype_floor"
SHARD_TOL = {
    "rounds": _DSPO, "rounds_2": _DSPO,
    "pose_depth": {"poses": 5e-4, "damping": 1e-4, "disps": 5e-3,
                   "disps_up": 5e-3, "bitwise": ("scale", "vmask")},
    "rounds_nchw": _EXACT,
    "dense_ba": {"bitwise": ("poses", "disps", "disps_up")},
    "slam": {"bitwise": ("n_keyframes", "timestamps", "ii", "jj")},
}
SHARD_TOL_NCCL = {"rounds": dict(_DSPO, disps=DTYPE_FLOOR)}
SHARD_REPORTED = {"rounds_f32": _DSPO,
                  "slam": {"poses": 1.0, "disps": 1.0, "final_poses": 1.0,
                           "final_disps": 1.0}}


def _held(name, det, ref, tol, fail, n, floor=None):
    """Max differences of n ranks' result from one rank's, and the checks
    that fail; ``floor``: the bounds that ``DTYPE_FLOOR`` stands for."""
    import numpy as np

    out = {}
    for k, t in tol.items():
        if t == DTYPE_FLOOR:
            t = floor[k]
        if k == "flips":
            out["vmask_flip_share"] = float(np.mean(det["vmask"]
                                                    != ref["vmask"]))
            ok = out["vmask_flip_share"] < t
        elif k == "bitwise":
            differ = [b for b in t if not np.array_equal(det[b], ref[b])]
            out["not_bitwise"] = differ
            if fail is not None and differ:
                fail(f"{n} ranks against 1: {name} not bitwise in {differ}")
            continue
        elif np.shape(det[k]) != np.shape(ref[k]):
            out[k], ok = f"shape {np.shape(det[k])} != {np.shape(ref[k])}", False
        else:
            out[k] = float(np.abs(det[k].astype(np.float64) - ref[k]).max())
            ok = out[k] <= t
        if fail is not None and not ok:
            fail(f"{n} ranks against 1: {name} {k} {out.get(k)} > {t}")
    return out


def sharded_phase(spec=SHARDED, device="cuda", timeout=600):
    """The edge-sharded path (``parallel/``): ``drills.card_drill`` (12 DSPO
    rounds of ``graph_update_rounds``, then ``Backend.dense_ba(steps=2)``,
    each cold, warm and deterministic; and the deterministic checks) on 1
    rank and on 2 gloo ranks that share the card, and on 4 NCCL ranks with
    a card each where the machine has 4. Checks: every rank of a run ends
    bitwise equal; n ranks within ``SHARD_TOL`` of one rank; kernels A and
    B launched on every rank. Returns the seconds, per-rank launches and
    bytes received per round, the differences (held and reported), and
    the checks that failed (``failures``: ``main`` prints the report, then
    raises)."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.parallel import launch

    # the seeded problems are the tests' (tests/torch_drills.py); the ranks
    # import them by name, with this path
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_drills import card_drill

    kw = (dict(device="cpu", threads=1) if device == "cpu"
          else dict(shared_device=True))
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    runs, backend = {}, {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        spec = json.loads(json.dumps(spec))
        for name, (kind, sub) in spec["checks"].items():
            if kind == "slam":
                sub["out"] = os.path.join(tmp, name)
        for n in (1, 2):
            runs[n] = launch.launch(card_drill, n, args=(spec,),
                                    timeout=timeout, **kw)
            backend[n] = "gloo"
        if device != "cpu" and torch.cuda.device_count() >= 4:
            runs[4] = launch.launch(card_drill, 4, args=(spec,),
                                    timeout=timeout)
            backend[4] = "nccl"
    ref = runs[1][0]
    floor = _held("rounds", ref["rounds"]["det"], ref["rounds_f32"]["det"],
                  _DSPO, None, 1)
    report = {"shape": {k: v for k, v in spec["timed"].items()},
              "checks": {k: v for k, v in spec["checks"].items()},
              "rounds_bf16_vs_f32_one_rank": floor, "runs": {},
              "failures": []}
    fail = report["failures"].append
    for n, outs in runs.items():
        entry = {"backend": backend[n], "shared_card": n > 1 and
                 backend[n] == "gloo" and device != "cpu", "diffs": {}}
        for name in ref:
            det = [o[name]["det"] for o in outs]
            for r, d in enumerate(det[1:], 1):
                for k, v in d.items():
                    if (isinstance(v, np.ndarray)
                            and not np.array_equal(det[0][k], v)):
                        fail(f"{n} ranks: rank {r} differs from rank 0 in "
                             f"{name} {k}")
            tol = (SHARD_TOL_NCCL if backend[n] == "nccl"
                   else {}).get(name, SHARD_TOL.get(name))
            diffs = {}
            if tol is not None:
                diffs.update(_held(name, det[0], ref[name]["det"], tol,
                                   fail, n, floor))
            if name in SHARD_REPORTED:
                diffs.update(_held(name, det[0], ref[name]["det"],
                                   SHARD_REPORTED[name], None, n))
            entry["diffs"][name] = diffs
        for name, (kind, sub) in spec["timed"].items():
            warm = [o[name]["warm"] for o in outs]
            launches = [{k: w["launches"][k] for k in (
                "lookup_pyramid", "depth_agree")} for w in warm]
            if device != "cpu" and kind == "rounds" and any(
                    ln["lookup_pyramid"] <= 0 or ln["depth_agree"] <= 0
                    for ln in launches):
                fail(f"{n} ranks: kernel A or B did not launch on every "
                     f"rank: {launches}")
            entry[name] = {
                "seconds": max(w["seconds"] for w in warm),
                "seconds_by_rank": [w["seconds"] for w in warm],
                "cold_seconds": max(o[name]["cold_s"] for o in outs),
                "det_seconds": max(o[name]["det"]["seconds"] for o in outs),
                "launches_by_rank": launches,
                "bytes_received_by_rank": [w["bytes_received"]
                                           for w in warm],
                "bytes_received_per_round": sum(
                    w["bytes_received"] for w in warm) / sub.get("rounds",
                                                                  1),
                "collectives_by_rank": [w["collectives"] for w in warm],
                "edges": warm[0].get("edges", warm[0].get("n_edges"))}
        for name, (kind, sub) in spec["checks"].items():
            if kind != "slam":
                continue
            det = [o[name]["det"] for o in outs]
            launches = [{k: d["launches"][k] for k in (
                "lookup_pyramid", "depth_agree")} for d in det]
            if device != "cpu" and any(
                    ln["lookup_pyramid"] <= 0 or ln["depth_agree"] <= 0
                    for ln in launches):
                fail(f"{n} ranks: kernel A or B did not launch on every "
                     f"rank of the whole run: {launches}")
            if det[0]["loop_closure_at"] <= 0 or det[0]["online_ba_at"] <= 0:
                fail(f"{n} ranks: loop closure or online BA did not run in "
                     "the whole run")
            entry[name] = {
                "seconds": max(d["seconds"] for d in det),
                "keyframes": int(det[0]["n_keyframes"]),
                "edges": int(len(det[0]["ii"])),
                "loop_closure_at": det[0]["loop_closure_at"],
                "online_ba_at": det[0]["online_ba_at"],
                "launches_by_rank": launches,
                "bytes_received_by_rank": [d["bytes_received"] for d in det],
                "collectives_by_rank": [d["collectives"] for d in det]}
        report["runs"][n] = entry
    # every kernel's launches on 2 ranks, summed over the timed runs and
    # the whole runs
    counted = ([o[name]["warm"] for name in spec["timed"] for o in runs[2]]
               + [o[name]["det"] for name, (kind, _) in spec["checks"].items()
                  if kind == "slam" for o in runs[2]])
    report["launches"] = {k: sum(c["launches"][k] for c in counted)
                          for k in counted[0]["launches"]}
    return report


def print_sharded(rep):
    gpu = gpu_line()
    st = rep["shape"]["rounds"][1]["state"]
    hw = f"{st['H']}x{st['W']}"
    for n, e in rep["runs"].items():
        r, d = e["rounds"], e["dense_ba"]
        print(f"[sharded] {gpu}: {n} rank(s), {e['backend']}"
              f"{' sharing the card' if e['shared_card'] else ''}: 12 DSPO "
              f"rounds over {r['edges']} active edges at {hw} "
              f"{r['seconds']:.4f} s (per rank {r['seconds_by_rank']}, cold "
              f"{r['cold_seconds']:.3f} s, deterministic "
              f"{r['det_seconds']:.3f} s), received "
              f"{r['bytes_received_per_round']:.0f} bytes per round over "
              f"all ranks; dense_ba(2) over {d['edges']} edges "
              f"{d['seconds']:.4f} s (deterministic {d['det_seconds']:.3f} "
              f"s), received {d['bytes_received_by_rank']} bytes; launches "
              f"A/B per rank: rounds {r['launches_by_rank']}, dense_ba "
              f"{d['launches_by_rank']}; against 1 rank: "
              f"{json.dumps(e['diffs'])}", flush=True)
    for n, e in rep["runs"].items():
        w = e["slam"]
        print(f"[sharded] {gpu}: {n} rank(s), {e['backend']}: SLAM.run "
              f"tracking-only, {rep['checks']['slam'][1]['n_frames']} frames "
              f"at {hw} "
              f"(deterministic): {w['seconds']:.2f} s, {w['keyframes']} "
              f"keyframes, {w['edges']} frontend edges, loop closure at "
              f"{w['loop_closure_at']}, online BA at {w['online_ba_at']}; "
              f"launches A/B per rank {w['launches_by_rank']}; received "
              f"{w['bytes_received_by_rank']} bytes; against 1 rank: "
              f"{json.dumps(e['diffs']['slam'])}", flush=True)
    print("[sharded] one rank, 12 DSPO rounds, bf16 net against float32 net: "
          + json.dumps(rep["rounds_bf16_vs_f32_one_rank"]), flush=True)
    print("[sharded] " + json.dumps(rep), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from glorie_slam_tpu_torch.device import set_float32_precision
    from glorie_slam_tpu_torch.ops import cuda_corr, knn

    set_float32_precision()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    print("[cuts] " + "; ".join(f"{k}: {a} -> {b}"
                                 for k, (a, b) in SCRIPT_CUTS.items()),
          flush=True)
    t0 = time.perf_counter()
    build_all()
    phase("build", t0)

    t0 = time.perf_counter()
    inputs = edge_inputs(dev)
    results = [check_kernel_a(dev, inputs), check_kernel_b(dev),
               check_kernel_c(dev, inputs), *check_kernels_de(dev, inputs),
               check_kernel_f(dev)]
    for r in results:
        print("[kernel] " + json.dumps(r), flush=True)
    torch.cuda.empty_cache()
    phase("kernels", t0)

    t0 = time.perf_counter()
    vol = volume_check(dev, inputs)
    print("[volume] " + json.dumps(vol), flush=True)
    del inputs
    torch.cuda.empty_cache()
    phase("volume", t0)

    t0 = time.perf_counter()
    ref = reference_check()
    print("[reference] " + json.dumps(ref), flush=True)
    phase("reference", t0)

    t0 = time.perf_counter()
    pipe, captured = pipeline(PIPELINE_FRAMES)
    print("[pipeline] " + json.dumps(pipe), flush=True)
    # kernel A on the inputs of the last frame's largest frontend lookup
    on_pipe = measure_lookup_pyramid(*captured)
    del captured
    on_pipe = {k: on_pipe[k] for k in (
        "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "box", "shapes")}
    on_pipe.update(event_ms_over_run=pipe["lookup_pyramid_event_ms"],
                   event_ms_per_launch_over_run=pipe[
                       "lookup_pyramid_event_ms_per_launch"])
    print("[pipeline] kernel A on captured inputs: " + json.dumps(on_pipe),
          flush=True)
    phase("pipeline", t0)

    t0 = time.perf_counter()
    mono = mono_prior_check()
    print("[mono prior] " + json.dumps(mono), flush=True)
    print(f"[mono prior] DPT {mono['size']}x{mono['size']}: "
          f"{mono['predict_ms_median']:.3f} ms per frame (median of "
          f"{len(mono['predict_ms'])}), forward "
          f"{mono['forward_ms_median']:.3f} ms, bound "
          f"{mono['bound_ms']:.3f} ms ({mono['bound_by']}, "
          f"{mono['gflop']:.1f} GFLOP at FP32 {FP32_FLOPS / 1e12:.0f} "
          f"TFLOP/s); depths inside (0, 1): {mono['depth_inside_0_1']:.3f}",
          flush=True)
    phase("mono prior", t0)

    t0 = time.perf_counter()
    online = online_prior_run(ONLINE_FRAMES)
    print("[online prior] " + json.dumps(online), flush=True)
    phase("online prior", t0)

    t0 = time.perf_counter()
    step = mapping_step_check()
    print("[mapping step] " + json.dumps(step), flush=True)
    phase("mapping step", t0)

    t0 = time.perf_counter()
    mapping = mapping_phase(MAPPING_FRAMES)
    print("[mapping] " + json.dumps(mapping), flush=True)
    print(f"[mapping] cuts: {MAPPING_FRAMES} frames; {MAPPING_CUTS} "
          "(from iters_first 1500, geo_iter_first 400, iters 400); every "
          "width is Replica's; tracking as bench.py's config (multiview "
          f"filter {mapping['multiview_thresh']}, no final BA)", flush=True)
    for name, vals in mapping["metrics"].items():
        print(f"[mapping] {name}: " + json.dumps(vals), flush=True)
    print(f"[mapping] lpips_variant {mapping['lpips_variant']}; evaluation "
          f"s {json.dumps(mapping['eval_s'])}; mesh "
          f"{json.dumps(mapping['mesh'])}", flush=True)
    phase("mapping", t0)

    t0 = time.perf_counter()
    oracle = oracle_evaluation()
    print("[oracle evaluation] " + json.dumps(oracle), flush=True)
    phase("oracle evaluation", t0)

    t0 = time.perf_counter()
    evals = eval_modules_check()
    print("[eval modules] " + json.dumps(evals), flush=True)
    phase("eval modules", t0)

    t0 = time.perf_counter()
    entry = entry_point_phase()
    print("[entry point] " + json.dumps(entry), flush=True)
    gpu = gpu_line()
    print(f"[entry point] {gpu}: CLI on a 7-Scenes-layout scene, "
          f"{entry['frames']} frames {entry['size'][0]}x{entry['size'][1]} "
          f"-> {entry['out_size'][0]}x{entry['out_size'][1]}, buffer "
          f"{entry['buffer']}: {entry['frames_per_s']:.3f} frames/s over "
          f"the tracking loop ({entry['checkpoint_save_s_cli']:.1f} s of "
          f"checkpoint saves apart), {entry['keyframes_per_s']:.3f} KF/s; "
          f"read + decode + resize {entry['read_decode_resize_ms']:.2f} "
          f"ms per frame; checkpoint save "
          f"{entry['checkpoint_save_s']:.2f} s, load "
          f"{entry['checkpoint_load_s']:.2f} s, file "
          f"{entry['checkpoint_file_bytes']} bytes of "
          f"{entry['state_arrays_bytes']} in arrays; DPT calls "
          f"{entry['dpt_calls']}; launches A "
          f"{entry['launches']['lookup_pyramid']} B "
          f"{entry['launches']['depth_agree']} (resumed run: A "
          f"{entry['resume_launches']['lookup_pyramid']} B "
          f"{entry['resume_launches']['depth_agree']}); resumed keyframes "
          f"{entry['resumed_keyframes']} of {entry['keyframes']}, timestamps "
          f"{'equal' if entry['resumed_timestamps_equal'] else 'differ'}, "
          f"largest keyframe-pose difference "
          f"{entry['resumed_max_pose_diff']}; JPEG: {entry['jpeg']}",
          flush=True)
    phase("entry point", t0)

    t0 = time.perf_counter()
    endurance = endurance_phase()
    print_endurance(endurance)
    phase("endurance", t0)

    t0 = time.perf_counter()
    sched = mapper_schedule_phase()
    r = sched["report"]
    print(f"[mapper schedule] {gpu_line()}: " + json.dumps(r), flush=True)
    print(f"[mapper schedule] {r['approx_train_iters']} train iterations "
          f"at {r['ms_per_train_iter']:.2f} ms each (mapping "
          f"{r['mapping_s']:.2f} s, final_refine {r['final_refine_s']:.2f} "
          f"s); PSNR of keyframe 4 {r['final_psnr_kf4']:.3f} dB; peak "
          f"{r['peak_device_bytes']} bytes ({sched['bytes_held_before']} "
          f"held by earlier phases); "
          f"{r['n_points']} points; convergence "
          f"{json.dumps(sched['convergence'])}", flush=True)
    print("[mapper schedule] first and last loss per keyframe and stage "
          "(geo in the geometry stage, colour in the colour stage): "
          + json.dumps(sched["first_last_losses"]), flush=True)
    phase("mapper schedule", t0)

    t0 = time.perf_counter()
    suite = suite_phase()
    print("[suite] " + json.dumps(suite), flush=True)
    phase("suite", t0)

    t0 = time.perf_counter()
    sharded = sharded_phase()
    print_sharded(sharded)
    if sharded["failures"]:
        raise AssertionError("sharded phase: "
                             + "; ".join(sharded["failures"]))
    phase("sharded", t0)

    # A and B launch on the tracking path (the pipeline); C, D and E on
    # the volume path; F on the mapping path; each path's own counts
    # beside them
    path_launches = {**pipe["launches"],
                     **{k: vol["launches"][k] for k in (
                         "lookup_level", "lookup_plane",
                         "lookup_plane_slots")},
                     knn.KNN.name: mapping["launches"][knn.KNN.name]}
    by_path = {"pipeline": pipe["launches"], "volume": vol["launches"],
               "endurance": endurance["launches"],
               "endurance_mapped": endurance["mapped_launches"],
               "mapping": mapping["launches"],
               "sharded": sharded["launches"]}
    kernels = []
    for r in results:
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": path_launches[r["name"]],
            "launches_by_path": {p: v[r["name"]]
                                 for p, v in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if r["name"] == cuda_corr.LOOKUP_PYRAMID.name:
            kernels[-1]["box"] = r["box"]
            kernels[-1]["pipeline"] = on_pipe
        if r["name"] == knn.KNN.name:
            kernels[-1].update({k: r[k] for k in (
                "rows_differ", "launches_per_step", "shapes")})
        if "sector_floor_ms" in r:                       # D and E
            kernels[-1].update({k: r[k] for k in (
                "sector_floor_ms", "checked_ms", "grid_sample", "smooth",
                "corr_block_levels", "alt_corr_tile") if k in r})
    assert ({k.name for k in (*cuda_corr.KERNELS, knn.KNN)}
            == {k["name"] for k in kernels})
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
