#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glorie_slam_tpu_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. build: the CUDA kernels (one nvcc per source, started together, then
   linked), then the host proximity library, into
   glorie_slam_tpu_torch/_build;
2. kernels: each of the five kernels against its plain PyTorch version on
   the card, at the shapes its path gives it (the 40x80 grid of a 320x640
   frame, 128 channels, 96 edges), with timings (CUDA events), bounds and
   a library formulation's time; for kernel A also the mean box size of
   its pixel tiles per level (``cuda_corr.tile_box_stats``); for D and E
   also the sector floor (``cuda_corr.plane_sector_stats``), a
   ``grid_sample`` time, E without and with its range check on the card,
   both on smooth flow, and D at its callers' shapes (``CorrBlock``
   levels 1-3, an ``alt_corr_chunk`` tile);
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
6. mapping step: one mapping train step (render, losses, gradients, Adam)
   from one 120x160 state at the Replica widths on the card and on the CPU
   (``mapping_step_check``), in both stages, with the kNN's disagreement;
7. mapping: ``SLAM(cfg, stream).run()`` with the mapper on (asynchronous,
   on its worker's CUDA stream) at 320x640 and the Replica widths, with the
   cuts ``MAPPING_FRAMES`` / ``MAPPING_CUTS`` printed (the tracking config
   is bench.py's, multiview filter 0.01 included): ``MapProbe`` gives the
   mapper's seconds per keyframe, the mean train-step ms and the kNN's
   share (CUDA events on the worker's stream); then anchors and points,
   ``final_refine`` seconds, peak memory, the first and last losses; the
   geo loss must fall over the first mapped keyframe, and ``final_refine``
   must run its optimisation. Kernels A and B launch again in its tracking.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
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
# mapped keyframes) and the optimisation cut from 1500 / 400 / 400
# iterations so that the phase takes minutes, not hours
MAPPING_FRAMES = 16
MAPPING_CUTS = {"iters_first": 40, "geo_iter_first": 15, "iters": 10,
                "pretrained": None}


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
    from glorie_slam_tpu_torch.ops import corr, cuda_corr

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

    for k in cuda_corr.KERNELS:
        k.launches = 0
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
    launches = {k.name: k.launches for k in cuda_corr.KERNELS}

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

        for k in cuda_corr.KERNELS:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with probe:
            slam.run()
        torch.cuda.synchronize()
        a_ms, a_launches = probe.event_ms()
        launches = {k.name: k.launches for k in cuda_corr.KERNELS}
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

def oracle_video(stream, cfg, n, device):
    """A DepthVideo holding frames 0..n-1 of a synthetic stream at their
    true poses and full-resolution depths, every pixel valid and every frame
    marked for re-anchoring: the state a mapper reads, without a tracker."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch.core.depth_video import DepthVideo

    v = DepthVideo(cfg, device=device)
    v.counter = n
    v.timestamp[:n] = torch.arange(n, dtype=torch.float32)
    v.poses[:n] = torch.as_tensor(np.array(stream.poses_w2c[:n]))
    v.disps_up[:n] = torch.as_tensor(1.0 / np.stack(stream.depths[:n]))
    v.intrinsics = torch.as_tensor(stream.intrinsics / 8.0, device=device)
    v._valid_depth_mask[:n] = True
    v.npc_dirty[:n] = True
    return v


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
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       base_cfg, mapping_cfg)

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
    maps), the kNN calls split into those inside a train step and the rest;
    and each mapped keyframe's wall time (its ``on_keyframe`` call, ended
    with a synchronize of its stream)."""

    def __init__(self, mapper):
        import threading
        from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
        from glorie_slam_tpu_torch.ops import knn as knn_mod
        self.mods = (mapper_mod, knn_mod)
        self.inner = (mapper_mod._map_train_step, knn_mod.knn_search)
        self.mapper, self.inner_kf = mapper, mapper.on_keyframe
        self.local = threading.local()
        self.steps, self.knn_in, self.knn_out, self.kf_s = [], [], [], []

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


def mapping_phase(n_frames, H=320, W=640, device="cuda"):
    """``SLAM.run`` with mapping at 320x640 (see ``MAPPING_CUTS``)."""
    import numpy as np
    import torch
    from glorie_slam_tpu_torch import build
    from glorie_slam_tpu_torch.ops import cuda_corr
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

        slam = SLAM(cfg, stream, device=device)
        if slam.async_mapper is None or (slam.async_mapper.stream is None
                                         and device == "cuda"):
            raise AssertionError("the mapper is not on its worker stream")
        for k in cuda_corr.KERNELS:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with MapProbe(slam.mapper) as probe:
            slam.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k.name: k.launches for k in cuda_corr.KERNELS}
        out = slam.output
        files = {f: os.path.getsize(os.path.join(out, f)) for f in (
            "final_point_cloud.npy", "npc_cloud.npy", "final_point_cloud.ply",
            "video.npz")}
        cloud = np.load(os.path.join(out, "final_point_cloud.npy"))
        with open(os.path.join(out, "logs", "phase_times.json")) as f:
            phases = json.load(f)["phases"]
    mapper, stats = slam.mapper, slam.async_mapper.stats
    steps = MapProbe.ms(probe.steps)
    knn_in, knn_out = MapProbe.ms(probe.knn_in), MapProbe.ms(probe.knn_out)
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
    for name in ("lookup_pyramid", "depth_agree"):
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
        files=files)


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
    inputs = edge_inputs(dev)
    results = [check_kernel_a(dev, inputs), check_kernel_b(dev),
               check_kernel_c(dev, inputs), *check_kernels_de(dev, inputs)]
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
    phase("mapping", t0)

    # A and B launch on the tracking path (the pipeline); C, D and E on
    # the volume path
    path_launches = {**pipe["launches"],
                     **{k: vol["launches"][k] for k in (
                         "lookup_level", "lookup_plane",
                         "lookup_plane_slots")}}
    kernels = []
    for r in results:
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": path_launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if r["name"] == cuda_corr.LOOKUP_PYRAMID.name:
            kernels[-1]["box"] = r["box"]
            kernels[-1]["pipeline"] = on_pipe
        if "sector_floor_ms" in r:                       # D and E
            kernels[-1].update({k: r[k] for k in (
                "sector_floor_ms", "checked_ms", "grid_sample", "smooth",
                "corr_block_levels", "alt_corr_tile") if k in r})
    assert {k.name for k in cuda_corr.KERNELS} == {k["name"] for k in kernels}
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
