"""The port's CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``glorie_slam_tpu/ops/pallas_corr.py``. Five kernels:

* ``lookup_pyramid`` (kernel A, ``csrc/lookup_pyramid.cu``) replaces
  ``lookup_feats_pyramid_pallas`` (pallas_corr.py:363, pallas_call :412):
  the 4-level 7x7 bilinear correlation lookup computed from feature stores.
  At the slice's shapes its least time on the card is set by bytes (the
  bf16 output dominates). One block takes an 8x8 tile of source pixels and
  runs wgmma products of their f1 rows against the f2 rows of the tile's
  window box (``tile_box_spans`` is that rule on the host), keeping the
  products that fall in each pixel's window.
* ``depth_agree`` (kernel B, ``csrc/depth_agree.cu``) replaces
  ``depth_agree_pallas`` (pallas_corr.py:644, pallas_call :678): the
  4-corner multiview depth-agreement test. Bound on the card: bytes.
* ``lookup_level`` (kernel C, ``csrc/lookup_pyramid.cu``, kernel A's
  template at one level) replaces ``lookup_feats_pallas`` (pallas_corr.py
  :251, pallas_call :287): one level's 7x7 window from feature stores,
  float32 output, for feature pyramids without 4 levels.
* ``lookup_plane`` (kernel D, ``csrc/lookup_plane.cu``) replaces
  ``lookup_pallas`` (pallas_corr.py:153, pallas_call :174): the 7x7 window
  over precomputed pixel-minor correlation planes (the volume path).
* ``lookup_plane_slots`` (kernel E, the same source with a slot read)
  replaces ``lookup_pallas_slots`` (pallas_corr.py:477, pallas_call :507):
  D with plane row ``slots[e]`` of a fixed-capacity store.
Bound on the card for C, D and E: bytes. A pixel's cells in D's and E's
planes lie npix elements apart, so their least traffic is the distinct
32-byte sectors (16 consecutive pixels at one cell) that the windows touch
(``plane_sector_stats``): each block reads each of them once, fully.

Each wrapper takes its plain version for tensors on the CPU (the tests and
CPU runs) and, for tensors on a CUDA device, launches the kernel or raises;
there is no fallback from one to the other. Each kernel has a launch
counter (``LOOKUP_PYRAMID.launches`` and so on) that its wrapper bumps once
per launch and nowhere else.
"""

import ctypes
from dataclasses import dataclass

import torch

from .. import build
from ..utils.phase_timer import span

RADIUS = 3
LEVELS = 4
CHANNELS = 128
MAX_ROWS, MAX_COLS = 16384, 32768   # plane sizes kernels A and C accept
# kernel A's box rule, checked against the kernel's own constants when the
# library loads (``glorie_lookup_geometry``)
TILE = (8, 8)       # kernel A's pixel tile (rows, columns): the MMA's 64 rows
RUN = 32            # box cells per shared-memory stage: the MMA's 32 columns
MARGIN = 16         # level coordinates clamp to [-MARGIN, size + MARGIN]
# kernels D and E's sector rule, checked against the kernel's constants
# when the library loads (``glorie_lookup_plane_geometry``)
PLANE_GROUP = 16    # pixels per sector group: 16 bf16 fill a 32-byte sector
PLANE_BAND = 4096   # row-major cells per band of the kernel's cell bitmap
SECTOR_BYTES = 32


@dataclass
class Kernel:
    name: str
    source: str
    replaces: str
    launches: int = 0


LOOKUP_PYRAMID = Kernel("lookup_pyramid",
                        "glorie_slam_tpu_torch/csrc/lookup_pyramid.cu",
                        "glorie_slam_tpu/ops/pallas_corr.py:412")
DEPTH_AGREE = Kernel("depth_agree",
                     "glorie_slam_tpu_torch/csrc/depth_agree.cu",
                     "glorie_slam_tpu/ops/pallas_corr.py:678")
LOOKUP_LEVEL = Kernel("lookup_level",
                      "glorie_slam_tpu_torch/csrc/lookup_pyramid.cu",
                      "glorie_slam_tpu/ops/pallas_corr.py:287")
LOOKUP_PLANE = Kernel("lookup_plane",
                      "glorie_slam_tpu_torch/csrc/lookup_plane.cu",
                      "glorie_slam_tpu/ops/pallas_corr.py:174")
LOOKUP_PLANE_SLOTS = Kernel("lookup_plane_slots",
                            "glorie_slam_tpu_torch/csrc/lookup_plane.cu",
                            "glorie_slam_tpu/ops/pallas_corr.py:507")
KERNELS = (LOOKUP_PYRAMID, DEPTH_AGREE, LOOKUP_LEVEL, LOOKUP_PLANE,
           LOOKUP_PLANE_SLOTS)

_vp = ctypes.c_void_p
_int = ctypes.c_int


def _lib():
    lib = build.kernels_library()
    if not getattr(lib, "_glorie_typed", False):
        lib.glorie_lookup_pyramid.restype = _int
        lib.glorie_lookup_pyramid.argtypes = (
            [_vp] * 5 + [_int] * 8 + [_vp] * 4 + [_int, _int, _vp])
        lib.glorie_depth_agree.restype = _int
        lib.glorie_depth_agree.argtypes = [_vp] * 4 + [_int] * 4 + [_vp]
        lib.glorie_lookup_level.restype = _int
        lib.glorie_lookup_level.argtypes = (
            [_vp] * 2 + [_int] * 2 + [_vp] * 4 + [_int] * 2 + [_vp])
        lib.glorie_lookup_plane.restype = _int
        lib.glorie_lookup_plane.argtypes = [_vp] * 4 + [_int] * 4 + [_vp]
        lib.glorie_lookup_geometry.restype = None
        geometry = (_int * 4)()
        lib.glorie_lookup_geometry(geometry)
        if tuple(geometry) != (*TILE, RUN, MARGIN):
            raise RuntimeError(
                f"cuda_corr: TILE, RUN, MARGIN {(*TILE, RUN, MARGIN)} differ "
                f"from the kernel's {tuple(geometry)}")
        lib.glorie_lookup_plane_geometry.restype = None
        lib.glorie_lookup_plane_geometry.argtypes = [ctypes.POINTER(_int)]
        plane = (_int * 3)()
        lib.glorie_lookup_plane_geometry(plane)
        if tuple(plane) != (PLANE_GROUP, MARGIN, PLANE_BAND):
            raise RuntimeError(
                f"cuda_corr: PLANE_GROUP, MARGIN, PLANE_BAND "
                f"{(PLANE_GROUP, MARGIN, PLANE_BAND)} differ from kernel "
                f"D's {tuple(plane)}")
        lib._glorie_typed = True
    return lib


def _check_cuda(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# kernel A: 4-level correlation lookup from feature stores
# ---------------------------------------------------------------------------

def lookup_pyramid(f1, f2_levels, iis, jjs, coords):
    """Windowed 4-level correlation lookup.

    f1: (N, npix, 128) bf16 level-0 store (pixel-major rows);
    f2_levels: 4 stores (N, h_l, w_l, 128) bf16, level 0 being ``f1``
    viewed as (N, h0, w0, 128); iis/jjs: (E,) int32 source/target frames;
    coords: (E, npix, 2) float32 level-0 [x, y] (NaN -> 0).
    Returns (E, npix, 196) bf16, channel = l*49 + a*7 + b (a: x offset).
    On the card the call runs inside span ``cuda.lookup_pyramid``.
    """
    if f1.device.type == "cpu":
        return lookup_pyramid_plain(f1, f2_levels, iis, jjs, coords)
    with span("cuda.lookup_pyramid"):
        return _lookup_pyramid_cuda(f1, f2_levels, iis, jjs, coords)


def _lookup_pyramid_cuda(f1, f2_levels, iis, jjs, coords):
    if f1.device.type != "cuda":
        raise ValueError(f"lookup_pyramid: unsupported device {f1.device}")
    N, npix, C = f1.shape
    E = iis.shape[0]
    if C != CHANNELS or len(f2_levels) != LEVELS:
        raise ValueError("lookup_pyramid: needs 128 channels and 4 levels")
    if f2_levels[0].shape[1] * f2_levels[0].shape[2] != npix:
        raise ValueError("lookup_pyramid: level 0 must cover npix pixels")
    if coords.shape != (E, npix, 2) or jjs.shape != (E,):
        raise ValueError("lookup_pyramid: coords/jjs shape mismatch")
    if any(lv.shape[1] >= MAX_ROWS or lv.shape[2] >= MAX_COLS
           for lv in f2_levels):
        raise ValueError("lookup_pyramid: planes must be under "
                         f"{MAX_ROWS} x {MAX_COLS} cells")
    bf, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    _check_cuda("lookup_pyramid",
                [f1, *f2_levels, iis, jjs, coords],
                [bf] * 5 + [i32, i32, f32])
    out = torch.empty((E, npix, LEVELS * (2 * RADIUS + 1) ** 2), dtype=bf,
                      device=f1.device)
    if E == 0:
        return out
    dims = []
    for lv in f2_levels:
        dims += [lv.shape[1], lv.shape[2]]
    err = _lib().glorie_lookup_pyramid(
        f1.data_ptr(), *[lv.data_ptr() for lv in f2_levels], *dims,
        iis.data_ptr(), jjs.data_ptr(), coords.data_ptr(), out.data_ptr(),
        E, npix, _stream(f1.device))
    if err:
        raise RuntimeError(f"lookup_pyramid: CUDA error {err}")
    LOOKUP_PYRAMID.launches += 1
    return out


def _hat_weights(pos, size: int, radius: int = RADIUS):
    """W[..., c, a] = max(0, 1 - |c - (pos - r + a)|)."""
    c = torch.arange(size, dtype=pos.dtype, device=pos.device)
    a = torch.arange(2 * radius + 1, dtype=pos.dtype, device=pos.device)
    sample = pos[..., None] - radius + a
    return torch.clamp(1.0 - (c[:, None] - sample[..., None, :]).abs(),
                       min=0.0)


def lookup_separable(plane, coords):
    """Windowed bilinear lookup as two contractions with hat weights.

    plane: (E, npix, hl, wl) correlation planes of one level; coords:
    (E, npix, 2) [x, y] in level units. Returns (E, npix, 49) float32,
    window flattened x-major (channel a*7 + b)."""
    E, npix, hl, wl = plane.shape
    rd = 2 * RADIUS + 1
    wx = _hat_weights(coords[..., 0], wl)                  # (E, p, wl, rd)
    wy = _hat_weights(coords[..., 1], hl)                  # (E, p, hl, rd)
    tmp = torch.einsum("ephw,ephb->epbw", plane.float(), wy)
    out = torch.einsum("epbw,epwa->epab", tmp, wx)
    return out.reshape(E, npix, rd * rd)


def tile_box_spans(coords, dims, tile=TILE):
    """Kernel A's box rule on the host (the port's counterpart of the JAX
    package's ``band_coverage_stats``): a second copy of the rule in
    ``csrc/lookup_pyramid.cu``, a diagnostic only. Its constants are
    checked against the kernel's when the library loads; the rule itself
    is held only against a brute-force enumeration on the host.

    coords: (E, npix, 2) level-0 [x, y] over the h0 x w0 pixel grid;
    dims: ((h0, w0), (h1, w1), ...) level sizes; tile: (rows, columns) of a
    block's pixel tile. A pixel's level-l window starts at cell
    (floor(x) - 3, floor(y) - 3) of the cleaned coordinates (NaN -> 0,
    clamped to [-MARGIN, size + MARGIN]); its in-plane part is that 8x8
    block clipped to the plane. A tile's box is, row by row, the span from the
    leftmost to the rightmost in-plane window cell of the tile's pixels on
    that row; pixels outside the grid or with no in-plane cell add nothing.

    Returns one (xlo, xhi) pair of int64 tensors (E, n_tiles, h_l) per
    level: row y of the box holds cells xlo..xhi (none where xhi < xlo).
    """
    E, npix, _ = coords.shape
    (h0, w0), (th, tw) = dims[0], tile
    if h0 * w0 != npix:
        raise ValueError("tile_box_spans: dims[0] must cover npix pixels")
    nty, ntx = -(-h0 // th), -(-w0 // tw)
    dev = coords.device
    grid = torch.zeros((E, nty * th, ntx * tw, 2), device=dev)
    grid[:, :h0, :w0] = coords.float().reshape(E, h0, w0, 2)
    ok = torch.zeros((nty * th, ntx * tw), dtype=torch.bool, device=dev)
    ok[:h0, :w0] = True

    def tiles(v):   # (..., nty*th, ntx*tw) -> (..., n_tiles, th*tw)
        v = v.reshape(*v.shape[:-2], nty, th, ntx, tw).transpose(-3, -2)
        return v.reshape(*v.shape[:-4], nty * ntx, th * tw)

    cx, cy, ok = tiles(grid[..., 0]), tiles(grid[..., 1]), tiles(ok)
    side = 2 * RADIUS + 2
    span = torch.arange(side, device=dev)
    out = []
    for lvl, (hl, wl) in enumerate(dims):
        def origin(c, size):
            c = torch.nan_to_num(c * (1.0 / 2 ** lvl), nan=0.0)
            return (torch.floor(c.clamp(-MARGIN, size + MARGIN)).long()
                    - RADIUS)

        ox, oy = origin(cx, wl), origin(cy, hl)
        x0, x1 = ox.clamp(min=0), (ox + side - 1).clamp(max=wl - 1)
        inb = ok & (x0 <= x1) & (oy + side - 1 >= 0) & (oy < hl)
        rows = oy[..., None] + span                      # (E, T, 64, 8)
        use = inb[..., None] & (rows >= 0) & (rows < hl)
        rows = torch.where(use, rows, hl).reshape(E, nty * ntx, -1)
        big = 1 << 29
        xlo = torch.full((E, nty * ntx, hl + 1), big, device=dev)
        xhi = torch.full_like(xlo, -big)
        xlo.scatter_reduce_(2, rows, x0[..., None].expand(
            *x0.shape, side).reshape(rows.shape), "amin")
        xhi.scatter_reduce_(2, rows, x1[..., None].expand(
            *x1.shape, side).reshape(rows.shape), "amax")
        out.append((xlo[..., :hl], xhi[..., :hl]))
    return out


def tile_box_stats(coords, dims, tile=TILE):
    """Mean box size in cells per (edge, tile) at each level under kernel
    A's rule (``tile_box_spans``): {"tiles": E * n_tiles,
    "box_cells": [per level], "runs": [per level, box cells in runs of
    ``RUN``, rounded up per tile]}."""
    spans = tile_box_spans(coords, dims, tile)
    cells = [(xhi - xlo + 1).clamp(min=0).sum(-1) for xlo, xhi in spans]
    return {"tiles": int(cells[0].numel()),
            "box_cells": [float(c.float().mean()) for c in cells],
            "runs": [float(((c + RUN - 1) // RUN).float().mean())
                     for c in cells]}


def lookup_pyramid_plain(f1, f2_levels, iis, jjs, coords):
    """Plain PyTorch version of ``lookup_pyramid``: kernel C's plain
    version at each level, rounded to bf16."""
    c = torch.nan_to_num(coords.float())
    C = f1.shape[2]
    outs = [lookup_level_plain(
        f1, f2.reshape(f2.shape[0], f2.shape[1] * f2.shape[2], C), iis, jjs,
        c / (2.0 ** lvl), f2.shape[1], f2.shape[2])
        for lvl, f2 in enumerate(f2_levels)]
    return torch.cat(outs, dim=-1).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel B: multiview depth agreement
# ---------------------------------------------------------------------------

def depth_agree(dmaps, jxs, cu):
    """4-corner depth agreement.

    dmaps: (N, ht, wd) float32 disparity maps; jxs: (M, 6) int32 neighbour
    frame of each source frame; cu: (M, 24, npix) float32 packed per
    neighbour k as rows [u, v, 1/projected disparity, thresh] at 4k..4k+3.
    Returns (M, 6, npix) float32 of exact 0/1. On the card the call runs
    inside span ``cuda.depth_agree``.
    """
    if dmaps.device.type == "cpu":
        return depth_agree_plain(dmaps, jxs, cu)
    with span("cuda.depth_agree"):
        return _depth_agree_cuda(dmaps, jxs, cu)


def _depth_agree_cuda(dmaps, jxs, cu):
    if dmaps.device.type != "cuda":
        raise ValueError(f"depth_agree: unsupported device {dmaps.device}")
    N, ht, wd = dmaps.shape
    M, rows, npix = cu.shape
    if rows != 24 or jxs.shape != (M, 6) or npix != ht * wd:
        raise ValueError("depth_agree: shape mismatch")
    f32 = torch.float32
    _check_cuda("depth_agree", [dmaps, jxs, cu], [f32, torch.int32, f32])
    out = torch.empty((M, 6, npix), dtype=f32, device=dmaps.device)
    if M == 0:
        return out
    err = _lib().glorie_depth_agree(
        dmaps.data_ptr(), jxs.data_ptr(), cu.data_ptr(), out.data_ptr(),
        M, ht, wd, npix, _stream(dmaps.device))
    if err:
        raise RuntimeError(f"depth_agree: CUDA error {err}")
    DEPTH_AGREE.launches += 1
    return out


def depth_agree_plain(dmaps, jxs, cu):
    """Plain PyTorch version of ``depth_agree`` (corner gathers)."""
    N, ht, wd = dmaps.shape
    M, _, npix = cu.shape
    rec = cu.reshape(M, 6, 4, npix)
    u, v, izd, thr = rec.unbind(2)
    fu, fv = torch.floor(u), torch.floor(v)
    inb = (fu >= 0) & (fv >= 0) & (fu < wd - 1) & (fv < ht - 1)
    u0 = torch.where(inb, fu, torch.zeros_like(fu)).long()
    v0 = torch.where(inb, fv, torch.zeros_like(fv)).long()
    base = jxs.long()[:, :, None] * (ht * wd) + v0 * wd + u0
    flat = dmaps.reshape(-1)
    agree = torch.zeros_like(inb)
    for off in (0, 1, wd, wd + 1):
        c = flat[base + off]
        agree = agree | ((izd - 1.0 / c).abs() < thr)
    return (inb & agree).to(torch.float32)


# ---------------------------------------------------------------------------
# kernel C: one level's correlation lookup from feature stores
# ---------------------------------------------------------------------------

def lookup_level(f1, f2, iis, jjs, coords, hl: int, wl: int):
    """Windowed single-level correlation lookup.

    f1: (N, npix, 128) bf16 level-0 store; f2: (N2, hl*wl, 128) bf16 store
    of this level (``f1`` itself at level 0); iis/jjs: (E,) int32
    source/target frames; coords: (E, npix, 2) float32 [x, y] already in
    level units (NaN -> 0). Returns (E, npix, 49) float32, correlation
    scaled by 1/16, channel = a*7 + b (a: x offset).
    """
    if f1.device.type == "cpu":
        return lookup_level_plain(f1, f2, iis, jjs, coords, hl, wl)
    if f1.device.type != "cuda":
        raise ValueError(f"lookup_level: unsupported device {f1.device}")
    N, npix, C = f1.shape
    E = iis.shape[0]
    if C != CHANNELS or f2.dim() != 3 or f2.shape[1:] != (hl * wl, C):
        raise ValueError("lookup_level: needs 128-channel stores with "
                         "hl*wl rows in f2")
    if coords.shape != (E, npix, 2) or jjs.shape != (E,):
        raise ValueError("lookup_level: coords/jjs shape mismatch")
    if hl >= MAX_ROWS or wl >= MAX_COLS:
        raise ValueError("lookup_level: planes must be under "
                         f"{MAX_ROWS} x {MAX_COLS} cells")
    bf, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    _check_cuda("lookup_level", [f1, f2, iis, jjs, coords],
                [bf, bf, i32, i32, f32])
    out = torch.empty((E, npix, (2 * RADIUS + 1) ** 2), dtype=f32,
                      device=f1.device)
    if E == 0:
        return out
    err = _lib().glorie_lookup_level(
        f1.data_ptr(), f2.data_ptr(), hl, wl, iis.data_ptr(), jjs.data_ptr(),
        coords.data_ptr(), out.data_ptr(), E, npix, _stream(f1.device))
    if err:
        raise RuntimeError(f"lookup_level: CUDA error {err}")
    LOOKUP_LEVEL.launches += 1
    return out


def lookup_level_plain(f1, f2, iis, jjs, coords, hl: int, wl: int):
    """Plain PyTorch version of ``lookup_level``: per-edge correlation
    planes by ``bmm`` (fp32), then the separable hat-weight window. Edges
    go through 8 at a time to bound the planes' memory."""
    E, npix, _ = coords.shape
    c = torch.nan_to_num(coords.float())
    outs = [torch.empty((0, npix, (2 * RADIUS + 1) ** 2),
                        dtype=torch.float32, device=f1.device)]
    for s in range(0, E, 8):
        a = f1[iis[s:s + 8].long()].float()
        b = f2[jjs[s:s + 8].long(), :hl * wl].float()
        vol = torch.bmm(a, b.transpose(1, 2)) / 16.0
        outs.append(lookup_separable(vol.reshape(len(a), npix, hl, wl),
                                     c[s:s + 8]))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# kernels D and E: window lookup over precomputed correlation planes
# ---------------------------------------------------------------------------

def _launch_plane(kernel, planes, slots, coords, checked=False):
    """Checks, then kernel D (``slots`` None) or E; bumps ``kernel``'s
    count when it launches. ``checked``: the slots' range was checked on
    the host, so the device check (one sync) is skipped."""
    name = kernel.name
    if planes.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {planes.device}")
    S, hl, wl, npix = planes.shape
    E = coords.shape[0]
    if coords.shape != (E, npix, 2):
        raise ValueError(f"{name}: coords must be (E, {npix}, 2)")
    if hl * wl >= 2 ** 31 - PLANE_BAND:
        raise ValueError(f"{name}: planes must hold under "
                         f"2^31 - {PLANE_BAND} cells")
    tensors = [planes, coords] + ([] if slots is None else [slots])
    dtypes = [torch.bfloat16, torch.float32, torch.int32]
    _check_cuda(name, tensors, dtypes[:len(tensors)])
    out = torch.empty((E, npix, (2 * RADIUS + 1) ** 2), dtype=torch.float32,
                      device=planes.device)
    if E == 0:
        return out
    if slots is not None and not checked:
        check_slots(slots, S)
    err = _lib().glorie_lookup_plane(
        planes.data_ptr(), None if slots is None else slots.data_ptr(),
        coords.data_ptr(), out.data_ptr(), E, hl, wl, npix,
        _stream(planes.device))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    kernel.launches += 1
    return out


def lookup_plane(planes, coords):
    """Windowed lookup over correlation planes.

    planes: (E, hl, wl, npix) bf16, pixel-minor (``corr.all_pairs_corr_lanes``
    and its pooled levels); coords: (E, npix, 2) float32 [x, y] in level
    units (NaN -> 0). Returns (E, npix, 49) float32, channel = a*7 + b.
    """
    if planes.device.type == "cpu":
        return lookup_plane_plain(planes, coords)
    if planes.shape[0] != coords.shape[0]:
        raise ValueError("lookup_plane: one plane row per edge")
    return _launch_plane(LOOKUP_PLANE, planes, None, coords)


def check_slots(slots, S):
    """Raise unless every slot is a row of a capacity-``S`` store: kernel E
    reads ``slots[e]`` unchecked. ``slots``: a tensor (on the card, one
    device sync) or a host numpy array (no sync)."""
    if len(slots):
        if isinstance(slots, torch.Tensor):
            lo, hi = (int(v) for v in torch.aminmax(slots))
        else:
            lo, hi = int(slots.min()), int(slots.max())
        if lo < 0 or hi >= S:
            raise ValueError(f"lookup_plane_slots: slots in [{lo}, {hi}] "
                             f"outside a store of {S} rows")


def lookup_plane_slots(store, slots, coords, checked=False):
    """``lookup_plane`` with edge e reading plane row ``slots[e]`` of the
    (S, hl, wl, npix) bf16 ``store``; slots: (E,) int32, each in [0, S)
    (checked before the lookup; a slot outside raises ValueError). On the
    card that check costs a device sync; ``checked=True`` says the caller
    has already checked the same slots on the host (``check_slots`` on
    their numpy copy, as ``corr.lookup_pyramid`` does) and skips it."""
    if slots.shape != (coords.shape[0],):
        raise ValueError("lookup_plane_slots: one slot per edge")
    if store.device.type == "cpu":
        check_slots(slots, store.shape[0])
        return lookup_plane_slots_plain(store, slots, coords)
    return _launch_plane(LOOKUP_PLANE_SLOTS, store, slots, coords, checked)


def plane_sector_stats(coords, hl: int, wl: int, group: int = PLANE_GROUP):
    """Kernels D and E's sector rule on the host: a second copy of the rule
    in ``csrc/lookup_plane.cu``, a diagnostic only. Its constants are
    checked against the kernel's when the library loads; the rule itself
    is held only against a brute-force enumeration on the host.

    coords: (E, npix, 2) [x, y] in level units over (hl, wl) planes. A
    pixel's window starts at cell (floor(x) - 3, floor(y) - 3) of the
    cleaned coordinates (NaN -> 0, clamped to [-MARGIN, size + MARGIN]);
    its in-plane part is that 8x8 block clipped to the plane. Pixels
    ``group * k`` .. ``group * k + group - 1`` form sector group k (the last
    one may be short); at each cell that any of its pixels' windows touch,
    the group reads one sector of ``SECTOR_BYTES``.

    Returns {"groups": E * n_groups, "sectors": distinct (edge, group,
    cell) triples, "sector_bytes", "cells_per_group": their mean,
    "floor_bytes": the sectors plus the coords read and the float32
    output written once (the least traffic of a kernel that reads the
    planes in sectors)}."""
    E, npix, _ = coords.shape
    side = 2 * RADIUS + 2
    n_groups = -(-npix // group)
    cells = hl * wl
    gid = (torch.arange(npix, device=coords.device) // group).view(1, -1, 1)
    r = torch.arange(side, device=coords.device)
    sectors = 0
    for s in range(0, E, 8):       # 8 edges at a time bound the memory
        c = torch.nan_to_num(coords[s:s + 8].float())
        ox = torch.floor(c[..., 0].clamp(-MARGIN, wl + MARGIN)).long()
        oy = torch.floor(c[..., 1].clamp(-MARGIN, hl + MARGIN)).long()
        gx = ox[..., None] - RADIUS + r                     # (e, p, 8)
        gy = oy[..., None] - RADIUS + r
        ok = (((gy >= 0) & (gy < hl))[..., :, None]
              & ((gx >= 0) & (gx < wl))[..., None, :]).flatten(2)
        key = (gid * cells + (gy[..., :, None] * wl
                              + gx[..., None, :]).flatten(2))
        key = torch.where(ok, key, n_groups * cells).flatten(1)
        seen = torch.zeros((key.shape[0], n_groups * cells + 1),
                           dtype=torch.bool, device=coords.device)
        seen.scatter_(1, key, True)
        sectors += int(seen[:, :-1].sum())
    sector_bytes = sectors * SECTOR_BYTES
    out_bytes = E * npix * (2 * RADIUS + 1) ** 2 * 4
    return {"groups": E * n_groups, "sectors": sectors,
            "sector_bytes": sector_bytes,
            "cells_per_group": sectors / max(E * n_groups, 1),
            "floor_bytes": sector_bytes + coords.numel() * 4 + out_bytes}


def lookup_plane_plain(planes, coords):
    """Plain PyTorch version of ``lookup_plane``: the separable hat-weight
    window in float32 on the planes' own values, 8 edges at a time."""
    return lookup_plane_slots_plain(planes, None, coords)


def lookup_plane_slots_plain(store, slots, coords):
    """Plain PyTorch version of ``lookup_plane_slots`` (``slots`` None: row
    e for edge e). Gathers 8 plane rows at a time, never the whole set."""
    E, npix, _ = coords.shape
    c = torch.nan_to_num(coords.float())
    rows = (torch.arange(E, device=store.device) if slots is None
            else slots.long())
    outs = [torch.empty((0, npix, (2 * RADIUS + 1) ** 2),
                        dtype=torch.float32, device=store.device)]
    for s in range(0, E, 8):
        plane = store[rows[s:s + 8]].permute(0, 3, 1, 2)   # (e, p, hl, wl)
        outs.append(lookup_separable(plane, c[s:s + 8]))
    return torch.cat(outs)
