"""The tracking path's CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``glorie_slam_tpu/ops/pallas_corr.py``. Two kernels:

* ``lookup_pyramid`` (kernel A, ``csrc/lookup_pyramid.cu``) replaces
  ``lookup_feats_pyramid_pallas`` (pallas_corr.py:363, pallas_call :412):
  the 4-level 7x7 bilinear correlation lookup computed from feature stores.
  At the slice's shapes its least time on the card is set by bytes (the
  bf16 output dominates); this version runs its 4*64*128 MACs per edge and
  pixel on CUDA cores, which limits it well above that.
* ``depth_agree`` (kernel B, ``csrc/depth_agree.cu``) replaces
  ``depth_agree_pallas`` (pallas_corr.py:644, pallas_call :678): the
  4-corner multiview depth-agreement test. Bound on the card: bytes.

Each wrapper takes its plain version for tensors on the CPU (the tests and
CPU runs) and, for tensors on a CUDA device, launches the kernel or raises;
there is no fallback from one to the other. Each kernel has a launch
counter (``LOOKUP_PYRAMID.launches``, ``DEPTH_AGREE.launches``) that its
wrapper bumps once per launch and nowhere else.
"""

import ctypes
from dataclasses import dataclass

import torch

from .. import build

RADIUS = 3
LEVELS = 4
CHANNELS = 128


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
KERNELS = (LOOKUP_PYRAMID, DEPTH_AGREE)

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
    """
    if f1.device.type == "cpu":
        return lookup_pyramid_plain(f1, f2_levels, iis, jjs, coords)
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


def lookup_pyramid_plain(f1, f2_levels, iis, jjs, coords):
    """Plain PyTorch version of ``lookup_pyramid``: per-edge correlation
    planes by ``bmm`` (fp32), then the separable hat-weight window. Edges
    go through 8 at a time to bound the planes' memory."""
    E, npix, _ = coords.shape
    rd = 2 * RADIUS + 1
    c = torch.nan_to_num(coords.float())
    outs = []
    for s in range(0, E, 8):
        ii = iis[s:s + 8].long()
        jj = jjs[s:s + 8].long()
        cs = c[s:s + 8]
        a = f1[ii].float()
        levels = []
        for lvl, f2 in enumerate(f2_levels):
            _, hl, wl, C = f2.shape
            b = f2[jj].reshape(len(jj), hl * wl, C).float()
            vol = torch.bmm(a, b.transpose(1, 2)) / 16.0
            vol = vol.reshape(len(jj), npix, hl, wl)
            pos = cs / (2.0 ** lvl)
            wx = _hat_weights(pos[..., 0], wl)          # (e, p, wl, rd)
            wy = _hat_weights(pos[..., 1], hl)          # (e, p, hl, rd)
            tmp = torch.einsum("ephw,ephb->epbw", vol, wy)
            win = torch.einsum("epbw,epwa->epab", tmp, wx)
            levels.append(win.reshape(len(jj), npix, rd * rd))
        outs.append(torch.cat(levels, dim=-1))
    if not outs:
        return torch.empty((0, npix, LEVELS * rd * rd), dtype=torch.bfloat16,
                           device=f1.device)
    return torch.cat(outs, dim=0).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel B: multiview depth agreement
# ---------------------------------------------------------------------------

def depth_agree(dmaps, jxs, cu):
    """4-corner depth agreement.

    dmaps: (N, ht, wd) float32 disparity maps; jxs: (M, 6) int32 neighbour
    frame of each source frame; cu: (M, 24, npix) float32 packed per
    neighbour k as rows [u, v, 1/projected disparity, thresh] at 4k..4k+3.
    Returns (M, 6, npix) float32 of exact 0/1.
    """
    if dmaps.device.type == "cpu":
        return depth_agree_plain(dmaps, jxs, cu)
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
