"""Correlation volumes and the windowed bilinear lookup.

Counterpart of ``glorie_slam_tpu/ops/corr.py``, in two parts:

* the feature-store path the tracker runs: ``pool_feat_levels``,
  ``prep_feat_pyramid`` and ``lookup_pyramid_feats``, through kernel A
  (``cuda_corr.lookup_pyramid``) for 4-level pyramids and kernel C
  (``cuda_corr.lookup_level``) per level otherwise. Correlating against
  2^l-pooled target features equals pooling the all-pairs volume over its
  target pixels, so no per-edge volume is ever built;
* the correlation-volume path, DROID's ``CorrBlock`` and ``AltCorrBlock``
  semantics: ``all_pairs_corr(_lanes)``, ``build_pyramid(_lanes)``,
  ``lookup_pyramid`` over pixel-minor planes (kernel D,
  ``cuda_corr.lookup_plane``, or kernel E, ``cuda_corr.lookup_plane_slots``,
  for a slot store), the slot-store ``CorrBlock`` and the streamed
  ``alt_corr_chunk``. It holds the feature-store path against an
  independent formulation.

Channel layout: per level the 7x7 window flattens x-offset-major
(channel a*7 + b), levels concatenated in order. The JAX package pads
pixel counts to TPU lane tiles (``padded_npix`` and the lookups' npix
padding); that is TPU tiling, and the port works on exactly ``h * w``
pixels.
"""

import numpy as np
import torch

from ..utils.buckets import bucket
from . import cuda_corr
from .cuda_corr import lookup_separable

RADIUS = cuda_corr.RADIUS
LEVELS = cuda_corr.LEVELS
ALT_TILE = 256      # source pixels per streamed tile of ``alt_corr_chunk``
_CHUNK = 16         # edges per float32 product in ``all_pairs_corr_lanes``
_BF = torch.bfloat16


def pool_feat_levels(f, num_levels: int = LEVELS):
    """Average-pool channel-last maps f (..., h, w, C) down the pyramid ->
    ``num_levels - 1`` maps (..., h/2^l, w/2^l, C). Two one-axis means (w,
    then h), each rounded to ``f``'s dtype, as in the JAX package."""
    outs = []
    for _ in range(num_levels - 1):
        *lead, h, w, C = f.shape
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        hs, ws = min(h2 * 2, h), min(w2 * 2, w)
        f = f[..., :hs, :ws, :]
        if ws == w2 * 2:
            f = f.reshape(*lead, hs, w2, 2, C).float().mean(-2).to(f.dtype)
        if hs == h2 * 2:
            f = f.reshape(*lead, h2, 2, w2, C).float().mean(-3).to(f.dtype)
        outs.append(f)
    return outs


def prep_feat_pyramid(fmaps, num_levels: int = LEVELS):
    """fmaps (N, h8, w8, C) bf16 -> (level-0 rows (N, h8*w8, C),
    pooled levels (N, h_l, w_l, C) ...)."""
    N, h8, w8, C = fmaps.shape
    flat = fmaps.reshape(N, h8 * w8, C)
    return (flat,) + tuple(pool_feat_levels(fmaps, num_levels))


def lookup_pyramid_feats(feat_pyr, iis, jjs, coords):
    """feat_pyr from ``prep_feat_pyramid``; iis/jjs (E,) source/target
    frames; coords (E, ht, wd, 2) level-0 [x, y] ->
    (E, ht, wd, L*49), levels concatenated, window x-major: bf16 from
    kernel A for 4 levels, float32 from kernel C (one launch per level)
    for any other count, as the JAX package returns."""
    E, ht, wd, _ = coords.shape
    flat = feat_pyr[0]
    N, npix, C = flat.shape
    iis = iis.to(torch.int32).contiguous()
    jjs = jjs.to(torch.int32).contiguous()
    c = coords.reshape(E, npix, 2).float().contiguous()
    if len(feat_pyr) == LEVELS:
        f2 = (flat.reshape(N, ht, wd, C),) + tuple(feat_pyr[1:])
        out = cuda_corr.lookup_pyramid(flat, f2, iis, jjs, c)
        return out.reshape(E, ht, wd, -1)
    outs = []
    for lvl, store in enumerate(feat_pyr):
        hl, wl = (ht, wd) if lvl == 0 else store.shape[1:3]
        f2 = store.reshape(store.shape[0], hl * wl, C).contiguous()
        outs.append(cuda_corr.lookup_level(flat, f2, iis, jjs,
                                           c / (2.0 ** lvl), hl, wl))
    return torch.cat(outs, dim=-1).reshape(E, ht, wd, -1)


# ---------------------------------------------------------------------------
# correlation-volume path
# ---------------------------------------------------------------------------

def all_pairs_corr(fmap1, fmap2):
    """All-pairs correlation <f1/4, f2/4> (reference corr.py:67-76).

    fmap1/fmap2: (E, C, ht, wd). Returns (E, ht*wd, ht, wd) in fmap dtype,
    accumulated in float32."""
    E, C, ht, wd = fmap1.shape
    f1 = fmap1.reshape(E, C, ht * wd).float() / 4.0
    f2 = fmap2.reshape(E, C, ht * wd).float() / 4.0
    corr = torch.bmm(f1.transpose(1, 2), f2)
    return corr.reshape(E, ht * wd, ht, wd).to(fmap1.dtype)


def all_pairs_corr_lanes(fmap1, fmap2):
    """All-pairs correlation in pixel-minor layout for kernels D and E.

    fmap1/fmap2: (E, C, ht, wd). Returns (E, ht, wd, ht*wd) bf16 with
    corr[e, h2, w2, p] = <f1[e, p], f2[e, (h2, w2)]> / 16, accumulated in
    float32, ``_CHUNK`` edges at a time (bounds the float32 temporary)."""
    E, C, ht, wd = fmap1.shape
    npix = ht * wd
    out = torch.empty((E, ht, wd, npix), dtype=_BF, device=fmap1.device)
    for s in range(0, E, _CHUNK):
        f1 = fmap1[s:s + _CHUNK].reshape(-1, C, npix).float() / 4.0
        f2 = fmap2[s:s + _CHUNK].reshape(-1, C, npix).float() / 4.0
        out[s:s + _CHUNK] = torch.bmm(f2.transpose(1, 2), f1).reshape(
            -1, ht, wd, npix)
    return out


def avg_pool2x2(x, dim=-2):
    """2x2 average pooling over dims ``dim`` and ``dim + 1`` (default the
    trailing two; odd trailing rows/cols are dropped), computed in
    float32, in ``x``'s dtype."""
    d = dim % x.ndim
    lead, (h, w), rest = x.shape[:d], x.shape[d:d + 2], x.shape[d + 2:]
    h2, w2 = h // 2, w // 2
    x2 = x.narrow(d, 0, h2 * 2).narrow(d + 1, 0, w2 * 2).reshape(
        *lead, h2, 2, w2, 2, *rest)
    return x2.float().mean(dim=(d + 1, d + 3)).to(x.dtype)


def build_pyramid(corr):
    """corr (E, npix, ht, wd) -> LEVELS levels (E, npix, ht/2^l, wd/2^l)."""
    pyramid = [corr]
    for _ in range(LEVELS - 1):
        pyramid.append(avg_pool2x2(pyramid[-1]))
    return pyramid


def build_pyramid_lanes(corr):
    """corr (E, hl, wl, npix) -> LEVELS levels (E, hl/2^l, wl/2^l, npix)."""
    pyramid = [corr]
    for _ in range(LEVELS - 1):
        pyramid.append(avg_pool2x2(pyramid[-1], dim=1))
    return pyramid


def lookup_gather(plane, coords):
    """Reference-semantics 4-corner gather lookup (for validation).
    plane (E, npix, hl, wl); coords (E, npix, 2) -> (E, npix, 49)."""
    E, npix, hl, wl = plane.shape
    rd = 2 * RADIUS + 1
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx, dy = x0 - fx, y0 - fy
    flat = plane.reshape(E, npix, hl * wl).float()
    out = torch.zeros((E, npix, rd, rd), dtype=torch.float32,
                      device=plane.device)
    for a in range(rd):
        for b in range(rd):
            for (cx, cy), wgt in (((0, 0), (1 - dx) * (1 - dy)),
                                  ((1, 0), dx * (1 - dy)),
                                  ((0, 1), (1 - dx) * dy),
                                  ((1, 1), dx * dy)):
                xi = fx.long() + a - RADIUS + cx
                yi = fy.long() + b - RADIUS + cy
                ok = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
                idx = yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)
                val = flat.gather(-1, idx[..., None])[..., 0]
                out[:, :, a, b] += torch.where(ok, val * wgt,
                                               torch.zeros_like(val))
    return out.reshape(E, npix, rd * rd)


def lookup_pyramid(pyramid, coords, slots=None):
    """Multi-level lookup over a pixel-minor pyramid.

    pyramid: levels (S, hl, wl, npix); coords (E, ht, wd, 2) level-0
    [x, y]. With ``slots`` (E,), edge e reads level row slots[e] (kernel
    E; S is the store's capacity); without, row e (kernel D, S == E).
    ``slots`` is an int32 tensor, whose range the kernel's wrapper checks
    (on the card, one device sync per level), or a host numpy array,
    checked here once and copied to the card through pinned memory
    without a sync (``CorrBlock``'s path). Returns (E, ht, wd, L*49)
    float32. On the card the kernels read bf16 planes, so a store of
    another dtype is cast first, as the TPU kernels' wrappers do."""
    E, ht, wd, _ = coords.shape
    c = coords.reshape(E, ht * wd, 2).float().contiguous()
    dev = pyramid[0].device
    checked = isinstance(slots, np.ndarray)
    if checked:
        cuda_corr.check_slots(slots, pyramid[0].shape[0])
        slots = torch.from_numpy(slots.astype(np.int32))
        if dev.type == "cuda":
            slots = slots.pin_memory().to(dev, non_blocking=True)
    outs = []
    for lvl, plane in enumerate(pyramid):
        if plane.device.type == "cuda":
            plane = plane.to(_BF)
        cl = c / (2.0 ** lvl)
        if slots is None:
            outs.append(cuda_corr.lookup_plane(plane, cl))
        else:
            outs.append(cuda_corr.lookup_plane_slots(plane, slots, cl,
                                                     checked=checked))
    return torch.cat(outs, dim=-1).reshape(E, ht, wd, -1)


class CorrBlock:
    """All-pairs correlation pyramid (reference corr.py:25-65) in a
    fixed-capacity slot store.

    The per-edge pyramid rows live at stable slot indices of a capacity-S
    store: removing edges is host free-list bookkeeping, adding edges
    writes only the new rows, and the lookup reads ``self.slots`` (compact
    edge order -> store row) through kernel E, so the store is never
    gathered."""

    def __init__(self, fmap1, fmap2):
        """fmap1/fmap2: (E, C, ht, wd) source/target features per edge;
        the store holds bf16 levels at capacity ``bucket(E)``."""
        E = fmap1.shape[0]
        cap = bucket(max(E, 1))
        corr = all_pairs_corr_lanes(fmap1, fmap2)
        self.pyramid = tuple(self._padded(lv, cap)
                             for lv in build_pyramid_lanes(corr))
        self.capacity = cap
        self.slots = np.arange(E)
        self._free = list(range(cap - 1, E - 1, -1))   # stack of free rows

    @staticmethod
    def _padded(level, cap):
        extra = cap - level.shape[0]
        if extra <= 0:
            return level
        return torch.cat([level, level.new_zeros((extra,)
                                                 + level.shape[1:])])

    def __call__(self, coords):
        """coords (E, ht, wd, 2) -> (E, ht, wd, L*49) float32. The host
        slots are range-checked on the host: the call makes no device
        sync."""
        return lookup_pyramid(self.pyramid, coords, self.slots)

    def _grow(self, need):
        new_cap = bucket(self.capacity + need)
        self.pyramid = tuple(self._padded(p, new_cap) for p in self.pyramid)
        self._free.extend(range(new_cap - 1, self.capacity - 1, -1))
        self.capacity = new_cap

    def cat(self, other):
        """Append another block's edges: write its rows into free slots."""
        src = other.slots
        if len(src) > len(self._free):
            self._grow(len(src) - len(self._free))
        dst = np.array([self._free.pop() for _ in range(len(src))],
                       np.int64)
        dev = self.pyramid[0].device
        src_d = torch.as_tensor(src, dtype=torch.long, device=dev)
        dst_d = torch.as_tensor(dst, dtype=torch.long, device=dev)
        for p, q in zip(self.pyramid, other.pyramid):
            p[dst_d] = q[src_d]
        self.slots = np.concatenate([self.slots, dst])
        return self

    def __getitem__(self, mask_or_index):
        """Keep the edges selected by a boolean mask or an index array;
        the others' rows go back to the free list."""
        keep = np.asarray(mask_or_index)
        if keep.dtype != bool:
            sel = np.zeros(len(self.slots), bool)
            sel[keep] = True
            freed = self.slots[~sel]
        else:
            freed = self.slots[~keep]
        self.slots = self.slots[keep]
        self._free.extend(freed.tolist())
        return self


def alt_corr_chunk(fmaps, coords, ii, jj):
    """Low-memory correlation for a chunk of edges (reference corr.py
    :97-145, ``AltCorrBlock``): the all-pairs volume is never built.

    fmaps: (N, C, ht, wd) frame features; coords (Ec, ht, wd, 2) level-0
    [x, y]; ii/jj (Ec,) source/target frames. Level-l correlations are
    taken against 2^l-pooled target features (pooling commutes with the
    dot product), and source pixels stream through in tiles of
    ``ALT_TILE``: per tile only an (Ec, hl, wl, ALT_TILE) bf16 plane
    exists, looked up by kernel D. Returns (Ec, ht, wd, L*49) float32, as
    ``CorrBlock``."""
    Ec, ht, wd = coords.shape[:3]
    npix = ht * wd
    C = fmaps.shape[1]
    ii = torch.as_tensor(ii, device=fmaps.device).long()
    jj = torch.as_tensor(jj, device=fmaps.device).long()
    f2_levels, shapes = [], []
    f2 = fmaps
    for _ in range(LEVELS):
        hl, wl = f2.shape[2:]
        shapes.append((hl, wl))
        f2_levels.append((f2[jj].float() / 4.0).reshape(Ec, C, hl * wl))
        f2 = avg_pool2x2(f2)
    f1 = (fmaps[ii].float() / 4.0).reshape(Ec, C, npix)
    c = coords.reshape(Ec, npix, 2).float()
    tiles = []
    for s in range(0, npix, ALT_TILE):
        f1_t = f1[:, :, s:s + ALT_TILE]
        c_t = c[:, s:s + ALT_TILE].contiguous()
        outs = []
        for lvl, (hl, wl) in enumerate(shapes):
            plane = torch.bmm(f2_levels[lvl].transpose(1, 2), f1_t)
            plane = plane.reshape(Ec, hl, wl, f1_t.shape[2]).to(_BF)
            outs.append(cuda_corr.lookup_plane(plane, c_t / (2.0 ** lvl)))
        tiles.append(torch.cat(outs, dim=-1))
    return torch.cat(tiles, dim=1).reshape(Ec, ht, wd, -1)
