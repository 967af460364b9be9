"""Correlation lookup from per-frame feature stores (the tracker's hot op).

Counterpart of the feature-store path of ``glorie_slam_tpu/ops/corr.py``:
``pool_feat_levels``, ``prep_feat_pyramid`` and ``lookup_pyramid_feats``,
which goes through kernel A (``cuda_corr.lookup_pyramid``). Correlating
against 2^l-pooled target features equals pooling the all-pairs volume
over its target pixels, so no per-edge volume is ever built.

The JAX package pads the level-0 store's pixel rows to a TPU lane tile
(``padded_npix``); that padding is TPU tiling and the port's stores hold
exactly ``h8 * w8`` rows.
"""

import torch

from . import cuda_corr

RADIUS = cuda_corr.RADIUS
LEVELS = cuda_corr.LEVELS


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
    (E, ht, wd, 196) bf16, levels concatenated, window x-major."""
    E, ht, wd, _ = coords.shape
    flat = feat_pyr[0]
    N, npix, C = flat.shape
    f2 = (flat.reshape(N, ht, wd, C),) + tuple(feat_pyr[1:])
    out = cuda_corr.lookup_pyramid(
        flat, f2, iis.to(torch.int32).contiguous(),
        jjs.to(torch.int32).contiguous(),
        coords.reshape(E, npix, 2).float().contiguous())
    return out.reshape(E, ht, wd, -1)
