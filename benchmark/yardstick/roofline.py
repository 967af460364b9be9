"""Operations and bytes that a kernel's inputs need, and its least time.

Counted from each call's inputs, whatever computes it: a later kernel that
replaces one of these is judged by the same count. Each input byte is read
once and each output byte written once.

* ``lookup_pyramid`` (kernel A's function): the feature-store rows read
  once (every source frame's level-0 rows, and the distinct target rows
  that windows reach inside each level's plane; at level 0 the two sides
  share one store, so a row used on either side counts once), the
  coordinates, the edge indices and the bf16 output; operations: a 128-term
  dot product (2 x 128) for every window cell that lands inside its level's
  plane. Peak: bf16.
* ``depth_agree`` (kernel B's function): the packed reprojections, the
  corner disparities that in-bounds projections read, the neighbour
  indices and the 0/1 output; operations: 8 per in-bounds (source,
  neighbour, pixel) (four divisions and four compares). Peak: float32.
"""

import torch

from .peaks import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S


def least_s(nbytes, flops, flop_rate):
    """The least time on the card: the larger of bytes over the memory rate
    and operations over ``flop_rate``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def _windows(coords, hl, wl):
    """Cell indices y * wl + x (E, npix, 8, 8) of the 8x8 windows around
    ``coords`` (level units, NaN -> 0) and their in-plane mask."""
    c = torch.nan_to_num(coords.float())
    r = torch.arange(8, device=coords.device)
    gx = torch.floor(c[..., 0]).long()[..., None] - 3 + r
    gy = torch.floor(c[..., 1]).long()[..., None] - 3 + r
    ok = (((gy >= 0) & (gy < hl))[..., :, None]
          & ((gx >= 0) & (gx < wl))[..., None, :])
    return gy[..., :, None] * wl + gx[..., None, :], ok


def lookup_pyramid(iis, jjs, coords, level_dims, channels=128, shared=True,
                   out_bytes=2):
    """(bytes, operations) of one 4-level lookup; ``level_dims`` the (h, w)
    of each level, coords (E, npix, 2) level-0 pixel coordinates.

    Bytes: every source frame's level-0 row (one per pixel), each distinct
    target row that an in-plane window cell reads at each level (at level
    0 the two sides share one store when ``shared``: a row read on both
    sides counts once), the coordinates, the edge indices and the output.
    Operations: a ``channels``-term dot product (2 x channels) for every
    in-plane window cell."""
    E, npix, _ = coords.shape
    row = channels * 2                              # bf16 store rows
    src = torch.unique(iis.long())
    jj = jjs.long()[:, None, None, None]
    src_rows = src.numel() * npix
    rows, cells = src_rows, 0
    for lvl, (h, w) in enumerate(level_dims):
        cell, ok = _windows(coords / 2.0 ** lvl, h, w)
        cells += int(ok.sum())
        touched = torch.unique((jj * (h * w) + cell)[ok])
        if lvl == 0 and shared:
            # rows of source frames are read anyway
            rows += int((~torch.isin(touched // npix, src)).sum())
        else:
            rows += touched.numel()
    nbytes = (rows * row + coords.numel() * 4 + 2 * E * 4
              + E * npix * len(level_dims) * 49 * out_bytes)
    return nbytes, 2 * channels * cells


def lookup_pyramid_least_s(*args, **kw):
    nbytes, flops = lookup_pyramid(*args, **kw)
    return least_s(nbytes, flops, BF16_FLOPS)


def depth_agree(jxs, cu, ht, wd):
    """(bytes, operations) of one agreement call: ``jxs`` (M, 6) neighbour
    frames, ``cu`` (M, 24, npix) the packed [u, v, 1/disparity, thresh] per
    neighbour, at an ht x wd grid. Every (u, v) is read; the inverse
    disparity, the threshold and the 4 corner disparities only where the
    projection lands inside the neighbour (each distinct corner pixel once);
    the 0/1 output is written whole. Operations: 8 per in-bounds (source,
    neighbour, pixel): four divisions and four compares."""
    M, npix = cu.shape[0], ht * wd
    u, v = cu.reshape(M, 6, 4, npix)[:, :, :2].unbind(2)
    fu, fv = torch.floor(u), torch.floor(v)
    inb = (fu >= 0) & (fv >= 0) & (fu < wd - 1) & (fv < ht - 1)
    base = (jxs.long()[:, :, None] * npix + fv.long() * wd + fu.long())[inb]
    corners = torch.unique(torch.cat([base, base + 1, base + wd,
                                      base + wd + 1])).numel()
    n_in = int(inb.sum())
    out = M * 6 * npix
    nbytes = (out * 8 + n_in * 8 + corners * 4 + jxs.numel() * 4
              + out * 4)
    return nbytes, 8 * n_in


def depth_agree_least_s(*args):
    nbytes, flops = depth_agree(*args)
    return least_s(nbytes, flops, FP32_FLOPS)
