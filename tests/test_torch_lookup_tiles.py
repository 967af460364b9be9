"""Kernel A's box rule (``cuda_corr.tile_box_spans``, which the kernel in
``csrc/lookup_pyramid.cu`` mirrors) against a brute-force enumeration of
every pixel's in-plane window cells. Host code only: no card, no JAX.
These tests hold the host copy of the rule, not the kernel: the kernel's
own box is held only by its card tests against the plain version
(``tests/test_torch_cuda.py``), and the host copy shares only its
constants with it (``TILE``, ``RUN``, ``MARGIN``, checked against the
kernel when the library loads).

A tile's box at a level must hold every in-plane 8x8 window cell of the
tile's pixels, and on each row span no more than from the leftmost to the
rightmost of them: pixels off the plane or off the pixel grid add nothing,
a NaN centre (read as 0) adds only its own cells' rows, and an empty level
has an empty box.
"""

import math

import numpy as np
import pytest
import torch

from glorie_slam_tpu_torch.ops import cuda_corr


def _dims(h0, w0, levels=4):
    return [(h0 >> lvl, w0 >> lvl) for lvl in range(levels)]


def _coords(kind, E, h0, w0, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h0), np.arange(w0), indexing="ij")
    base = np.stack([xx, yy], -1).reshape(1, h0 * w0, 2).astype(np.float32)
    if kind == "incoherent":
        c = rng.uniform(0, 1, (E, h0 * w0, 2)) * [w0, h0]
    else:
        c = base + 1.5 * rng.normal(size=(E, h0 * w0, 2))
    c = c.astype(np.float32)
    if kind == "outliers":
        c[:, ::11] = np.nan
        c[:, 5::13] += 60.0
        c[:, 7::17] -= 45.0
    return torch.from_numpy(c)


def _needed(coords, dims, tile):
    """{(edge, tile, level): {(x, y), ...}} of in-plane window cells, one
    pixel at a time."""
    (h0, w0), (th, tw) = dims[0], tile
    ntx = -(-w0 // tw)
    c = coords.numpy()
    out = {}
    for e in range(c.shape[0]):
        for p in range(h0 * w0):
            gy, gx = divmod(p, w0)
            tile_id = (gy // th) * ntx + gx // tw
            for lvl, (hl, wl) in enumerate(dims):
                cells = out.setdefault((e, tile_id, lvl), set())
                org = []
                for v, size in zip(c[e, p], (wl, hl)):
                    v = np.float32(v) * np.float32(1.0 / 2 ** lvl)
                    v = 0.0 if math.isnan(v) else min(max(v, -16.0),
                                                      size + 16.0)
                    org.append(math.floor(v) - 3)
                for dy in range(8):
                    for dx in range(8):
                        x, y = org[0] + dx, org[1] + dy
                        if 0 <= x < wl and 0 <= y < hl:
                            cells.add((x, y))
    return out


def _box(spans, e, tile_id, lvl):
    xlo, xhi = spans[lvl]
    rows = {}
    for y in range(xlo.shape[-1]):
        lo, hi = int(xlo[e, tile_id, y]), int(xhi[e, tile_id, y])
        if hi >= lo:
            rows[y] = (lo, hi)
    return rows


@pytest.mark.parametrize("kind,h0,w0,tile", [
    ("smooth", 16, 24, (8, 8)), ("incoherent", 16, 24, (8, 8)),
    ("outliers", 16, 24, (8, 8)), ("smooth", 13, 21, (8, 8)),
    ("outliers", 13, 21, (1, 64))])
def test_box_is_the_row_spans_of_the_window_cells(kind, h0, w0, tile):
    coords = _coords(kind, 2, h0, w0)
    dims = _dims(h0, w0)
    spans = cuda_corr.tile_box_spans(coords, dims, tile)
    needed = _needed(coords, dims, tile)
    n_tiles = spans[0][0].shape[1]
    stats = cuda_corr.tile_box_stats(coords, dims, tile)
    assert stats["tiles"] == 2 * n_tiles
    for lvl in range(len(dims)):
        total = 0
        for e in range(2):
            for tile_id in range(n_tiles):
                cells = needed.get((e, tile_id, lvl), set())
                rows = _box(spans, e, tile_id, lvl)
                assert set(rows) == {y for _, y in cells}
                for x, y in cells:
                    assert rows[y][0] <= x <= rows[y][1]
                for y, (lo, hi) in rows.items():
                    assert (lo, y) in cells and (hi, y) in cells
                    total += hi - lo + 1
        assert stats["box_cells"][lvl] == pytest.approx(
            total / (2 * n_tiles))


def test_off_plane_and_nan_pixels_do_not_widen_the_box():
    h0, w0 = 16, 24
    dims = _dims(h0, w0)
    coords = _coords("smooth", 1, h0, w0)
    p_nan = 12 * w0 + 20                      # tile (1, 2) of 2 x 3 tiles
    gone = coords.clone()                     # the pixels taken out
    gone[0, [9, 30, p_nan]] = 1e4
    ref = cuda_corr.tile_box_spans(gone, dims)

    off = gone.clone()
    off[0, 9] = torch.tensor([w0 + 60.0, 3.0])     # right of the plane
    off[0, 30] = torch.tensor([-45.0, -45.0])      # above and left of it
    got = cuda_corr.tile_box_spans(off, dims)
    for (xlo, xhi), (rlo, rhi) in zip(got, ref):
        assert torch.equal(xlo, rlo) and torch.equal(xhi, rhi)

    nan = gone.clone()
    nan[0, p_nan] = float("nan")              # reads as (0, 0)
    got = cuda_corr.tile_box_spans(nan, dims)
    rows, old = _box(got, 0, 5, 0), _box(ref, 0, 5, 0)
    for y in range(h0):
        if y <= 4:                            # the NaN window's rows 0..4
            hi = max(4, old[y][1]) if y in old else 4
            assert rows[y] == (0, hi)
        else:
            assert rows.get(y) == old.get(y)


@pytest.mark.parametrize("empty", [(0, 1), (1, 0), (0, 0)])
def test_empty_levels_give_empty_boxes(empty):
    h0, w0 = 6, 8
    dims = _dims(h0, w0)[:3] + [empty]
    coords = _coords("smooth", 2, h0, w0)
    spans = cuda_corr.tile_box_spans(coords, dims)
    xlo, xhi = spans[3]
    assert xlo.shape == (2, 1, empty[0])
    assert not bool((xhi >= xlo).any())
    stats = cuda_corr.tile_box_stats(coords, dims)
    assert stats["box_cells"][3] == 0.0 and stats["runs"][3] == 0.0
    assert stats["box_cells"][0] > 0.0
