"""Kernels D and E's sector rule (``cuda_corr.plane_sector_stats``, which
the kernel in ``csrc/lookup_plane.cu`` mirrors) against a brute-force
enumeration of every pixel's in-plane window cells. Host code only: no
card, no JAX. These tests hold the host copy of the rule, not the kernel:
the kernel's own reads are held only by its card tests against the plain
version (``tests/test_torch_cuda.py``), and the host copy shares only its
constants with it (``PLANE_GROUP``, ``MARGIN``, checked against the kernel
when the library loads).

A sector group is 16 consecutive pixels (the last one may be short); it
reads one 32-byte sector at every cell that any of its pixels' 8x8
windows touches inside the plane. NaN centres read as 0, far-off centres
touch nothing, and an empty level touches nothing.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from glorie_slam_tpu_torch.ops import cuda_corr


def _coords(kind, E, npix, hl, wl, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (E, npix, 2)) * [wl + 12.0, hl + 12.0] - 6.0
    c = c.astype(np.float32)
    if kind == "outliers":
        c[:, ::7] = np.nan                       # NaN centres
        c[:, 3::5] += 60.0                       # far off the plane
        c[:, 4::9] -= 45.0
        c[:, 2::11, 0] = np.nan                  # one NaN component
    return torch.from_numpy(c)


def _brute(coords, hl, wl, group):
    """Distinct in-plane (edge, group, cell) triples, one pixel at a time."""
    c = coords.numpy()
    E, npix, _ = c.shape
    sectors = 0
    for e in range(E):
        for g0 in range(0, npix, group):
            cells = set()
            for p in range(g0, min(g0 + group, npix)):
                org = []
                for v, size in zip(c[e, p], (wl, hl)):
                    v = 0.0 if math.isnan(v) else min(max(float(v), -16.0),
                                                      size + 16.0)
                    org.append(math.floor(v) - 3)
                for dy in range(8):
                    for dx in range(8):
                        x, y = org[0] + dx, org[1] + dy
                        if 0 <= x < wl and 0 <= y < hl:
                            cells.add((x, y))
            sectors += len(cells)
    return sectors


@pytest.mark.parametrize("kind,E,npix,hl,wl", [
    ("uniform", 3, 64, 9, 13),        # whole groups
    ("outliers", 3, 37, 9, 13),       # NaN and far-off centres; 37 = 2*16+5
    ("uniform", 2, 48, 5, 10),        # a 5x10 level
    ("outliers", 2, 21, 5, 10),
    ("uniform", 2, 20, 0, 3),         # an empty level
])
@pytest.mark.parametrize("group", [cuda_corr.PLANE_GROUP, 64])
def test_sector_stats_match_brute_force(kind, E, npix, hl, wl, group):
    coords = _coords(kind, E, npix, hl, wl)
    st = cuda_corr.plane_sector_stats(coords, hl, wl, group=group)
    want = _brute(coords, hl, wl, group)
    n_groups = -(-npix // group)
    assert st["groups"] == E * n_groups
    assert st["sectors"] == want
    assert st["sector_bytes"] == 32 * want
    assert st["cells_per_group"] == pytest.approx(want / (E * n_groups))
    assert st["floor_bytes"] == 32 * want + E * npix * 2 * 4 + E * npix * 196
    if hl == 0:
        assert want == 0


def test_a_sector_holds_one_group_of_bf16():
    assert cuda_corr.PLANE_GROUP * 2 == cuda_corr.SECTOR_BYTES == 32


def test_sector_figures_of_chip_smoke_inputs():
    """The sector bytes of chip_smoke's D/E inputs at level 0 (40x80, 96
    edges): its seeded kernels-phase coordinates (3-pixel noise, NaN and
    off-plane centres) and its smooth flow, which follows the "smooth"
    rule of the card tests' ``_flow``."""
    from test_torch_cuda import _flow

    _, _, _, coords = chip_smoke.edge_inputs("cpu")
    st = cuda_corr.plane_sector_stats(coords, 40, 80)
    assert round(st["sector_bytes"] / 1e6, 1) == 191.4
    smooth = chip_smoke.smooth_coords()
    torch.testing.assert_close(
        smooth, _flow(torch.Generator().manual_seed(1), "smooth", 96, 40, 80),
        atol=0, rtol=0)
    st = cuda_corr.plane_sector_stats(smooth, 40, 80)
    assert round(st["sector_bytes"] / 1e6, 1) == 101.4
