"""Pixel sampling for the mapping optimisation, on the host.

Counterpart of ``glorie_slam_tpu/mapping/sampling.py`` (reference
src/utils/common.py:56-199). It stays numpy, drawing from the mapper's
``np.random.default_rng``, so that for one seed the port samples the same
pixels as the JAX package, call for call.
"""

import numpy as np

_LUMA = np.array([0.2125, 0.7154, 0.0721])


def sobel_grad_mag(gray):
    """Colour-gradient magnitude as skimage's sobel_h / sobel_v (3x3 Sobel
    over 4, edge padding), float64."""
    g = np.pad(gray, 1, mode="edge").astype(np.float64)
    gy = ((g[:-2, :-2] + 2 * g[:-2, 1:-1] + g[:-2, 2:])
          - (g[2:, :-2] + 2 * g[2:, 1:-1] + g[2:, 2:])) / 4.0
    gx = ((g[:-2, 2:] + 2 * g[1:-1, 2:] + g[2:, 2:])
          - (g[:-2, :-2] + 2 * g[1:-1, :-2] + g[2:, :-2])) / 4.0
    return np.sqrt(gx * gx + gy * gy)


def dynamic_radius_maps(gt_color, cfg):
    """Per-pixel add and query radii (H, W) float32 from the colour
    gradient (reference mapper.py:767-784: linear over [0, 0.01, thresh])."""
    pc = cfg["pointcloud"]
    ratio = pc["radius_query_ratio"]
    thresh = pc["color_grad_threshold"]
    gray = np.asarray(gt_color) @ _LUMA
    mag = np.clip(sobel_grad_mag(gray), 0.0, thresh)
    xs = np.array([0.0, 0.01, thresh])
    r_add = np.interp(mag, xs, [pc["radius_add_max"], pc["radius_add_max"],
                                pc["radius_add_min"]])
    r_query = np.interp(mag, xs, [ratio * pc["radius_add_max"],
                                  ratio * pc["radius_add_max"],
                                  ratio * pc["radius_add_min"]])
    return r_add.astype(np.float32), r_query.astype(np.float32)


def _take(pick, H, W, depth, color):
    j, i = np.unravel_index(pick, (H, W))        # j = row (v), i = col (u)
    return (i.astype(np.int32), j.astype(np.int32),
            np.asarray(depth).reshape(-1)[pick].astype(np.float32),
            np.asarray(color).reshape(-1, 3)[pick].astype(np.float32))


def sample_pixels(rng, n, H, W, depth, color, mask=None, edge=0):
    """n pixels drawn uniformly with replacement from the valid region
    (reference common.py:56-117) -> (i (n,), j (n,), depth (n,),
    color (n, 3)) numpy."""
    if mask is None:
        mask = np.ones((H, W), bool)
    else:
        mask = np.asarray(mask).astype(bool)
    if edge > 0:
        m = np.zeros_like(mask)
        m[edge:-edge, edge:-edge] = mask[edge:-edge, edge:-edge]
        mask = m
    valid = np.flatnonzero(mask)
    if len(valid) == 0:
        valid = np.arange(H * W)
    pick = valid[rng.integers(0, len(valid), size=n)]
    return _take(pick, H, W, depth, color)


def sample_pixels_with_grad(rng, n, H, W, depth, color, mask=None):
    """n pixels drawn among the 5n of highest colour gradient (reference
    common.py get_samples_with_pixel_grad)."""
    mag = sobel_grad_mag(np.asarray(color) @ _LUMA)
    if mask is not None:
        mag = np.where(np.asarray(mask), mag, -1.0)
    flat = mag.reshape(-1)
    k = min(5 * n, flat.size)
    top = np.argpartition(-flat, k - 1)[:k]
    top = top[flat[top] > 0]
    if len(top) == 0:
        return sample_pixels(rng, n, H, W, depth, color, mask)
    pick = top[rng.integers(0, len(top), size=min(n, len(top)))]
    return _take(pick, H, W, depth, color)
