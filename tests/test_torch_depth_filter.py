"""Port parity: kernel B's module (ops/depth_filter.py) and ops/distance.py.

Kernel B's output is exact 0/1. The port packs [u, v, 1/projected
disparity, thresh] as the JAX package's full-resolution path does, and
both sides compare |izd - 1/c| < thr in float32, so agreement counts match
exactly except for pixels whose |izd - 1/c| lies within float32 rounding
of thr; the tests allow at most 0.5% such pixels. The frame distance is a
mean over pixels of float32 flow magnitudes (1e-4 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.geom import lie as jlie
from glorie_slam_tpu.ops import depth_filter as jdf, distance as jdist, \
    pallas_corr
from glorie_slam_tpu_torch.ops import cuda_corr, depth_filter, distance
from torch_parity import n, random_poses, t


def _scene(seed, N=8, h=16, w=24, jump=True):
    rng = np.random.default_rng(seed)
    poses = jlie.exp(jnp.asarray(np.cumsum(random_poses(rng, N, 0.03), 0)))
    d = 0.5 + 0.4 * rng.random((N, h, w))
    if jump:
        d[:, :, w // 2:] *= 3.0
    intr = np.array([w * 0.8, w * 0.8, w / 2, h / 2], np.float32)
    return poses, d.astype(np.float32), intr


def test_agreement_plain_matches_pallas_interpret():
    poses, disps, intr = _scene(0)
    N, h, w = disps.shape
    inds = np.array([0, 3, 7])
    thr = np.full(3, 0.05, np.float32)
    jx, in_range, cu = depth_filter.pack_agreement_inputs(
        t(n(poses)), t(disps), t(intr), torch.as_tensor(inds), t(thr))
    out = cuda_corr.depth_agree_plain(t(disps), jx, cu)
    npix = h * w
    pad = (-npix) % pallas_corr.PLANE
    cu_p = np.concatenate([n(cu), np.zeros((3, 24, pad), np.float32)], 2)
    ref = pallas_corr.depth_agree_pallas(
        jnp.asarray(disps), jnp.asarray(n(jx)), jnp.asarray(cu_p), h, w,
        vband=8, uband=16, interpret=True)[:, :, :npix]
    np.testing.assert_array_equal(n(out), n(ref))
    assert set(np.unique(n(out))) <= {0.0, 1.0}


@pytest.mark.parametrize("h,w", [(6, 8), (16, 24)])
def test_depth_filter_counts_match_jax(h, w):
    poses, disps, intr = _scene(1, h=h, w=w)
    inds = np.arange(disps.shape[0])
    thr = np.full(len(inds), 0.05, np.float32)
    ref = jdf.depth_filter(poses, jnp.asarray(disps), jnp.asarray(intr),
                           jnp.asarray(inds), jnp.asarray(thr))
    out = depth_filter.depth_filter(t(n(poses)), t(disps), t(intr),
                                    torch.as_tensor(inds), t(thr), chunk=3)
    assert np.mean(n(out) != n(ref)) <= 0.005


def test_frame_distance_matches_jax():
    poses, disps, intr = _scene(2, jump=False)
    ii = np.array([0, 1, 2, 5, 7, 3])
    jj = np.array([1, 0, 4, 2, 6, 3])
    for beta in (0.3, 0.6):
        ref = jdist.frame_distance_bidirectional(
            poses, jnp.asarray(disps), jnp.asarray(intr), jnp.asarray(ii),
            jnp.asarray(jj), beta)
        out = distance.frame_distance_bidirectional(
            t(n(poses)), t(disps), t(intr), torch.as_tensor(ii),
            torch.as_tensor(jj), beta)
        np.testing.assert_allclose(n(out), n(ref), rtol=1e-4, atol=1e-5)
