"""Port parity: geom/ba.py (DBA Gauss-Newton with Schur complement, the
DSPO scale/shift solve, the damped Cholesky) against the JAX package.

The port places Hessian blocks with index_add_ and the JAX package with
one-hot products at precision HIGHEST; sums differ in order only. After
two GN iterations poses agree to 1e-4 and disparities to 1e-3 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.geom import ba as jba, lie as jlie, \
    projective as jproj
from glorie_slam_tpu_torch.geom import ba
from torch_parity import n, random_poses, t


def _problem(seed, N=6, ht=6, wd=8):
    rng = np.random.default_rng(seed)
    poses_gt = jlie.exp(jnp.asarray(np.cumsum(random_poses(rng, N, 0.03),
                                              0)))
    disps_gt = (0.4 + 0.3 * rng.random((N, ht, wd))).astype(np.float32)
    intr = np.array([8.0, 8.0, wd / 2, ht / 2], np.float32)
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    m = (ii != jj) & (np.abs(ii - jj) <= 2)
    ii, jj = ii[m], jj[m]
    target, _ = jproj.projective_transform(
        poses_gt, jnp.asarray(disps_gt), jnp.asarray(intr), jnp.asarray(ii),
        jnp.asarray(jj))
    target = np.asarray(target) + rng.normal(size=target.shape) * 0.05
    weight = rng.random(target.shape).astype(np.float32)
    poses0 = np.asarray(jlie.retr(poses_gt, jnp.asarray(
        random_poses(rng, N, 0.01))))
    disps0 = disps_gt * (1 + 0.1 * rng.normal(size=disps_gt.shape))
    eta = (1e-3 + 1e-3 * rng.random((N, ht, wd))).astype(np.float32)
    return (poses0, disps0.astype(np.float32), intr,
            target.astype(np.float32), weight, eta, ii, jj)


@pytest.mark.parametrize("motion_only", [False, True])
def test_ba_matches_jax(motion_only):
    poses, disps, intr, target, weight, eta, ii, jj = _problem(0)
    N = poses.shape[0]
    t0, t1, kbase, K, P = 1, N, 0, N, N - 1
    adj, adj_mask = jba.build_adjacency(ii, len(ii), kbase, K, 8)
    jp, jd = jba.ba(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(target), jnp.asarray(weight), jnp.asarray(eta),
        jnp.zeros_like(jnp.asarray(disps)), jnp.asarray(ii), jnp.asarray(jj),
        jnp.asarray(adj), jnp.asarray(adj_mask), t0, t1, kbase,
        P_max=P, K_max=K, Dmax=8, iters=2, motion_only=motion_only)
    pp, pd = ba.ba(t(poses), t(disps), t(intr), t(target), t(weight),
                   t(eta), ii, jj, t0, t1, kbase, P_max=P, K_max=K, iters=2,
                   motion_only=motion_only)
    assert np.abs(n(pp) - poses).max() > 1e-4      # the solve moved poses
    np.testing.assert_allclose(n(pp), n(jp), atol=1e-4)
    np.testing.assert_allclose(n(pd), n(jd), rtol=1e-3, atol=1e-4)


def test_ba_scale_shift_matches_jax():
    poses, disps, intr, target, weight, eta, ii, jj = _problem(1)
    rng = np.random.default_rng(5)
    N = poses.shape[0]
    mono = (disps * 1.3 + 0.1).astype(np.float32)
    mono[0, :2] = 0.0                      # invalid prior pixels
    vmask = rng.random(disps.shape) > 0.3
    scales = np.ones(N, np.float32)
    shifts = np.zeros(N, np.float32)
    kbase, K = 1, 5
    jo = jba.ba_scale_shift(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(target), jnp.asarray(weight), jnp.asarray(eta),
        jnp.asarray(mono), jnp.asarray(scales), jnp.asarray(shifts),
        jnp.asarray(vmask), jnp.asarray(ii), jnp.asarray(jj), None, kbase,
        K_max=K, iters=2)
    po = ba.ba_scale_shift(
        t(poses), t(disps), t(intr), t(target), t(weight), t(eta), t(mono),
        t(scales), t(shifts), torch.as_tensor(vmask),
        torch.as_tensor(ii), torch.as_tensor(jj), kbase, K_max=K, iters=2)
    for a, b in zip(po, jo):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-3, atol=1e-5)


def test_damped_cholesky_zero_step_on_failure():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(12, 12)).astype(np.float32)
    H = A @ A.T
    v = rng.normal(size=12).astype(np.float32)
    ref = jba.damped_cholesky_solve(jnp.asarray(H), jnp.asarray(v), 0.1,
                                    1e-4)
    out = ba.damped_cholesky_solve(t(H), t(v), 0.1, 1e-4)
    np.testing.assert_allclose(n(out), n(ref), rtol=1e-3, atol=1e-5)
    bad = H.copy()
    bad[3, 3] = -100.0                      # not positive definite
    nan = H.copy()
    nan[0, 1] = nan[1, 0] = np.nan          # e.g. a NaN edge weight
    for m in (bad, nan):
        assert np.all(n(jba.damped_cholesky_solve(
            jnp.asarray(m), jnp.asarray(v), 0.1, 1e-4)) == 0)
        assert np.all(n(ba.damped_cholesky_solve(t(m), t(v), 0.1,
                                                 1e-4)) == 0)


def test_build_adjacency_matches_jax():
    ii = np.array([2, 3, -1, 2, 5, 3, 2])
    a, m = ba.build_adjacency(ii, 7, 2, 4, 3)
    ja, jm = jba.build_adjacency(ii, 7, 2, 4, 3)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(m, jm)
    with pytest.raises(ValueError):
        ba.build_adjacency(ii, 7, 2, 4, 2)
