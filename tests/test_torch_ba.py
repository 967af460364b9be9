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


def test_ba_with_sensor_disparities_matches_jax():
    """The RGB-D term: sensor disparities on half the pixels (the other
    half 0, unmeasured), at the tolerances above."""
    poses, disps, intr, target, weight, eta, ii, jj = _problem(1)
    N = poses.shape[0]
    rng = np.random.default_rng(5)
    sensor = np.where(rng.random(disps.shape) < 0.5,
                      disps * (1 + 0.05 * rng.normal(size=disps.shape)),
                      0.0).astype(np.float32)
    t0, t1, kbase, K, P = 1, N, 0, N, N - 1
    adj, adj_mask = jba.build_adjacency(ii, len(ii), kbase, K, 8)
    jp, jd = jba.ba(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(target), jnp.asarray(weight), jnp.asarray(eta),
        jnp.asarray(sensor), jnp.asarray(ii), jnp.asarray(jj),
        jnp.asarray(adj), jnp.asarray(adj_mask), t0, t1, kbase,
        P_max=P, K_max=K, Dmax=8, iters=2)
    pp, pd = ba.ba(t(poses), t(disps), t(intr), t(target), t(weight),
                   t(eta), ii, jj, t0, t1, kbase, P_max=P, K_max=K, iters=2,
                   sensor_disps=t(sensor))
    np.testing.assert_allclose(n(pp), n(jp), atol=1e-4)
    np.testing.assert_allclose(n(pd), n(jd), rtol=1e-3, atol=1e-4)
    # the term acts: the measured pixels moved toward the sensor
    _, pd0 = ba.ba(t(poses), t(disps), t(intr), t(target), t(weight),
                   t(eta), ii, jj, t0, t1, kbase, P_max=P, K_max=K, iters=2)
    m = sensor > 0
    assert (np.abs(n(pd) - sensor)[m].mean()
            < np.abs(n(pd0) - sensor)[m].mean())


def _monocular_ba(poses, disps, intrinsics, target, weight, eta, ii, jj,
                  t0, t1, kbase, *, P_max, K_max, iters=2, lm=1e-4, ep=0.1,
                  motion_only=False):
    """``ba.ba`` as it was before the RGB-D term and the edge sharding (its
    per-edge products as five einsums), on the module's unchanged helpers:
    the reference that ``sensor_disps=None`` must equal bit for bit."""
    N, ht, wd = disps.shape
    npix = ht * wd
    ii_t, jj_t = torch.as_tensor(ii), torch.as_tensor(jj)
    E = len(ii)
    P1 = P_max + 1
    eta_win = eta[kbase:kbase + K_max].reshape(K_max, npix)
    slot_i = ba._pose_slot(ii_t, t0, t1, P_max)
    slot_j = ba._pose_slot(jj_t, t0, t1, P_max)
    kidx = torch.where(ii_t >= 0, ii_t - kbase, torch.full_like(ii_t, K_max))
    kidx = torch.where((kidx >= 0) & (kidx < K_max), kidx,
                       torch.full_like(kidx, K_max))
    if not motion_only:
        deg = np.bincount(ii[(ii >= kbase) & (ii < kbase + K_max)] - kbase,
                          minlength=1).max()
        adj, adj_mask = (torch.as_tensor(a) for a in ba.build_adjacency(
            ii, E, kbase, K_max, max(int(deg), 1)))
        jj_pad = torch.cat([jj_t, jj_t.new_full((1,), -1)])
        slots_all = torch.cat([
            ba._pose_slot(kbase + torch.arange(K_max), t0, t1, P_max)[:, None],
            ba._pose_slot(jj_pad[adj], t0, t1, P_max)], dim=1)
    for _ in range(iters):
        coords, valid, (Ji, Jj, Jz) = ba.projective.projective_transform(
            poses, disps, intrinsics, ii_t, jj_t, jacobian=True)
        Ji, Jj = Ji.reshape(E, npix, 2, 6), Jj.reshape(E, npix, 2, 6)
        Jz = Jz.reshape(E, npix, 2)
        r = target.reshape(E, npix, 2) - coords.reshape(E, npix, 2)
        w = 0.001 * valid.reshape(E, npix, 1) * weight.reshape(E, npix, 2)
        w = w * (ii_t >= 0)[:, None, None].to(w.dtype)
        Ce = torch.sum(w * Jz * Jz, dim=-1)
        wze = torch.sum(w * r * Jz, dim=-1)
        wp = w * (ii_t != jj_t)[:, None, None].to(w.dtype)
        wJi, wJj = wp[..., None] * Ji, wp[..., None] * Jj
        Hii = torch.einsum("npki,npkj->nij", wJi, Ji)
        Hij = torch.einsum("npki,npkj->nij", wJi, Jj)
        Hjj = torch.einsum("npki,npkj->nij", wJj, Jj)
        vi = torch.einsum("npki,npk->ni", wJi, r)
        vj = torch.einsum("npki,npk->ni", wJj, r)
        Ei = torch.einsum("npki,npk->nip", wJi, Jz)
        Ej = torch.einsum("npki,npk->nip", wJj, Jz)
        H = (ba._place_blocks(P1, slot_i, slot_i, Hii)
             + ba._place_blocks(P1, slot_j, slot_j, Hjj)
             + ba._place_blocks(P1, slot_i, slot_j, Hij)
             + ba._place_blocks(P1, slot_j, slot_i, Hij.transpose(-1, -2)))
        v = ba._place_rows(P1, slot_i, vi) + ba._place_rows(P1, slot_j, vj)
        if motion_only:
            Hm = H[:P_max, :P_max].permute(0, 2, 1, 3).reshape(
                P_max * 6, P_max * 6)
            dx = ba.damped_cholesky_solve(Hm, v[:P_max].reshape(-1), ep,
                                          lm).reshape(P_max, 6)
            poses = ba._apply_pose_retr(poses, dx, t0, t1, P_max)
            continue
        C = Ce.new_zeros((K_max + 1, npix)).index_add_(0, kidx, Ce)[:K_max]
        wz = wze.new_zeros((K_max + 1, npix)).index_add_(0, kidx, wze)
        wz = wz[:K_max]
        Q = 1.0 / (C + eta_win)
        disp_win = disps[kbase:kbase + K_max].reshape(K_max, npix)
        Ei_pad = torch.cat([Ei, Ei.new_zeros((1, 6, npix))])
        Ej_pad = torch.cat([Ej, Ej.new_zeros((1, 6, npix))])
        m = adj_mask[:, :, None, None]
        rows = torch.cat([(Ei_pad[adj] * m).sum(dim=1, keepdim=True),
                          Ej_pad[adj] * m], dim=1)
        L = rows.shape[1]
        rq = rows * Q[:, None, None, :]
        gram = torch.bmm(rq.reshape(K_max, L * 6, npix),
                         rows.reshape(K_max, L * 6, npix).transpose(1, 2))
        gram = gram.reshape(K_max, L, 6, L, 6).permute(0, 1, 3, 2, 4)
        ev = torch.einsum("kldp,kp->kld", rq, wz)
        S = ba._place_blocks(P1, slots_all[:, :, None].expand(-1, L, L),
                             slots_all[:, None, :].expand(-1, L, L), gram)
        vs = ba._place_rows(P1, slots_all, ev)
        A = (H - S)[:P_max, :P_max].permute(0, 2, 1, 3).reshape(
            P_max * 6, P_max * 6)
        dx = ba.damped_cholesky_solve(A, (v - vs)[:P_max].reshape(-1), ep,
                                      lm).reshape(P_max, 6)
        dx_rows = torch.cat([dx, dx.new_zeros((1, 6))])[slots_all]
        dz = Q * (wz - torch.einsum("kldp,kld->kp", rows, dx_rows))
        poses = ba._apply_pose_retr(poses, dx, t0, t1, P_max)
        disps = disps.clone()
        disps[kbase:kbase + K_max] = (disp_win + dz).reshape(K_max, ht, wd)
    return poses, disps


@pytest.mark.parametrize("motion_only", [False, True])
def test_ba_without_sensor_is_unchanged(motion_only):
    """``sensor_disps=None`` is the monocular solve as it was before the
    RGB-D term and the edge sharding, bit for bit (``_monocular_ba``), and
    bitwise the same as an all-zero (unmeasured) sensor map, which takes
    the term's code."""
    poses, disps, intr, target, weight, eta, ii, jj = _problem(2)
    N = poses.shape[0]
    args = (t(poses), t(disps), t(intr), t(target), t(weight), t(eta), ii,
            jj, 1, N, 0)
    kw = dict(P_max=N - 1, K_max=N, iters=2, motion_only=motion_only)
    a = ba.ba(*args, **kw)
    for x, y in zip(a, _monocular_ba(*args, **kw)):
        assert torch.equal(x, y)
    b = ba.ba(*args, **kw, sensor_disps=torch.zeros_like(t(disps)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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
