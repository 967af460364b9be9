"""Frozen copy of ``glorie_slam_tpu_torch/geom/ba.py`` (one device, no edge
group) for the benchmark's plain reference: the DBA Gauss-Newton step with
its Schur complement, and the DSPO disparity + scale/shift step.

residual r = target - proj(G_ij o Pi(disp_i)), weights x 0.001, masked where
the transformed depth is below MIN_DEPTH; padded edges (ii < 0) carry zero
weight; stereo edges (ii == jj) only feed the depth blocks; poses outside
[t0, t1) are fixed; damping diag += ep + lm * diag on the Schur-complemented
pose system, depth C += eta; a failed Cholesky gives a zero step;
retraction pose <- exp(dx) o pose, disp += dz.
"""

import numpy as np
import torch

from . import lie, projective


def damped_cholesky_solve(H, v, ep, lm, refine: int = 1):
    D = H.shape[0]
    Hd = H + torch.diag(ep + lm * torch.diagonal(H))
    L, info = torch.linalg.cholesky_ex(Hd)
    ok = (info == 0) & torch.isfinite(L).all()
    L = torch.where(ok, L, torch.eye(D, dtype=H.dtype, device=H.device))
    rhs = v[:, None]
    x = torch.cholesky_solve(rhs, L)
    for _ in range(refine):
        x = x + torch.cholesky_solve(rhs - Hd @ x, L)
    x = torch.where(ok, x, torch.zeros_like(x))
    return x[:, 0]


def _edge_blocks(poses, disps, intrinsics, target, weight, ii, jj):
    E = target.shape[0]
    ht, wd = disps.shape[-2:]
    npix = ht * wd
    coords, valid, (Ji, Jj, Jz) = projective.projective_transform(
        poses, disps, intrinsics, ii.clamp(min=0), jj.clamp(min=0),
        jacobian=True)
    Ji = Ji.reshape(E, npix, 2, 6)
    Jj = Jj.reshape(E, npix, 2, 6)
    Jz = Jz.reshape(E, npix, 2)
    r = target.reshape(E, npix, 2) - coords.reshape(E, npix, 2)
    w = 0.001 * valid.reshape(E, npix, 1) * weight.reshape(E, npix, 2)
    w = w * (ii >= 0)[:, None, None].to(w.dtype)
    C = torch.sum(w * Jz * Jz, dim=-1)
    wz = torch.sum(w * r * Jz, dim=-1)
    wp = w * (ii != jj)[:, None, None].to(w.dtype)
    wJi = wp[..., None] * Ji
    wJj = wp[..., None] * Jj
    r1 = r[..., None]
    Fi = torch.einsum("npki,npkj->nij", wJi, torch.cat([Ji, Jj, r1], -1))
    Fj = torch.einsum("npki,npkj->nij", wJj, torch.cat([Jj, r1], -1))
    Hii, Hij, vi = Fi[..., :6], Fi[..., 6:12], Fi[..., 12]
    Hjj, vj = Fj[..., :6], Fj[..., 6]
    Ei = torch.einsum("npki,npk->nip", wJi, Jz)
    Ej = torch.einsum("npki,npk->nip", wJj, Jz)
    return Hii, Hij, Hjj, vi, vj, Ei, Ej, C, wz


def _pose_slot(idx, t0, t1, P_max):
    slot = idx - t0
    ok = (idx >= t0) & (idx < t1) & (slot < P_max)
    return torch.where(ok, slot, torch.full_like(slot, P_max))


def _place_blocks(P1, slots_a, slots_b, blocks):
    out = blocks.new_zeros((P1 * P1, 6, 6))
    out.index_add_(0, (slots_a * P1 + slots_b).reshape(-1),
                   blocks.reshape(-1, 6, 6))
    return out.reshape(P1, P1, 6, 6)


def _place_rows(P1, slots, rows):
    out = rows.new_zeros((P1, 6))
    out.index_add_(0, slots.reshape(-1), rows.reshape(-1, 6))
    return out


def _adjacency(ii, E_pad, kbase, K_max, Dmax):
    adj = np.full((K_max, Dmax), E_pad, dtype=np.int64)
    mask = np.zeros((K_max, Dmax), dtype=np.float32)
    fill = np.zeros(K_max, dtype=np.int64)
    for e, i in enumerate(np.asarray(ii)):
        k = int(i) - kbase
        if i >= 0 and 0 <= k < K_max:
            adj[k, fill[k]] = e
            mask[k, fill[k]] = 1.0
            fill[k] += 1
    return adj, mask


def _apply_pose_retr(poses, dx, t0, t1, P_max):
    N = poses.shape[0]
    idx = torch.arange(N, device=poses.device)
    free = (idx >= t0) & (idx < t1) & ((idx - t0) < P_max)
    slot = (idx - t0).clamp(0, P_max - 1)
    dx_full = torch.where(free[:, None], dx[slot], torch.zeros_like(dx[slot]))
    return torch.where(free[:, None], lie.retr(poses, dx_full), poses)


def ba(poses, disps, intrinsics, target, weight, eta, ii, jj, t0, t1, kbase,
       *, P_max, K_max, iters=2, lm=1e-4, ep=0.1, refine=1, **_unused):
    """``iters`` DBA iterations -> (poses, disps); ii/jj host int arrays."""
    N, ht, wd = disps.shape
    npix = ht * wd
    dev = poses.device
    ii_np = np.asarray(ii, np.int64)
    jj_np = np.asarray(jj, np.int64)
    E = len(ii_np)
    ii_t = torch.as_tensor(ii_np, device=dev)
    jj_t = torch.as_tensor(jj_np, device=dev)
    P1 = P_max + 1
    eta_win = eta[kbase:kbase + K_max].reshape(K_max, npix)
    slot_i = _pose_slot(ii_t, t0, t1, P_max)
    slot_j = _pose_slot(jj_t, t0, t1, P_max)
    kidx = torch.where(ii_t >= 0, ii_t - kbase, torch.full_like(ii_t, K_max))
    kidx = torch.where((kidx >= 0) & (kidx < K_max), kidx,
                       torch.full_like(kidx, K_max))
    sel = ii_np[(ii_np >= kbase) & (ii_np < kbase + K_max)] - kbase
    Dmax = max(int(np.bincount(sel, minlength=1).max()) if E else 0, 1)
    adj_np, mask_np = _adjacency(ii_np, E, kbase, K_max, Dmax)
    adj = torch.as_tensor(adj_np, device=dev)
    adj_mask = torch.as_tensor(mask_np, device=dev)
    jj_pad = torch.cat([jj_t, jj_t.new_full((1,), -1)])
    ks = torch.arange(K_max, device=dev)
    slots_all = torch.cat([_pose_slot(kbase + ks, t0, t1, P_max)[:, None],
                           _pose_slot(jj_pad[adj], t0, t1, P_max)], dim=1)
    for _ in range(iters):
        Hii, Hij, Hjj, vi, vj, Ei, Ej, Ce, wze = _edge_blocks(
            poses, disps, intrinsics, target, weight, ii_t, jj_t)
        H = (_place_blocks(P1, slot_i, slot_i, Hii)
             + _place_blocks(P1, slot_j, slot_j, Hjj)
             + _place_blocks(P1, slot_i, slot_j, Hij)
             + _place_blocks(P1, slot_j, slot_i, Hij.transpose(-1, -2)))
        v = _place_rows(P1, slot_i, vi) + _place_rows(P1, slot_j, vj)
        C = Ce.new_zeros((K_max + 1, npix)).index_add_(0, kidx, Ce)[:K_max]
        wz = wze.new_zeros((K_max + 1, npix)).index_add_(0, kidx, wze)
        wz = wz[:K_max]
        disp_win = disps[kbase:kbase + K_max].reshape(K_max, npix)
        Q = 1.0 / (C + eta_win)
        Ei_pad = torch.cat([Ei, Ei.new_zeros((1, 6, npix))])
        Ej_pad = torch.cat([Ej, Ej.new_zeros((1, 6, npix))])
        m = adj_mask[:, :, None, None]
        row0 = (Ei_pad[adj] * m).sum(dim=1, keepdim=True)
        rows = torch.cat([row0, Ej_pad[adj] * m], dim=1)
        L = rows.shape[1]
        rq = rows * Q[:, None, None, :]
        gram = torch.bmm(rq.reshape(K_max, L * 6, npix),
                         rows.reshape(K_max, L * 6, npix).transpose(1, 2))
        gram = gram.reshape(K_max, L, 6, L, 6).permute(0, 1, 3, 2, 4)
        ev = torch.einsum("kldp,kp->kld", rq, wz)
        S = _place_blocks(P1, slots_all[:, :, None].expand(-1, L, L),
                          slots_all[:, None, :].expand(-1, L, L), gram)
        vs = _place_rows(P1, slots_all, ev)
        A = (H - S)[:P_max, :P_max].permute(0, 2, 1, 3).reshape(
            P_max * 6, P_max * 6)
        rhs = (v - vs)[:P_max].reshape(-1)
        dx = damped_cholesky_solve(A, rhs, ep, lm, refine=refine)
        dx = dx.reshape(P_max, 6)
        dx_rows = torch.cat([dx, dx.new_zeros((1, 6))])[slots_all]
        dz = Q * (wz - torch.einsum("kldp,kld->kp", rows, dx_rows))
        poses = _apply_pose_retr(poses, dx, t0, t1, P_max)
        disps = disps.clone()
        disps[kbase:kbase + K_max] = (disp_win + dz).reshape(K_max, ht, wd)
    return poses, disps


def ba_scale_shift(poses, disps, intrinsics, target, weight, eta,
                   mono_disps, scales, shifts, valid_depth_mask, ii, jj,
                   kbase, *, K_max, iters=2, lm=1e-4, ep=0.1, alpha=0.01,
                   **_unused):
    """DSPO stage 2 -> (disps, scales, shifts); poses fixed."""
    N, ht, wd = disps.shape
    npix = ht * wd
    dev = disps.device
    ii = torch.as_tensor(ii, device=dev).long()
    jj = torch.as_tensor(jj, device=dev).long()
    sqrt_alpha = float(np.sqrt(np.float32(alpha)))
    win = slice(kbase, kbase + K_max)
    mono_win = mono_disps[win].reshape(K_max, npix)
    vmask_win = valid_depth_mask[win].to(disps.dtype).reshape(K_max, npix)
    eta_win = eta[win].reshape(K_max, npix)
    invalid = mono_win < 1e-6
    sa = sqrt_alpha * torch.where(vmask_win > 0, 10.0, 1.0)
    zero = torch.zeros_like(sa)
    J_d = torch.where(invalid & (vmask_win > 0), zero, sa)
    J_scale = torch.where(invalid, zero, -mono_win * sa)
    J_shift = torch.where(invalid, zero, -sa)
    kidx = torch.where(ii >= 0, ii - kbase, torch.full_like(ii, K_max))
    kidx = torch.where((kidx >= 0) & (kidx < K_max), kidx,
                       torch.full_like(kidx, K_max))
    scale_win = scales[win].clone()
    shift_win = shifts[win].clone()
    E = target.shape[0]
    edge_ok = (ii >= 0)[:, None, None].to(disps.dtype)
    for _ in range(iters):
        coords, valid, (_, _, Jz) = projective.projective_transform(
            poses, disps, intrinsics, ii.clamp(min=0), jj.clamp(min=0),
            jacobian=True)
        Jz = Jz.reshape(E, npix, 2)
        r = target.reshape(E, npix, 2) - coords.reshape(E, npix, 2)
        w = 0.001 * valid.reshape(E, npix, 1) * weight.reshape(E, npix, 2)
        w = w * edge_ok
        Ck = torch.sum(w * Jz * Jz, dim=-1)
        wk = torch.sum(w * r * Jz, dim=-1)
        C_proj = Ck.new_zeros((K_max + 1, npix)).index_add_(0, kidx, Ck)
        w_proj = wk.new_zeros((K_max + 1, npix)).index_add_(0, kidx, wk)
        C_proj, w_proj = C_proj[:K_max], w_proj[:K_max]
        disp_win = disps[win].reshape(K_max, npix)
        r_depth = sqrt_alpha * (disp_win - (scale_win[:, None] * mono_win
                                            + shift_win[:, None]))
        H00 = torch.sum(J_scale * J_scale, dim=1)
        H01 = torch.sum(J_scale * J_shift, dim=1)
        H11 = torch.sum(J_shift * J_shift, dim=1)
        u0 = -torch.sum(J_scale * r_depth, dim=1)
        u1 = -torch.sum(J_shift * r_depth, dim=1)
        Qd = 1.0 / (C_proj + J_d * J_d + eta_win)
        w_rhs = w_proj - J_d * r_depth
        E0 = J_scale * J_d
        E1 = J_shift * J_d
        S00 = H00 - torch.sum(E0 * Qd * E0, dim=1)
        S01 = H01 - torch.sum(E0 * Qd * E1, dim=1)
        S11 = H11 - torch.sum(E1 * Qd * E1, dim=1)
        b0 = u0 - torch.sum(E0 * Qd * w_rhs, dim=1)
        b1 = u1 - torch.sum(E1 * Qd * w_rhs, dim=1)
        S00 = S00 + ep + lm * S00
        S11 = S11 + ep + lm * S11
        det = S00 * S11 - S01 * S01
        big = det.abs() > 1e-12
        det_safe = torch.where(big, det, torch.ones_like(det))
        dw = (S11 * b0 - S01 * b1) / det_safe
        dq = (-S01 * b0 + S00 * b1) / det_safe
        ok = big & torch.isfinite(dw) & torch.isfinite(dq)
        dw = torch.where(ok, dw, torch.zeros_like(dw))
        dq = torch.where(ok, dq, torch.zeros_like(dq))
        dz = Qd * (w_rhs - E0 * dw[:, None] - E1 * dq[:, None])
        dz = torch.where(ok[:, None], dz, torch.zeros_like(dz))
        disps = disps.clone()
        disps[win] = (disp_win + dz).reshape(K_max, ht, wd)
        scale_win = scale_win + dw
        shift_win = shift_win + dq
    scales = scales.clone()
    shifts = shifts.clone()
    scales[win] = scale_win
    shifts[win] = shift_win
    return disps.clamp(min=0.0), scales, shifts
