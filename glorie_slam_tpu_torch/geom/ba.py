"""Dense bundle adjustment (DBA) and the DSPO scale/shift solve.

Counterpart of ``glorie_slam_tpu/geom/ba.py`` with the same semantics:

* residual r = target - proj(G_ij ∘ Pi(disp_i)), weights x 0.001, masked
  where the transformed depth is below MIN_DEPTH; padded edges (ii < 0)
  carry zero weight;
* stereo edges (ii == jj) only feed the depth blocks;
* poses outside [t0, t1) are fixed but their depths still update;
* damping: diag += ep + lm * diag on the Schur-complemented pose system,
  depth C += eta; a failed Cholesky gives a zero step;
* retraction pose <- exp(dx) ∘ pose, disp += dz.

* RGB-D prior (``sensor_disps``, JAX ``ba.py:184-187, 240-244``): where a
  sensor disparity is > 0, the depth block's damping ``eta`` gives way to
  ``alpha`` and the residual pulls the disparity toward the sensor's. The
  tracking path passes none (the JAX package passes zeros: the same).

The JAX package assembles the pose Hessian and the Schur complement with
one-hot matrix products (the TPU's matrix unit); here the same blocks are
placed with ``index_add_`` and the per-frame Schur grams are one batched
``bmm``. Sums run in another order, so results agree to float32 rounding.

Edge-sharded (``group``, ``bounds`` from ``parallel.mesh``): each rank
linearizes its own edges (source frame in its range) over their pixels
and builds its own frames' depth blocks and Schur grams. The small
products are gathered, in the one-rank layout: every edge's 6x6 pose
blocks (120 floats an edge) and every window frame's gram and its rhs.
Every rank then places them with the one-rank code, solves, and takes
rank 0's pose step (``index_add_`` on the card sums in atomic order), and
back-substitutes its own frames' disparities; the window's rows are
gathered after the last iteration. On the CPU the result is bitwise the
one-rank result.
"""

import numpy as np
import torch

from ..parallel import mesh as mesh_mod
from ..utils.phase_timer import sync
from . import lie, projective


def damped_cholesky_solve(H, v, ep, lm, refine: int = 1):
    """Solve (H + (ep + lm diag(H)) I) x = v; zeros when the factorization
    fails (``cholesky_ex`` info or a non-finite factor)."""
    D = H.shape[0]
    Hd = H + torch.diag(ep + lm * torch.diagonal(H))
    L, info = torch.linalg.cholesky_ex(Hd)
    ok = (info == 0) & torch.isfinite(L).all()
    L = torch.where(ok, L, torch.eye(D, dtype=H.dtype, device=H.device))
    col = v.dim() == 1
    rhs = v[:, None] if col else v
    x = torch.cholesky_solve(rhs, L)
    for _ in range(refine):
        x = x + torch.cholesky_solve(rhs - Hd @ x, L)
    x = torch.where(ok, x, torch.zeros_like(x))
    return x[:, 0] if col else x


def _edge_blocks(poses, disps, intrinsics, target, weight, ii, jj):
    """Per-edge linearization, pixel-flattened: Hii, Hij, Hjj (E,6,6);
    vi, vj (E,6); Ei, Ej (E,6,npix); C, wz (E,npix)."""
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
    # two products, [Hii | Hij | vi] and [Hjj | vj]: with r as a seventh
    # column the gradients take the 6x6 blocks' GEMM (on the card a
    # one-column product's rounding depends on the batch's edge count)
    r1 = r[..., None]
    Fi = torch.einsum("npki,npkj->nij", wJi, torch.cat([Ji, Jj, r1], -1))
    Fj = torch.einsum("npki,npkj->nij", wJj, torch.cat([Jj, r1], -1))
    Hii, Hij, vi = Fi[..., :6], Fi[..., 6:12], Fi[..., 12]
    Hjj, vj = Fj[..., :6], Fj[..., 6]
    Ei = torch.einsum("npki,npk->nip", wJi, Jz)
    Ej = torch.einsum("npki,npk->nip", wJj, Jz)
    return Hii, Hij, Hjj, vi, vj, Ei, Ej, C, wz


def _pose_slot(idx, t0, t1, P_max):
    """Frame -> pose-window slot, sentinel P_max for fixed poses."""
    slot = idx - t0
    ok = (idx >= t0) & (idx < t1) & (slot < P_max)
    return torch.where(ok, slot, torch.full_like(slot, P_max))


def _place_blocks(P1, slots_a, slots_b, blocks):
    """Sum 6x6 ``blocks`` into a (P1, P1, 6, 6) system at [a, b]."""
    out = blocks.new_zeros((P1 * P1, 6, 6))
    out.index_add_(0, (slots_a * P1 + slots_b).reshape(-1),
                   blocks.reshape(-1, 6, 6))
    return out.reshape(P1, P1, 6, 6)


def _place_rows(P1, slots, rows):
    out = rows.new_zeros((P1, 6))
    out.index_add_(0, slots.reshape(-1), rows.reshape(-1, 6))
    return out


def build_adjacency(ii, E_pad: int, kbase: int, K_max: int, Dmax: int):
    """Host: per depth-frame lists of the edges with ii == kbase + k.

    Returns (adj (K_max, Dmax) int64 with sentinel E_pad, mask (K_max, Dmax)
    float32)."""
    adj = np.full((K_max, Dmax), E_pad, dtype=np.int64)
    mask = np.zeros((K_max, Dmax), dtype=np.float32)
    fill = np.zeros(K_max, dtype=np.int64)
    for e, i in enumerate(np.asarray(ii)):
        if i < 0:
            continue
        k = int(i) - kbase
        if 0 <= k < K_max:
            d = fill[k]
            if d >= Dmax:
                raise ValueError(f"frame {int(i)} has more than Dmax={Dmax} "
                                 "edges")
            adj[k, d] = e
            mask[k, d] = 1.0
            fill[k] = d + 1
    return adj, mask


def _apply_pose_retr(poses, dx, t0, t1, P_max):
    """poses[t0 + p] <- exp(dx[p]) ∘ poses[t0 + p] for free slots p."""
    N = poses.shape[0]
    idx = torch.arange(N, device=poses.device)
    free = (idx >= t0) & (idx < t1) & ((idx - t0) < P_max)
    slot = (idx - t0).clamp(0, P_max - 1)
    dx_full = torch.where(free[:, None], dx[slot], torch.zeros_like(dx[slot]))
    return torch.where(free[:, None], lie.retr(poses, dx_full), poses)


def _gather_edges(group, sizes, order, E, *blocks):
    """Every edge's per-edge blocks, in the one-rank edge order."""
    n = [int(np.prod(b.shape[1:])) for b in blocks]
    E_l = blocks[0].shape[0]
    flat = torch.cat([b.reshape(E_l, k) for b, k in zip(blocks, n)], dim=1)
    parts = torch.cat(group.gather_rows(flat, sizes))
    out = parts.new_empty((E, parts.shape[1]))
    out[order] = parts
    return [x.reshape((E,) + b.shape[1:])
            for x, b in zip(out.split(n, dim=1), blocks)]


def ba(poses, disps, intrinsics, target, weight, eta, ii, jj, t0, t1, kbase,
       *, P_max: int, K_max: int, iters: int = 2, lm: float = 1e-4,
       ep: float = 0.1, motion_only: bool = False, depth_only: bool = False,
       refine: int = 1, sensor_disps=None, alpha: float = 0.05, group=None,
       bounds=None):
    """``iters`` Gauss-Newton DBA iterations -> (poses, disps).

    poses (N,7), disps (N,ht,wd), target/weight (E,ht,wd,2), eta (N,ht,wd)
    full-buffer depth damping; ii/jj host int arrays (E,), -1 = padding;
    free poses are [t0, t1); depths of frames [kbase, kbase + K_max) update.
    sensor_disps (N,ht,wd) or None: RGB-D prior disparities (> 0 where
    measured), weighted ``alpha``. Under ``group`` (with the partition's
    ``bounds``) ii/jj are every rank's edges and target/weight this
    rank's rows of them (``mesh.rank_edges(ii, bounds)[rank]``).
    """
    N, ht, wd = disps.shape
    npix = ht * wd
    if kbase < 0 or kbase + K_max > N:
        raise ValueError(f"depth window [{kbase}, {kbase + K_max}) is "
                         f"outside the {N}-frame buffer")
    dev = poses.device
    ii_np = np.asarray(ii, np.int64)
    jj_np = np.asarray(jj, np.int64)
    E = len(ii_np)
    with sync("ba_index", 2):
        ii_t = torch.as_tensor(ii_np, device=dev)
        jj_t = torch.as_tensor(jj_np, device=dev)
    P1 = P_max + 1

    eta_win = eta[kbase:kbase + K_max].reshape(K_max, npix)
    if sensor_disps is not None:
        sens_win = sensor_disps[kbase:kbase + K_max].reshape(K_max, npix)
        m_sens = (sens_win > 0).to(poses.dtype)
    slot_i = _pose_slot(ii_t, t0, t1, P_max)
    slot_j = _pose_slot(jj_t, t0, t1, P_max)
    ii_l, jj_l, ii_lt, jj_lt = ii_np, jj_np, ii_t, jj_t
    if group is not None:
        act = mesh_mod.rank_edges(ii_np, bounds)
        sizes = [len(a) for a in act]
        with sync("ba_index"):
            order = torch.as_tensor(np.concatenate(act), device=dev)
        mine = act[group.rank]
        ii_l, jj_l = ii_np[mine], jj_np[mine]
        ii_lt, jj_lt = ii_t[mine], jj_t[mine]
    kidx = torch.where(ii_lt >= 0, ii_lt - kbase,
                       torch.full_like(ii_lt, K_max))
    kidx = torch.where((kidx >= 0) & (kidx < K_max), kidx,
                       torch.full_like(kidx, K_max))

    if not motion_only:
        deg = np.bincount(ii_np[(ii_np >= kbase) & (ii_np < kbase + K_max)]
                          - kbase, minlength=1).max() if E else 0
        Dmax = max(int(deg), 1)
        adj_np, mask_np = build_adjacency(ii_np, E, kbase, K_max, Dmax)
        with sync("ba_index"):
            adj = torch.as_tensor(adj_np, device=dev)
        jj_pad = torch.cat([jj_t, jj_t.new_full((1,), -1)])
        ks = torch.arange(K_max, device=dev)
        slots_all = torch.cat([
            _pose_slot(kbase + ks, t0, t1, P_max)[:, None],
            _pose_slot(jj_pad[adj], t0, t1, P_max)], dim=1)   # (K, L)
        if group is not None:
            # this rank's coupling rows: its frames' edges, as one rank
            # lists them
            adj_np, mask_np = build_adjacency(ii_l, len(ii_l), kbase, K_max,
                                              Dmax)
            with sync("ba_index"):
                adj = torch.as_tensor(adj_np, device=dev)
        with sync("ba_index"):
            adj_mask = torch.as_tensor(mask_np, device=dev)

    for _ in range(iters):
        Hii, Hij, Hjj, vi, vj, Ei, Ej, Ce, wze = _edge_blocks(
            poses, disps, intrinsics, target, weight, ii_lt, jj_lt)
        if group is not None:
            Hii, Hij, Hjj, vi, vj = _gather_edges(group, sizes, order, E,
                                                  Hii, Hij, Hjj, vi, vj)
        H = (_place_blocks(P1, slot_i, slot_i, Hii)
             + _place_blocks(P1, slot_j, slot_j, Hjj)
             + _place_blocks(P1, slot_i, slot_j, Hij)
             + _place_blocks(P1, slot_j, slot_i, Hij.transpose(-1, -2)))
        v = _place_rows(P1, slot_i, vi) + _place_rows(P1, slot_j, vj)

        if motion_only:
            Hm = H[:P_max, :P_max].permute(0, 2, 1, 3).reshape(
                P_max * 6, P_max * 6)
            dx = damped_cholesky_solve(Hm, v[:P_max].reshape(-1), ep, lm,
                                       refine=refine).reshape(P_max, 6)
            if group is not None:
                dx = group.broadcast_(dx)
            poses = _apply_pose_retr(poses, dx, t0, t1, P_max)
            continue

        C = Ce.new_zeros((K_max + 1, npix)).index_add_(0, kidx, Ce)[:K_max]
        wz = wze.new_zeros((K_max + 1, npix)).index_add_(0, kidx, wze)
        wz = wz[:K_max]
        disp_win = disps[kbase:kbase + K_max].reshape(K_max, npix)
        if sensor_disps is None:
            C = C + eta_win
        else:
            C = C + m_sens * alpha + (1 - m_sens) * eta_win
            wz = wz - m_sens * alpha * (disp_win - sens_win)
        Q = 1.0 / C

        # per-frame coupling rows: [sum of Ei over the frame's edges | Ej]
        Ei_pad = torch.cat([Ei, Ei.new_zeros((1, 6, npix))])
        Ej_pad = torch.cat([Ej, Ej.new_zeros((1, 6, npix))])
        m = adj_mask[:, :, None, None]
        row0 = (Ei_pad[adj] * m).sum(dim=1, keepdim=True)
        rows = torch.cat([row0, Ej_pad[adj] * m], dim=1)      # (K,L,6,npix)
        L = rows.shape[1]
        rq = rows * Q[:, None, None, :]
        gram = torch.bmm(rq.reshape(K_max, L * 6, npix),
                         rows.reshape(K_max, L * 6, npix).transpose(1, 2))
        gram = gram.reshape(K_max, L, 6, L, 6).permute(0, 1, 3, 2, 4)
        ev = torch.einsum("kldp,kp->kld", rq, wz)
        if group is not None:
            # every window frame's gram and rhs, from its owner
            n_g = L * L * 36
            both = torch.cat([gram.reshape(K_max, n_g),
                              ev.reshape(K_max, L * 6)], dim=1)
            both = mesh_mod.gather_window(group, bounds, both, kbase)
            gram = both[:, :n_g].reshape(gram.shape)
            ev = both[:, n_g:].reshape(ev.shape)
        S = _place_blocks(P1, slots_all[:, :, None].expand(-1, L, L),
                          slots_all[:, None, :].expand(-1, L, L), gram)
        vs = _place_rows(P1, slots_all, ev)

        A = (H - S)[:P_max, :P_max].permute(0, 2, 1, 3).reshape(
            P_max * 6, P_max * 6)
        rhs = (v - vs)[:P_max].reshape(-1)
        dx = damped_cholesky_solve(A, rhs, ep, lm, refine=refine)
        dx = dx.reshape(P_max, 6)
        if group is not None:
            dx = group.broadcast_(dx)
        dx_pad = torch.cat([dx, dx.new_zeros((1, 6))])
        dx_rows = dx_pad[slots_all]                         # sentinel -> 0
        dz = Q * (wz - torch.einsum("kldp,kld->kp", rows, dx_rows))

        if not depth_only:
            poses = _apply_pose_retr(poses, dx, t0, t1, P_max)
        disps = disps.clone()
        disps[kbase:kbase + K_max] = (disp_win + dz).reshape(K_max, ht, wd)
    if group is not None and not motion_only and iters:
        # a rank's edges read only its own frames' disparities, so the
        # rows are gathered once, after the last iteration
        disps[kbase:kbase + K_max] = mesh_mod.gather_window(
            group, bounds, disps[kbase:kbase + K_max], kbase)
    return poses, disps


def ba_scale_shift(poses, disps, intrinsics, target, weight, eta,
                   mono_disps, scales, shifts, valid_depth_mask, ii, jj,
                   kbase, *, K_max: int, iters: int = 2, lm: float = 1e-4,
                   ep: float = 0.1, alpha: float = 0.01, group=None,
                   bounds=None):
    """DSPO stage 2: disparities + per-frame mono (scale, shift); poses fixed.

    The per-frame 2x2 (scale, shift) blocks are independent once the pixel
    disparities are Schur-eliminated, so each frame solves its own 2x2.
    ii/jj: (E,) tensors, -1 = dropped edge. Returns (disps, scales, shifts).
    Under ``group`` (with the partition's ``bounds``) the edges are this
    rank's: each frame's solve is its owner's, and the window's rows are
    gathered after the last iteration.
    """
    N, ht, wd = disps.shape
    npix = ht * wd
    if kbase < 0 or kbase + K_max > N:
        raise ValueError(f"depth window [{kbase}, {kbase + K_max}) is "
                         f"outside the {N}-frame buffer")
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

        C = C_proj + J_d * J_d + eta_win
        Qd = 1.0 / C
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

    if group is not None and iters:
        rows = torch.cat([disps[win].reshape(K_max, npix),
                          scale_win[:, None], shift_win[:, None]], dim=1)
        rows = mesh_mod.gather_window(group, bounds, rows, kbase)
        disps[win] = rows[:, :npix].reshape(K_max, ht, wd)
        scale_win, shift_win = rows[:, npix], rows[:, npix + 1]
    scales = scales.clone()
    shifts = shifts.clone()
    scales[win] = scale_win
    shifts[win] = shift_win
    return disps.clamp(min=0.0), scales, shifts
