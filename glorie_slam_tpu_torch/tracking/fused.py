"""DSPO rounds: K alternating GRU + BA iterations per call.

Counterpart of ``glorie_slam_tpu/tracking/fused.py``. The JAX package runs
the rounds as one ``lax.scan`` whose body picks pose_depth or depth_scale
with ``lax.cond``; here it is a Python loop over the round flags. Per round:

* GRU update of the active edges (damping refreshed from GraphAgg eta);
* BA over [inactive block | active block] edges (the inactive block is the
  pool edges with both ends >= t0 - 3, at most ``E_cap`` of the most
  recently stored);
* depth_scale rounds refresh the 1/8-res multiview validity of the
  trailing ``M_cur`` frames ending at t1, realign the per-frame mono
  scale/shift, apply the mono_thres edge filter (masking), and fall back
  to pose_depth when no edge survives; disparities are floored at 1e-5.

As in the JAX package, the convex upsample runs once, after the last
round, and the keyframe distance d(t1-2, t1-1) is computed on the final
state. The window sizes that change results (M_cur, the pose/depth windows
and their clamping) are computed exactly as the JAX package computes them.
"""

import numpy as np
import torch

from ..core.depth_video import valid_mask_update
from ..core.factor_graph import EP, graph_update_step
from ..geom import alignment, ba as ba_mod
from ..ops import distance as dist_mod, upsample as up_mod
from ..utils.buckets import bucket


def _stable_caps(graph):
    """(E_cap, span_cap) from the frontend config, as in the JAX package:
    E_cap bounds the inactive block; span_cap is the floor of the
    pose/depth/refresh windows."""
    v = graph.video
    window = int(v.cfg["tracking"]["frontend"].get("window", 0))
    E_cap = bucket(graph.max_factors) if graph.max_factors > 0 else 0
    span_cap = min(bucket(window + 8), v.buffer) if window else 0
    return E_cap, span_cap


def _assemble(graph, t0_arg, t1_arg, use_inactive):
    """Edge sets and solver windows of one rounds call."""
    v = graph.video
    E_cap, span_cap = _stable_caps(graph)
    kx, kk = np.unique(graph.ii, return_inverse=True)
    t0 = t0_arg if t0_arg is not None else max(1, int(graph.ii.min()) + 1)
    if use_inactive:
        sel = np.where((graph.ii_inac >= t0 - 3)
                       & (graph.jj_inac >= t0 - 3))[0]
    else:
        sel = np.zeros(0, np.int64)
    if E_cap and len(sel) > E_cap:
        sel = sel[-E_cap:]
    sel_d = graph._idx(sel)
    ii_ba = np.concatenate([graph.ii_inac[sel], graph.ii])
    jj_ba = np.concatenate([graph.jj_inac[sel], graph.jj])
    t1 = (t1_arg if t1_arg is not None
          else int(max(ii_ba.max(), jj_ba.max())) + 1)
    kbase_pd = int(min(ii_ba.min(), t0))
    K_pd = min(max(bucket(max(t1 - kbase_pd, 1)), span_cap), v.buffer)
    kbase_pd = max(0, min(kbase_pd, v.buffer - K_pd))
    P_max = min(max(bucket(max(t1 - t0, 1)), span_cap), v.buffer)
    K_ds = min(max(bucket(int(ii_ba.max()) + 1 - int(ii_ba.min())),
                   span_cap), v.buffer)
    frame_mask = torch.zeros(v.buffer, dtype=torch.bool, device=v.device)
    frame_mask[graph._idx(np.unique(ii_ba))] = True
    return dict(kx=kx, kk=kk, t0=t0, t1=t1, ii_ba=ii_ba, jj_ba=jj_ba,
                tgt_in=graph.target_inac[sel_d],
                wgt_in=graph.weight_inac[sel_d], kbase_pd=kbase_pd,
                K_pd=K_pd, P_max=P_max, K_ds=K_ds, frame_mask=frame_mask)


def graph_update_rounds(graph, rounds: int, t0=None, t1=None, itrs=2,
                        use_inactive=True, alternate=True,
                        lm=1e-4, ep=0.1):
    """Run ``rounds`` GRU + BA rounds on ``graph`` and write the results
    into the graph and its video. Rounds alternate pose_depth (even) and
    depth_scale (odd) when ``alternate`` and the video's BA_type is DSPO.
    Returns the keyframe distance d(t1-2, t1-1) (float), or None for an
    empty graph."""
    if len(graph.ii) == 0:
        return None
    v = graph.video
    st = _assemble(graph, t0, t1, use_inactive)
    t0, t1 = st["t0"], st["t1"]
    dspo_on = v.BA_type == "DSPO" and alternate and v.counter > 0
    mv = v.cfg["tracking"]["multiview_filter"]
    mv_thresh, visible_num = float(mv["thresh"]), int(mv["visible_num"])
    mono_thres = float(v.mono_thres) if v.mono_thres else 0.0
    dev = v.device
    Nbuf = v.buffer
    intr = v.intrinsics
    feat_pyr = v.corr_pyr

    ii_act, jj_act = graph._idx(graph.ii), graph._idx(graph.jj)
    kk, kx = graph._idx(st["kk"]), graph._idx(st["kx"])
    M = len(st["kx"])
    ii_ba_d, jj_ba_d = graph._idx(st["ii_ba"]), graph._idx(st["jj_ba"])
    poses, disps = v.poses, v.disps
    dsc, dsh, vm = v.depth_scale, v.depth_shift, v.valid_depth_mask_small
    net, target, weight = graph.net, graph.target, graph.weight
    damping = graph.damping.clone()

    def run_pd(poses, disps, wgt, eta_f):
        p2, d2 = ba_mod.ba(
            poses, disps, intr, tgt_comb, wgt, eta_f, st["ii_ba"],
            st["jj_ba"], t0, t1, st["kbase_pd"], P_max=st["P_max"],
            K_max=st["K_pd"], iters=itrs, lm=lm, ep=ep, refine=0)
        return p2, d2.clamp(min=1e-5)

    for r in range(rounds):
        is_ds = dspo_on and r % 2 == 1
        net, target, weight, eta, _, _ = graph_update_step(
            graph.tn, poses, disps, intr, feat_pyr, net, graph.inp, target,
            ii_act, jj_act, kk, graph.coords0, M, with_upmask=False)
        damping[kx] = eta
        eta_val = 0.2 * damping + EP
        eta_full = torch.where(st["frame_mask"][:, None, None], eta_val,
                               torch.full_like(eta_val, 1e-7))
        tgt_comb = torch.cat([st["tgt_in"], target])
        wgt_comb = torch.cat([st["wgt_in"], weight])
        if not is_ds:
            poses, disps = run_pd(poses, disps, wgt_comb, eta_full)
            continue

        M_cur = st["K_ds"]
        base = max(t1 - M_cur, 0)
        idx_np = np.arange(base, base + M_cur)
        idx_np = np.where(idx_np < v.counter, idx_np, 0)
        idx = graph._idx(idx_np)
        vm[idx] = valid_mask_update(poses, disps, intr, idx, mv_thresh,
                                    visible_num)
        est = disps[idx]
        valid = vm[idx].float()
        scale_t, shift_t, error_t = alignment.align_scale_and_shift(
            v.mono_disps[idx], est, valid)
        okf = torch.isfinite(scale_t) & torch.isfinite(shift_t)
        scale_t = torch.where(okf, scale_t, torch.ones_like(scale_t))
        shift_t = torch.where(okf, shift_t, torch.zeros_like(shift_t))
        dsc[idx] = scale_t
        dsh[idx] = shift_t

        if mono_thres:
            avg = est.mean(dim=(1, 2))
            vs = valid.sum(dim=(1, 2))
            bad_w = ((error_t / avg > mono_thres) | ~torch.isfinite(error_t)
                     | (scale_t < 0) | (vs < 0.5 * v.h8 * v.w8))
            bad = torch.zeros(Nbuf, dtype=torch.bool, device=dev)
            bad[idx] = bad_w
            keep_e = (~bad[ii_ba_d] & ~bad[jj_ba_d]).cpu().numpy()
        else:
            keep_e = np.ones(len(st["ii_ba"]), bool)
        if not (keep_e.any() and v.counter > 0):
            poses, disps = run_pd(poses, disps, wgt_comb, eta_full)
            continue
        ii_ds = np.where(keep_e, st["ii_ba"], -1)
        keep_d = torch.as_tensor(keep_e, device=dev)
        wgt_ds = wgt_comb * keep_d[:, None, None, None].to(wgt_comb.dtype)
        haskept = torch.zeros(Nbuf, dtype=torch.bool, device=dev)
        haskept[graph._idx(ii_ds[keep_e])] = True
        eta_ds = torch.where(haskept[:, None, None], eta_val,
                             torch.full_like(eta_val, 1e-7))
        kbase_ds = int(np.clip(ii_ds[keep_e].min(), 0, Nbuf - M_cur))
        disps, dsc, dsh = ba_mod.ba_scale_shift(
            poses, disps, intr, tgt_comb, wgt_ds, eta_ds, v.mono_disps,
            dsc, dsh, vm, graph._idx(ii_ds), jj_ba_d, kbase_ds,
            K_max=M_cur, iters=itrs, lm=lm, ep=ep, alpha=0.01)
        disps = disps.clamp(min=1e-5)

    # upsample mask from the final hidden state, once
    _, um = graph.tn.agg(net.permute(0, 3, 1, 2), kk, M)
    ta = torch.tensor([max(t1 - 2, 0)], device=dev)
    tb = torch.tensor([max(t1 - 1, 0)], device=dev)
    kf_dist = dist_mod.frame_distance_bidirectional(
        poses, disps, intr, ta, tb,
        beta=float(v.cfg["tracking"].get("beta", 0.3)))[0]
    disps_up = v.disps_up
    disps_up[kx] = up_mod.upsample_disp(disps[kx], um.float())

    v.poses, v.disps = poses, disps
    v.depth_scale, v.depth_shift, v.valid_depth_mask_small = dsc, dsh, vm
    graph.damping = damping
    graph.net, graph.target, graph.weight = net, target, weight
    graph.age += rounds
    return float(kf_dist)
