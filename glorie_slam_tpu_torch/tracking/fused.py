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

Under an edge group (``video.group``, ``tracking.mesh_devices`` > 1; the
counterpart of the JAX package's ``edge_mesh``) the active edges and the
inactive block are split by source frame (``parallel/mesh.py``): each rank
runs the GRU update, kernel A's lookups and the BA linearization of its
own edges, with rank-local GraphAgg slots; every rank solves the same
pose system (``geom/ba.py``) and the disparity, scale and shift rows are
gathered after each solve. The validity refresh and the scale/shift realignment run
replicated; the mono_thres edge filter is rank 0's. Net, target and
weight stay sharded through the rounds and are gathered into the graph
once, at the end, with the damping and ``disps_up`` rows.
"""

import numpy as np
import torch

from ..core.depth_video import valid_mask_update
from ..core.factor_graph import EP, graph_update_step
from ..geom import alignment, ba as ba_mod
from ..ops import distance as dist_mod, upsample as up_mod
from ..parallel import mesh as mesh_mod
from ..utils.buckets import bucket
from ..utils.phase_timer import count, span, sync, traced

_ROUND_SPANS = ("tracker.round.pose_depth", "tracker.round.depth_scale")


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
    """Edge sets and solver windows of one rounds call, and this rank's
    part of them: ``act`` / ``ba_own`` index its active and BA edges
    (None without a group), ``ii``/``jj``/``kx``/``kk`` are its active
    edges and their GraphAgg slots, ``jj_ba_l`` its BA edges' targets,
    ``tgt_in``/``wgt_in`` its rows of the inactive block."""
    v = graph.video
    E_cap, span_cap = _stable_caps(graph)
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
    # a value written through an index tensor is copied to the card first
    kept = graph._idx(np.unique(ii_ba))
    with sync("mask_write"):
        frame_mask[kept] = True
    st = dict(t0=t0, t1=t1, ii_ba=ii_ba, jj_ba=jj_ba, kbase_pd=kbase_pd,
              K_pd=K_pd, P_max=P_max, K_ds=K_ds, frame_mask=frame_mask,
              kx_all=np.unique(graph.ii), bounds=None, act=None,
              ba_own=None)
    group = v.group
    if group is None:
        ii, jj, jj_ba_l = graph.ii, graph.jj, jj_ba
    else:
        bounds = mesh_mod.frame_bounds(graph.ii, group.world, v.buffer)
        act = mesh_mod.rank_edges(graph.ii, bounds)
        ba_own = mesh_mod.rank_edges(ii_ba, bounds)[group.rank]
        sel = sel[ba_own[ba_own < len(sel)]]
        sel_d = graph._idx(sel)
        mine = act[group.rank]
        ii, jj = graph.ii[mine], graph.jj[mine]
        jj_ba_l = jj_ba[ba_own]
        st.update(bounds=bounds, act=act, ba_own=ba_own)
    kx, kk = np.unique(ii, return_inverse=True)
    st.update(ii=ii, jj=jj, kx=kx, kk=kk, jj_ba_l=jj_ba_l,
              tgt_in=graph.target_inac[sel_d],
              wgt_in=graph.weight_inac[sel_d])
    return st


@traced("tracker.update_rounds")
def graph_update_rounds(graph, rounds: int, t0=None, t1=None, itrs=2,
                        use_inactive=True, alternate=True,
                        lm=1e-4, ep=0.1):
    """Run ``rounds`` GRU + BA rounds on ``graph`` and write the results
    into the graph and its video. Rounds alternate pose_depth (even) and
    depth_scale (odd) when ``alternate`` and the video's BA_type is DSPO.
    Returns the keyframe distance d(t1-2, t1-1) (float), or None for an
    empty graph. Each round runs inside span ``tracker.round.<kind>``;
    counters ``tracker.rounds`` and ``tracker.ba_edges`` add one and the
    BA's edges per round."""
    if len(graph.ii) == 0:
        return None
    v = graph.video
    group = v.group
    st = _assemble(graph, t0, t1, use_inactive)
    t0, t1 = st["t0"], st["t1"]
    bounds = st["bounds"]
    dspo_on = v.BA_type == "DSPO" and alternate and v.counter > 0
    mv = v.cfg["tracking"]["multiview_filter"]
    mv_thresh, visible_num = float(mv["thresh"]), int(mv["visible_num"])
    mono_thres = float(v.mono_thres) if v.mono_thres else 0.0
    dev = v.device
    Nbuf = v.buffer
    intr = v.intrinsics
    feat_pyr = v.corr_pyr

    ii_act, jj_act = graph._idx(st["ii"]), graph._idx(st["jj"])
    kk, kx = graph._idx(st["kk"]), graph._idx(st["kx"])
    M = len(st["kx"])
    ii_ba_d, jj_ba_d = graph._idx(st["ii_ba"]), graph._idx(st["jj_ba"])
    poses, disps = v.poses, v.disps
    dsc, dsh, vm = v.depth_scale, v.depth_shift, v.valid_depth_mask_small
    net, inp = graph.net, graph.inp
    target, weight = graph.target, graph.weight
    if group is not None:
        mine = graph._idx(st["act"][group.rank])
        net, inp = net[mine], inp[mine]
        target, weight = target[mine], weight[mine]
    damping = graph.damping.clone()

    def run_pd(poses, disps, wgt, eta_f):
        with span("tracker.ba"):
            p2, d2 = ba_mod.ba(
                poses, disps, intr, tgt_comb, wgt, eta_f, st["ii_ba"],
                st["jj_ba"], t0, t1, st["kbase_pd"], P_max=st["P_max"],
                K_max=st["K_pd"], iters=itrs, lm=lm, ep=ep, refine=0,
                group=group, bounds=bounds)
            return p2, d2.clamp(min=1e-5)

    n_ba = len(st["ii_ba"])
    for r in range(rounds):
        is_ds = dspo_on and r % 2 == 1
        count("tracker.rounds")
        count("tracker.ba_edges", n_ba)
        with span(_ROUND_SPANS[is_ds]):
            with span("tracker.gru"):
                net, target, weight, eta, _, _ = graph_update_step(
                    graph.tn, poses, disps, intr, feat_pyr, net, inp, target,
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

            with span("tracker.realign"):
                M_cur = st["K_ds"]
                base = max(t1 - M_cur, 0)
                idx_np = np.arange(base, base + M_cur)
                idx_np = np.where(idx_np < v.counter, idx_np, 0)
                idx = graph._idx(idx_np)
                vm[idx] = valid_mask_update(poses, disps, intr, idx,
                                            mv_thresh, visible_num)
                est = disps[idx]
                valid = vm[idx].float()
                scale_t, shift_t, error_t = alignment.align_scale_and_shift(
                    v.mono_disps[idx], est, valid)
                okf = torch.isfinite(scale_t) & torch.isfinite(shift_t)
                scale_t = torch.where(okf, scale_t, torch.ones_like(scale_t))
                shift_t = torch.where(okf, shift_t,
                                      torch.zeros_like(shift_t))
                dsc[idx] = scale_t
                dsh[idx] = shift_t

                if mono_thres:
                    avg = est.mean(dim=(1, 2))
                    vs = valid.sum(dim=(1, 2))
                    bad_w = ((error_t / avg > mono_thres)
                             | ~torch.isfinite(error_t)
                             | (scale_t < 0) | (vs < 0.5 * v.h8 * v.w8))
                    bad = torch.zeros(Nbuf, dtype=torch.bool, device=dev)
                    bad[idx] = bad_w
                    keep_e = ~bad[ii_ba_d] & ~bad[jj_ba_d]
                    with sync("keep_edges"):
                        keep_e = keep_e.cpu().numpy()
                    keep_e = mesh_mod.from_rank0(group, keep_e)
                else:
                    keep_e = np.ones(len(st["ii_ba"]), bool)
            if not (keep_e.any() and v.counter > 0):
                poses, disps = run_pd(poses, disps, wgt_comb, eta_full)
                continue
            ii_ds = np.where(keep_e, st["ii_ba"], -1)
            haskept = torch.zeros(Nbuf, dtype=torch.bool, device=dev)
            kept = graph._idx(ii_ds[keep_e])
            with sync("mask_write"):
                haskept[kept] = True
            eta_ds = torch.where(haskept[:, None, None], eta_val,
                                 torch.full_like(eta_val, 1e-7))
            kbase_ds = int(np.clip(ii_ds[keep_e].min(), 0, Nbuf - M_cur))
            if group is not None:
                keep_e, ii_ds = keep_e[st["ba_own"]], ii_ds[st["ba_own"]]
            with sync("keep_upload"):
                keep_d = torch.as_tensor(keep_e, device=dev)
            wgt_ds = wgt_comb * keep_d[:, None, None, None].to(wgt_comb.dtype)
            ii_ds_d, jj_ds_d = graph._idx(ii_ds), graph._idx(st["jj_ba_l"])
            with span("tracker.ba_scale_shift"):
                disps, dsc, dsh = ba_mod.ba_scale_shift(
                    poses, disps, intr, tgt_comb, wgt_ds, eta_ds,
                    v.mono_disps, dsc, dsh, vm, ii_ds_d, jj_ds_d, kbase_ds,
                    K_max=M_cur, iters=itrs, lm=lm, ep=ep, alpha=0.01,
                    group=group, bounds=bounds)
            disps = disps.clamp(min=1e-5)

    with sync("kf_pair", 2):
        ta = torch.tensor([max(t1 - 2, 0)], device=dev)
        tb = torch.tensor([max(t1 - 1, 0)], device=dev)
    kf_dist = dist_mod.frame_distance_bidirectional(
        poses, disps, intr, ta, tb,
        beta=float(v.cfg["tracking"].get("beta", 0.3)))[0]
    up = disps.new_zeros((0,) + tuple(v.disps_up.shape[1:]))
    if M:
        # upsample mask from the final hidden state, once
        _, um = graph.tn.agg(net.permute(0, 3, 1, 2), kk, M)
        up = up_mod.upsample_disp(disps[kx], um.float())
    if group is not None:
        net, target, weight, damping, up = _gather(
            group, graph, st, net, target, weight, damping, up)
        kx = graph._idx(st["kx_all"])
    v.disps_up[kx] = up

    v.poses, v.disps = poses, disps
    v.depth_scale, v.depth_shift, v.valid_depth_mask_small = dsc, dsh, vm
    graph.damping = damping
    graph.net, graph.target, graph.weight = net, target, weight
    graph.age += rounds
    with sync("kf_dist"):
        return float(kf_dist)


def _gather(group, graph, st, net, target, weight, damping, up):
    """Every rank's rows of the rounds' per-edge and per-frame results,
    placed into whole-graph tensors (the same on every rank)."""
    act, bounds = st["act"], st["bounds"]
    sizes = [len(a) for a in act]
    order = graph._idx(np.concatenate(act))
    net_all = torch.empty_like(graph.net)
    net_all[order] = torch.cat(group.gather_rows(net, sizes))
    tw = torch.cat(group.gather_rows(torch.cat([target, weight], -1), sizes))
    tw_all = torch.empty_like(tw)
    tw_all[order] = tw
    kx = st["kx_all"]
    mine = graph._idx(st["kx"])
    rows = mesh_mod.gather_frame_rows(group, bounds, kx, damping[mine])
    damping[graph._idx(kx)] = rows
    up = mesh_mod.gather_frame_rows(group, bounds, kx, up)
    return net_all, tw_all[..., :2], tw_all[..., 2:], damping, up
