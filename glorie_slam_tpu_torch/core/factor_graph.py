"""Factor graph: covisibility edges and the recurrent GRU + BA update.

Counterpart of ``glorie_slam_tpu/core/factor_graph.py``. Edge bookkeeping
(add / remove / dedup / eviction, proximity proposals) is host numpy and
C++; per-edge state (net, inp, target, weight) lives in tensors with
exactly one row per active edge, in the active-edge order of the JAX
package (its capacity padding only served fixed XLA shapes). Removed
edges' target/weight rows move to the inactive pool, which the frontend's
BA also reads.
"""

import numpy as np
import torch

from .. import native
from ..geom import projective
from ..ops import corr as corr_mod

_BF = torch.bfloat16
EP = 1e-7          # added to the GRU's damping before every BA solve


def graph_update_step(tn, poses, disps, intrinsics, feat_pyr, net, inp,
                      target, ii, jj, kk, coords0, num_frames,
                      with_upmask=True):
    """Reproject -> motion features -> correlation lookup -> ConvGRU.

    net/inp (E, h, w, 128) bf16; target (E, h, w, 2); ii/jj/kk (E,) long.
    Returns (net' (E,h,w,128), target', weight' (E,h,w,2) f32,
    eta (M,h,w) f32, upmask (M,576,h,w) f32 or None, coords1)."""
    coords1, _ = projective.projective_transform(poses, disps, intrinsics,
                                                 ii, jj)
    motn = torch.cat([coords1 - coords0[None], target - coords1], dim=-1)
    motn = motn.clamp(-64.0, 64.0)
    corr = corr_mod.lookup_pyramid_feats(feat_pyr, ii, jj, coords1)

    def nchw(x):
        return x.to(_BF).permute(0, 3, 1, 2)

    net2, delta, weight, eta, upmask = tn.update(
        nchw(net), nchw(inp), nchw(corr), nchw(motn), kk, num_frames,
        with_upmask=with_upmask)
    target2 = coords1 + delta.float().permute(0, 2, 3, 1)
    return (net2.permute(0, 2, 3, 1).to(_BF), target2,
            weight.float().permute(0, 2, 3, 1), eta.float(),
            None if upmask is None else upmask.float(), coords1)


class FactorGraph:
    def __init__(self, video, tracker_net, max_factors: int = -1):
        """``max_factors`` > 0 (the frontend's graph) evicts the oldest
        edges past that many; the backend's graphs pass none, their
        proposals bound them."""
        self.video = video
        self.tn = tracker_net
        self.max_factors = max_factors
        self.h8, self.w8 = video.h8, video.w8
        dev = self.device = video.device
        self.coords0 = projective.coords_grid(self.h8, self.w8, device=dev)

        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)
        self.net = self._zeros(0, 128, _BF)
        self.inp = self._zeros(0, 128, _BF)
        self.target = self._zeros(0, 2)
        self.weight = self._zeros(0, 2)
        self.damping = 1e-6 * torch.ones_like(video.disps)

        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.ii_bad = np.zeros(0, np.int64)
        self.jj_bad = np.zeros(0, np.int64)
        self.target_inac = self._zeros(0, 2)
        self.weight_inac = self._zeros(0, 2)

    def _zeros(self, n, c, dtype=torch.float32):
        return torch.zeros((n, self.h8, self.w8, c), dtype=dtype,
                           device=self.device)

    def _idx(self, x):
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    # ------------------------------------------------------------------
    # edge management
    # ------------------------------------------------------------------

    def _filter_repeated_edges(self, ii, jj):
        """Drop edges already present (active or inactive)."""
        eset = set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep = np.array([(i, j) not in eset for i, j in zip(ii, jj)], bool)
        return ii[keep], jj[keep]

    def _append(self, ii, jj):
        """Append new edges: state rows gathered from the video, targets
        from the current reprojection, zero weights."""
        v = self.video
        ii_d, jj_d = self._idx(ii), self._idx(jj)
        target, _ = projective.projective_transform(
            v.poses, v.disps, v.intrinsics, ii_d, jj_d)
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])
        self.net = torch.cat([self.net, v.nets[ii_d]])
        self.inp = torch.cat([self.inp, v.inps[ii_d]])
        self.target = torch.cat([self.target, target])
        self.weight = torch.cat([self.weight, torch.zeros_like(target)])

    def add_factors(self, ii, jj, remove=False):
        """Add edges, evicting the oldest past ``max_factors``."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        ii, jj = self._filter_repeated_edges(ii, jj)
        if len(ii) == 0:
            return
        if (self.max_factors > 0
                and len(self.ii) + len(ii) > self.max_factors
                and len(self.ii) > 0
                and remove):
            ix = np.argsort(-self.age, kind="stable")
            drop = np.zeros(len(self.ii), bool)
            drop[ix[:len(self.ii) + len(ii) - self.max_factors]] = True
            self.rm_factors(drop, store=True)
        self._append(ii, jj)

    def maintain(self, pre_rm_mask, ii, jj, remove=True):
        """rm-by-age + dedup + eviction + append, in the JAX package's
        order: the dedup filter runs against the pre-removal sets, and every
        removed edge (aged or evicted) enters the inactive pool in
        active-index order."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        ii, jj = self._filter_repeated_edges(ii, jj)
        E_old = len(self.ii)
        rm = (np.asarray(pre_rm_mask, bool).copy()
              if pre_rm_mask is not None else np.zeros(E_old, bool))
        k_new = len(ii)
        if (self.max_factors > 0 and E_old > 0 and k_new > 0
                and remove):
            n_drop = (E_old - int(rm.sum())) + k_new - self.max_factors
            if n_drop > 0:
                order = np.argsort(-self.age, kind="stable")
                order = order[~rm[order]]
                rm[order[:n_drop]] = True
        if rm.sum() == 0 and k_new == 0:
            return
        if rm.any():
            self.rm_factors(rm, store=True)
        if k_new:
            self._append(ii, jj)

    def rm_factors(self, mask, store=False):
        """Remove edges; with ``store`` their target/weight rows move to the
        inactive pool."""
        mask = np.asarray(mask, bool)
        if mask.sum() == 0:
            return
        if store:
            sel = self._idx(np.where(mask)[0])
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
            self.target_inac = torch.cat([self.target_inac,
                                          self.target[sel]])
            self.weight_inac = torch.cat([self.weight_inac,
                                          self.weight[sel]])
        keep = self._idx(np.where(~mask)[0])
        self.ii, self.jj, self.age = (self.ii[~mask], self.jj[~mask],
                                      self.age[~mask])
        self.net, self.inp = self.net[keep], self.inp[keep]
        self.target, self.weight = self.target[keep], self.weight[keep]

    def rm_keyframe(self, ix):
        """Drop keyframe ix: shift video state and remap edges."""
        self.video.remove_keyframe(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac[self.ii_inac >= ix] -= 1
        self.jj_inac[self.jj_inac >= ix] -= 1
        if m.any():
            keep = self._idx(np.where(~m)[0])
            self.ii_inac, self.jj_inac = self.ii_inac[~m], self.jj_inac[~m]
            self.target_inac = self.target_inac[keep]
            self.weight_inac = self.weight_inac[keep]
        m = (self.ii == ix) | (self.jj == ix)
        self.ii[self.ii >= ix] -= 1
        self.jj[self.jj >= ix] -= 1
        self.rm_factors(m, store=False)

    def clear_edges(self):
        self.rm_factors(np.ones(len(self.ii), bool), store=False)

    # ------------------------------------------------------------------
    # recurrent update
    # ------------------------------------------------------------------

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False,
               motion_only=False, opt_type="pose_depth"):
        """One GRU + BA update over the active edges."""
        if len(self.ii) == 0:
            return
        v = self.video
        kx, kk = np.unique(self.ii, return_inverse=True)
        net, target, weight, eta, upmask, _ = graph_update_step(
            self.tn, v.poses, v.disps, v.intrinsics, v.corr_pyr, self.net,
            self.inp, self.target, self._idx(self.ii), self._idx(self.jj),
            self._idx(kk), self.coords0, len(kx))
        self.net, self.target, self.weight = net, target, weight
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        self.damping[self._idx(kx)] = eta

        if use_inactive:
            m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
            sel = self._idx(np.where(m)[0])
            ii = np.concatenate([self.ii_inac[m], self.ii])
            jj = np.concatenate([self.jj_inac[m], self.jj])
            target = torch.cat([self.target_inac[sel], self.target])
            weight = torch.cat([self.weight_inac[sel], self.weight])
        else:
            ii, jj = self.ii, self.jj
            target, weight = self.target, self.weight
        eta_ba = 0.2 * self.damping[self._idx(np.unique(ii))] + EP
        v.ba(target, weight, eta_ba, ii, jj, t0, t1, iters=itrs, lm=1e-4,
             ep=0.1, motion_only=motion_only, opt_type=opt_type)
        v.upsample(kx, upmask)
        self.age += 1

    def update_lowmem(self, t0=None, t1=None, itrs=2, steps=8,
                      enable_wq=True):
        """Backend update: the GRU runs over source-frame chunks of 8
        frames (bounded activations), then BA over all edges; ``steps``
        times, alternating pose_depth / depth_scale when ``enable_wq``."""
        v = self.video
        for step in range(steps):
            ii_all, jj_all = self._idx(self.ii), self._idx(self.jj)
            coords1_all, _ = projective.projective_transform(
                v.poses, v.disps, v.intrinsics, ii_all, jj_all)
            motn_all = torch.cat([coords1_all - self.coords0[None],
                                  self.target - coords1_all], dim=-1)
            motn_all = motn_all.clamp(-64.0, 64.0)
            net_new = self.net.clone()
            target_new = self.target.clone()
            weight_new = self.weight.clone()
            s = 8
            for i in range(0, int(self.jj.max()) + 1, s):
                sel_np = np.where((self.ii >= i) & (self.ii < i + s))[0]
                if len(sel_np) == 0:
                    continue
                sel = self._idx(sel_np)
                kx, kk = np.unique(self.ii[sel_np], return_inverse=True)
                coords_c = coords1_all[sel]
                corr = corr_mod.lookup_pyramid_feats(
                    v.corr_pyr, ii_all[sel], jj_all[sel], coords_c)

                def nchw(x):
                    return x.to(_BF).permute(0, 3, 1, 2)

                net2, delta, w2, eta, upmask = self.tn.update(
                    nchw(self.net[sel]), nchw(v.inps[ii_all[sel]]),
                    nchw(corr), nchw(motn_all[sel]), self._idx(kk), len(kx))
                net_new[sel] = net2.permute(0, 2, 3, 1).to(_BF)
                target_new[sel] = (coords_c
                                   + delta.float().permute(0, 2, 3, 1))
                weight_new[sel] = w2.float().permute(0, 2, 3, 1)
                kx_d = self._idx(kx)
                self.damping[kx_d] = eta.float()
                v.upsample(kx, upmask)
            self.net, self.target, self.weight = (net_new, target_new,
                                                  weight_new)
            eta_ba = 0.2 * self.damping[self._idx(np.unique(self.ii))] + EP
            opt_type = ("depth_scale" if enable_wq and step % 2 == 1
                        else "pose_depth")
            v.ba(self.target, self.weight, eta_ba, self.ii, self.jj, t0, t1,
                 iters=itrs, lm=1e-5, ep=1e-2, motion_only=False,
                 opt_type=opt_type)

    # ------------------------------------------------------------------
    # edge proposal
    # ------------------------------------------------------------------

    def add_neighborhood_factors(self, t0, t1, r=3):
        """Edges between all frames of [t0, t1) within temporal radius r."""
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False, pre_rm_mask=None):
        """Distance-sorted greedy proposal with NMS (native C++).
        ``pre_rm_mask``: active edges to retire in the same maintenance
        step (see ``maintain``)."""
        t = self.video.counter
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        if len(ix) == 0 or len(jx) == 0:
            if pre_rm_mask is not None and pre_rm_mask.any():
                self.rm_factors(pre_rm_mask, store=True)
            return
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        d = self.video.distance(ii.reshape(-1), jj.reshape(-1), beta=beta)
        n_ii, n_jj = native.proximity_edges(
            d.reshape(len(ix), len(jx)), t0, t1, t, rad, nms, thresh,
            self.max_factors,
            np.concatenate([self.ii, self.ii_bad, self.ii_inac]),
            np.concatenate([self.jj, self.jj_bad, self.jj_inac]))
        if pre_rm_mask is not None:
            self.maintain(pre_rm_mask, n_ii, n_jj, remove=remove)
        elif len(n_ii):
            self.add_factors(n_ii, n_jj, remove)

    def add_backend_proximity_factors(self, t_start, t_end, nms, radius,
                                      thresh, max_factors, beta,
                                      t_start_loop=None, loop=False):
        """Backend / loop-closure edge proposal (native C++). Returns the
        active edge count, or 0 when fewer than 3 edges were proposed."""
        if t_start_loop is None or not loop:
            t_start_loop = t_start
        ilen, jlen = t_end - t_start_loop, t_end - t_start
        ii, jj = np.meshgrid(np.arange(t_start_loop, t_end),
                             np.arange(t_start, t_end), indexing="ij")
        d = self.video.distance(ii.reshape(-1), jj.reshape(-1), beta=beta)
        rawd = d.copy().reshape(ilen, jlen)
        n_ii, n_jj = native.backend_proximity_edges(
            d.reshape(ilen, jlen), rawd, t_start, t_end, t_start_loop, nms,
            radius, thresh, max_factors, loop)
        if len(n_ii) < 3:
            return 0
        self.add_factors(n_ii, n_jj, remove=True)
        return len(self.ii)
