"""DepthVideo: the keyframe store shared by the tracker's stages.

Counterpart of ``glorie_slam_tpu/core/depth_video.py``. State lives in
fixed-capacity tensors on one device, updated in place. Layouts follow the
JAX package: images and features are NHWC; fmaps/nets/inps are bf16; the
level-0 correlation store is ``fmaps`` itself viewed as (N, h8*w8, 128)
rows, and the pooled levels are kept beside it, refreshed as frames land.
``counter`` and the dirty flags are host-side: ``dirty`` marks frames whose
full-resolution validity mask is stale, ``npc_dirty`` frames whose neural
points the mapper must re-anchor (it clears them after the deform).

``ba`` dispatches DSPO stage 1 (pose + depth Gauss-Newton) and stage 2
(depth + mono scale/shift) as the JAX package does, including the mono_thres
edge filter and the fall-back to stage 1 when stage 2 has no usable edge.
The full-resolution multiview validity mask is refreshed lazily, on read.
"""

import threading

import numpy as np
import torch

from ..device import resolve_device
from ..geom import alignment, ba as ba_mod, lie
from ..nets import droid_net
from ..ops import corr as corr_mod, depth_filter as df_mod, \
    distance as dist_mod, upsample
from ..utils.buckets import bucket


class DepthVideo:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.ht = ht = cfg["cam"]["H_out"]
        self.wd = wd = cfg["cam"]["W_out"]
        self.down_scale = 8
        self.h8, self.w8 = h8, w8 = ht // 8, wd // 8
        self.buffer = buf = cfg["tracking"]["buffer"]
        self.BA_type = cfg["tracking"]["backend"]["BA_type"]
        self.mono_thres = cfg["tracking"]["mono_thres"]
        self.counter = 0

        f32, bf = torch.float32, torch.bfloat16

        def z(*shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.timestamp = z(buf)
        self.images = z(buf, ht, wd, 3, dtype=torch.uint8)
        self.poses = lie.identity((buf,), device=dev)
        self.disps = torch.ones((buf, h8, w8), dtype=f32, device=dev)
        self.disps_up = z(buf, ht, wd)
        self.intrinsics = z(4)
        self.mono_disps = z(buf, h8, w8)
        self.depth_scale = z(buf)
        self.depth_shift = z(buf)
        self._valid_depth_mask = z(buf, ht, wd, dtype=torch.bool)
        self.valid_depth_mask_small = z(buf, h8, w8, dtype=torch.bool)
        self.fmaps = z(buf, h8, w8, 128, dtype=bf)
        self.nets = z(buf, h8, w8, 128, dtype=bf)
        self.inps = z(buf, h8, w8, 128, dtype=bf)
        # pooled-level stores; a level whose side halves to zero (an h8 or
        # w8 that is not a multiple of 8) stays empty, as in the JAX
        # package, and its window reads as zeros
        dims = []
        h, w = h8, w8
        for _ in range(corr_mod.LEVELS - 1):
            h, w = h // 2, w // 2
            dims.append((h, w))
        self.corr_p = [z(buf, h, w, 128, dtype=bf) for h, w in dims]

        self.dirty = np.zeros(buf, bool)
        self.npc_dirty = np.zeros(buf, bool)
        # guards the mapper thread's scale/shift row writes
        # (``set_depth_scale_shift``) against keyframe removal
        self.state_lock = threading.Lock()

    # ------------------------------------------------------------------
    # appends / accessors
    # ------------------------------------------------------------------

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def append(self, timestamp, image, pose=None, disp=None, mono_depth=None,
               intrinsics=None, fmap=None, net=None, inp=None):
        """Add a keyframe at ``counter``. image (H, W, 3) uint8; fmap/net/inp
        (h8, w8, 128); mono_depth (H, W) or None."""
        ix = self.counter
        self.counter += 1
        self.timestamp[ix] = float(timestamp)
        self.images[ix] = self._t(image, torch.uint8)
        if pose is not None:
            self.poses[ix] = self._t(pose)
        if disp is not None:
            self.disps[ix] = self._t(disp)
        if mono_depth is not None:
            self.mono_disps[ix] = self._subsample_disp(self._t(mono_depth))
        if intrinsics is not None:
            self.intrinsics = self._t(intrinsics)
        if fmap is not None:
            self.fmaps[ix] = fmap.to(torch.bfloat16)
            self._update_corr_stores(ix)
        if net is not None:
            self.nets[ix] = net.to(torch.bfloat16)
        if inp is not None:
            self.inps[ix] = inp.to(torch.bfloat16)

    def append_admitted(self, timestamp, image_f, mono_depth, gmap,
                        tracker_net, intrinsics=None):
        """Keyframe admission: cnet context encode + every store write.

        image_f (H, W, 3) float in [0, 1]; mono_depth (H, W) or None;
        gmap (1, 128, h8, w8) fmap from the motion filter's probe.
        Returns (net, inp), each (1, 128, h8, w8), for the next probe."""
        if intrinsics is not None and not getattr(self, "_intr_set", False):
            self.intrinsics = self._t(intrinsics)
            self._intr_set = True
        ix = self.counter
        self.counter += 1
        image_f = self._t(image_f)
        inputs = droid_net.normalize_images(image_f[None]).permute(0, 3, 1, 2)
        net, inp = tracker_net.context(inputs)
        self.timestamp[ix] = float(timestamp)
        self.images[ix] = (image_f * 255.0).clamp(0, 255).to(torch.uint8)
        if mono_depth is None:
            self.mono_disps[ix] = 0.0
        else:
            self.mono_disps[ix] = self._subsample_disp(self._t(mono_depth))
        self.fmaps[ix] = gmap[0].permute(1, 2, 0).to(torch.bfloat16)
        self._update_corr_stores(ix)
        self.nets[ix] = net[0].permute(1, 2, 0).to(torch.bfloat16)
        self.inps[ix] = inp[0].permute(1, 2, 0).to(torch.bfloat16)
        return net, inp

    def _subsample_disp(self, depth):
        s = self.down_scale
        md = depth[s // 2 - 1::s, s // 2 - 1::s]
        return torch.where(md > 0, 1.0 / md, torch.zeros_like(md))

    def _update_corr_stores(self, ix):
        """Refresh frame ix's pooled lookup stores from fmaps[ix]."""
        pooled = corr_mod.pool_feat_levels(self.fmaps[ix][None])
        for store, p in zip(self.corr_p, pooled):
            store[ix] = p[0, :store.shape[1], :store.shape[2]]

    @property
    def corr_pyr(self):
        """Lookup stores for ``corr.lookup_pyramid_feats``."""
        flat = self.fmaps.reshape(self.buffer, self.h8 * self.w8, 128)
        return (flat,) + tuple(self.corr_p)

    def set_dirty(self, start, end):
        self.dirty[start:end] = True
        self.npc_dirty[start:end] = True

    def set_depth_scale_shift(self, ix, s, q):
        """Write frame ix's mono-prior scale and shift (the mapper's
        alignment)."""
        with self.state_lock:
            self.depth_scale[ix] = s
            self.depth_shift[ix] = q

    def remove_keyframe(self, ix):
        """Copy frame ix + 1 over frame ix (the caller remaps edges and the
        counter), as the JAX package does."""
        with self.state_lock:
            for name in ("timestamp", "images", "poses", "disps", "disps_up",
                         "mono_disps", "depth_scale", "depth_shift",
                         "_valid_depth_mask", "valid_depth_mask_small",
                         "fmaps", "nets", "inps"):
                arr = getattr(self, name)
                arr[ix] = arr[ix + 1]
            for store in self.corr_p:
                store[ix] = store[ix + 1]
        self.dirty[ix] = self.dirty[ix + 1]
        self.npc_dirty[ix] = self.npc_dirty[ix + 1]

    # ------------------------------------------------------------------
    # geometric ops
    # ------------------------------------------------------------------

    def _idx(self, x):
        return torch.as_tensor(np.asarray(x).reshape(-1), dtype=torch.long,
                               device=self.device)

    def distance(self, ii, jj, beta=0.3, bidirectional=True):
        """Mean induced-flow distance for each edge -> numpy (E,)."""
        f = (dist_mod.frame_distance_bidirectional if bidirectional
             else dist_mod.frame_distance)
        ii, jj = self._idx(ii), self._idx(jj)
        if ii.numel() == 0:
            return np.zeros(0, np.float32)
        return f(self.poses, self.disps, self.intrinsics, ii, jj,
                 beta).cpu().numpy()

    def upsample(self, ix, mask):
        """Convex-upsample disps of frames ix into disps_up.
        mask: (len(ix), 576, h8, w8)."""
        ix = self._idx(ix)
        self.disps_up[ix] = upsample.upsample_disp(self.disps[ix],
                                                   mask.float())

    def normalize(self):
        """Rescale mean disparity of frames [0, counter) to 1."""
        t = self.counter
        s = self.disps[:t].sum() / (t * self.h8 * self.w8)
        self.disps[:t] = self.disps[:t] / s
        self.poses[:t] = lie.scale_translation(self.poses[:t], s)
        self.set_dirty(0, t)

    # ------------------------------------------------------------------
    # BA dispatch (DSPO layer)
    # ------------------------------------------------------------------

    def ba(self, target, weight, eta, ii, jj, t0=1, t1=None, iters=2,
           lm=1e-4, ep=0.1, motion_only=False, opt_type="pose_depth"):
        """target/weight (E, h8, w8, 2); eta (M, h8, w8) damping of the
        sorted unique ii frames; ii/jj host int arrays."""
        ii = np.asarray(ii, np.int64)
        jj = np.asarray(jj, np.int64)
        if t1 is None:
            t1 = int(max(ii.max(), jj.max())) + 1
        if self.BA_type == "DSPO":
            if not self._dspo(target, weight, eta, ii, jj, t0, t1, iters,
                              lm, ep, motion_only, opt_type):
                self._dspo(target, weight, eta, ii, jj, t0, t1, iters, lm,
                           ep, motion_only, "pose_depth")
        elif self.BA_type == "DBA":
            self._dspo(target, weight, eta, ii, jj, t0, t1, iters, lm, ep,
                       motion_only, "pose_depth")
        else:
            raise NotImplementedError(self.BA_type)

    def _eta_buffer(self, eta, ii):
        """Per-unique-frame eta rows -> full buffer (1e-7 elsewhere)."""
        full = torch.full((self.buffer, self.h8, self.w8), 1e-7,
                          dtype=torch.float32, device=self.device)
        kx = np.unique(ii[ii >= 0])
        full[self._idx(kx)] = eta[:len(kx)].float()
        return full

    def _window(self, lo, hi):
        """(kbase, K) of the depth window covering frames [lo, hi), sized
        and clamped against the buffer end as in the JAX package."""
        K = min(bucket(max(hi - lo, 1)), self.buffer)
        return min(lo, self.buffer - K), K

    def _dspo(self, target, weight, eta, ii, jj, t0, t1, iters, lm, ep,
              motion_only, opt_type):
        if opt_type == "pose_depth":
            eta_full = self._eta_buffer(eta, ii)
            kbase, K = self._window(int(min(ii.min(), t0)), t1)
            P = bucket(max(t1 - t0, 1))
            self.poses, disps = ba_mod.ba(
                self.poses, self.disps, self.intrinsics, target, weight,
                eta_full, ii, jj, t0, t1, kbase, P_max=P, K_max=K,
                iters=iters, lm=lm, ep=ep, motion_only=motion_only)
            self.disps = disps.clamp(min=1e-5)
            return True
        if opt_type != "depth_scale":
            raise NotImplementedError(opt_type)

        curr = self.counter
        if curr <= 0 or len(ii) == 0:
            return False
        self.update_valid_depth_mask(up=False)
        mono = self.mono_disps[:curr]
        est = self.disps[:curr]
        valid = self.valid_depth_mask_small[:curr].float()
        scale_t, shift_t, error_t = alignment.align_scale_and_shift(
            mono, est, valid)
        ok = torch.isfinite(scale_t) & torch.isfinite(shift_t)
        scale_t = torch.where(ok, scale_t, torch.ones_like(scale_t))
        shift_t = torch.where(ok, shift_t, torch.zeros_like(shift_t))
        self.depth_scale[:curr] = scale_t
        self.depth_shift[:curr] = shift_t

        ii_t, jj_t, target_t, weight_t = ii, jj, target, weight
        if self.mono_thres:
            avg = est.mean(dim=(1, 2)).cpu().numpy()
            err = error_t.cpu().numpy()
            sc = scale_t.cpu().numpy()
            vs = valid.sum(dim=(1, 2)).cpu().numpy()
            bad = ((err / avg > self.mono_thres) | ~np.isfinite(err)
                   | (sc < 0) | (vs < 0.5 * self.h8 * self.w8))
            keep = ~(bad[ii] | bad[jj])
            if keep.sum() == 0:
                return False
            ii_t, jj_t = ii[keep], jj[keep]
            sel = self._idx(np.where(keep)[0])
            target_t, weight_t = target[sel], weight[sel]
            pos = np.where(np.isin(np.unique(ii), np.unique(ii_t)))[0]
            eta = eta[self._idx(pos)]

        eta_full = self._eta_buffer(eta, ii_t)
        kbase, K = self._window(int(ii_t.min()), int(ii_t.max()) + 1)
        self.disps, self.depth_scale, self.depth_shift = \
            ba_mod.ba_scale_shift(
                self.poses, self.disps, self.intrinsics, target_t, weight_t,
                eta_full, self.mono_disps, self.depth_scale,
                self.depth_shift, self.valid_depth_mask_small,
                self._idx(ii_t), self._idx(jj_t), kbase, K_max=K,
                iters=iters, lm=lm, ep=ep, alpha=0.01)
        self.disps = self.disps.clamp(min=1e-5)
        return True

    # ------------------------------------------------------------------
    # multiview depth validity
    # ------------------------------------------------------------------

    @property
    def valid_depth_mask(self):
        """Full-resolution multiview validity mask, refreshed on read for
        the frames marked dirty since the last read."""
        dirty_index = np.where(self.dirty)[0]
        if len(dirty_index):
            mv = self.cfg["tracking"]["multiview_filter"]
            idx = self._idx(dirty_index)
            self._valid_depth_mask[idx] = valid_mask_update(
                self.poses, self.disps_up, self.intrinsics * self.down_scale,
                idx, float(mv["thresh"]), int(mv["visible_num"]))
            self.dirty[dirty_index] = False
        return self._valid_depth_mask

    def update_valid_depth_mask(self, up=True):
        """up=True: the full-resolution mask refreshes lazily on read.
        up=False: refresh the 1/8-res mask of frames [0, counter) now."""
        if up or self.counter == 0:
            return
        mv = self.cfg["tracking"]["multiview_filter"]
        idx = torch.arange(self.counter, device=self.device)
        self.valid_depth_mask_small[idx] = valid_mask_update(
            self.poses, self.disps, self.intrinsics, idx,
            float(mv["thresh"]), int(mv["visible_num"]))

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    def get_pose_c2w(self, index):
        """Frame ``index``'s 4x4 camera-to-world matrix (numpy)."""
        return lie.to_matrix(lie.inv(self.poses[index])).cpu().numpy()

    def get_depth_and_pose(self, index):
        """(depth (H, W), multiview validity (H, W), c2w (4, 4)) of frame
        ``index``, numpy."""
        est_depth = (1.0 / self.disps_up[index].clamp(min=1e-8)).cpu().numpy()
        mask = self.valid_depth_mask[index].cpu().numpy()
        return est_depth, mask, self.get_pose_c2w(index)

    def save_video(self, path):
        t = self.counter
        poses = lie.to_matrix(lie.inv(self.poses[:t])).cpu().numpy()
        depths = (1.0 / self.disps_up[:t].clamp(min=1e-8)).cpu().numpy()
        timestamps = self.timestamp[:t].cpu().numpy()
        masks = self.valid_depth_mask[:t].cpu().numpy()
        np.savez(path, poses=poses, depths=depths, timestamps=timestamps,
                 valid_depth_masks=masks)


def nanmedian(x):
    """Row-wise median ignoring NaN, averaging the two middle values of an
    even count (numpy's convention; ``torch.nanmedian`` takes the lower)."""
    s, _ = torch.sort(x, dim=1)                 # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=1, keepdim=True)
    lo = ((n - 1).clamp(min=0)) // 2
    hi = (n // 2).clamp(max=x.shape[1] - 1)
    med = 0.5 * (s.gather(1, lo) + s.gather(1, hi))
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))[:, 0]


def valid_mask_update(poses, disps, intrinsics, idx, mv_thresh, visible_num):
    """Multiview validity masks (M, ht, wd) of frames ``idx``: at least
    ``visible_num`` agreeing neighbours and depth below 3x the frame's
    median multiview-consistent depth."""
    M = idx.shape[0]
    depths = 1.0 / disps[idx].clamp(min=1e-8)
    thresh = mv_thresh * depths.mean(dim=(1, 2))
    counts = df_mod.depth_filter(poses, disps, intrinsics, idx, thresh)
    multiview = counts >= visible_num
    masked = torch.where(multiview, depths,
                         torch.full_like(depths, float("nan")))
    med = nanmedian(masked.reshape(M, -1))
    return multiview & (depths < 3 * med[:, None, None])
