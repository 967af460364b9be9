"""Mapper: optimisation of the deformable neural point cloud.

Counterpart of ``glorie_slam_tpu/mapping/mapper.py`` (reference
src/mapper.py:35-859). Per keyframe handshake:

1. deform the cloud to the latest poses and depths (one batched pass);
2. align the mono prior (scale and shift) and anchor new neural points;
3. build the proxy render depth (droid, then the splatted cloud, then the
   scaled mono prior);
4. optimise a window of keyframes jointly: Adam over the decoder weights
   and the geometry and colour features, with per-stage learning rates and
   L1 depth + L1 colour + pixel-warping losses (reference mapper.py:326-513).

Host randomness (pixel sampling, window choice) draws from one
``np.random.default_rng(setup_seed)`` in the JAX package's call order, so
both packages sample the same pixels. Frustum feature selection is a
gradient mask; ray batches are zero-padded to ``bucket(pixels per frame x
frames)`` as in the JAX package, because the renderer's ``far`` is taken
over the padded batch.

The optimiser matches optax ``scale_by_adam`` (betas 0.9 / 0.999, eps
1e-8, bias-corrected) scaled by per-group learning rates: one
``torch.optim.Adam`` with three groups (decoders, geometry features, colour
features) is made anew for every ``optimize_map`` call
(``make_optimizer``), its learning rates are set before every step, and
every parameter has a gradient tensor at every step (zeros where it took no
part), so all groups count steps together. Gradients are masked before the
step.

``eval_kf_imgs`` and ``eval_imgs`` run the render evaluations
(``utils/eval_render.py``). Unless ``silence``, the first mapped keyframe
and every ``Visualizer.freq``-th one (50) are re-rendered after their
optimisation for the visualizer's panels (``utils/visualizer.py``; skipped
with a message without matplotlib); a failure there fails the run, unlike
the JAX mapper's best-effort ``except``.
"""

import os

import numpy as np
import torch

from ..geom import alignment, lie
from ..utils import eval_render
from ..utils.buckets import bucket
from ..utils.phase_timer import span, sync, traced
from ..utils.visualizer import Visualizer
from . import sampling
from .decoders import PointDecoders
from .import_pointslam import load_pointslam_geo_decoder
from .point_cloud import NeuralPointCloud, rays_from_uv
from .renderer import RenderConfig, render_img, render_rays

_X_FLIP = (-1.0, 1.0, 1.0)


def smooth_l1(x, beta=0.1):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def pix_warping_loss(rays_o, rays_d, depth, gt_color, ray_frame_slot,
                     frame_valid, c2ws, img_colors, intr, Wi, Hi):
    """Photometric loss of the rendered points in the other window frames
    (reference mapper.py:326-388): each ray's point is projected into every
    frame but its own; rays seen by at least 4 frames compare the bilinear
    colour there (border padding, as ``grid_sample(align_corners=False)``
    on ``u / W * 2 - 1``) with their own, smooth L1 (beta 0.1)."""
    fx, fy, cx, cy = intr
    F = c2ws.shape[0]
    pts = rays_o + rays_d * depth[:, None]                       # (R, 3)
    with sync("pose_inverse"):
        w2cs = torch.linalg.inv(c2ws)
    cam = (torch.einsum("fij,rj->fri", w2cs[:, :3, :3], pts)
           + w2cs[:, None, :3, 3])
    with sync("x_flip"):
        cam = cam * cam.new_tensor(_X_FLIP)                      # x flip
    z = cam[..., 2]
    u = fx * cam[..., 0] / (z + 1e-6) + cx
    v = fy * cam[..., 1] / (z + 1e-6) + cy
    edge = 5
    ok = (u > edge) & (u < Wi - edge) & (v > edge) & (v < Hi - edge) & (z < 0)
    ok = ok & frame_valid[:, None]
    frames = torch.arange(F, device=depth.device)
    ok = ok & (ray_frame_slot < F)[None, :]                      # padding
    ok = ok & (ray_frame_slot[None, :] != frames[:, None])       # own frame
    ok = ok & (torch.sum(ok, dim=0) >= 4)[None, :]
    uu = (u - 0.5).clamp(0.0, Wi - 1.0)
    vv = (v - 0.5).clamp(0.0, Hi - 1.0)
    # out-of-range reads are clamped, as the JAX package's gathers clamp
    u0 = torch.floor(uu).long().clamp(0, Wi - 1)
    v0 = torch.floor(vv).long().clamp(0, Hi - 1)
    u1 = (u0 + 1).clamp(max=Wi - 1)
    v1 = (v0 + 1).clamp(max=Hi - 1)
    du = (uu - u0)[..., None]
    dv = (vv - v0)[..., None]
    f = frames[:, None]
    warped = ((1 - dv) * ((1 - du) * img_colors[f, v0, u0]
                          + du * img_colors[f, v0, u1])
              + dv * ((1 - du) * img_colors[f, v1, u0]
                      + du * img_colors[f, v1, u1]))             # (F, R, 3)
    per = torch.mean(smooth_l1(warped - gt_color[None], beta=0.1), dim=-1)
    cnt = torch.sum(ok).clamp(min=1)
    return torch.sum(torch.where(ok, per, torch.zeros_like(per))) / cnt


def _map_train_step(decoders, rcfg, opt, geo, col, lrs, cloud_pos, count,
                    rays_o, rays_d, render_depth, gt_color, r_query,
                    inside_mask, ray_frame_slot, frame_valid, c2ws,
                    img_colors, feat_mask, dec_mask, intr, w_losses, stage,
                    pix_warp, Wi, Hi):
    """One mapping step: render -> losses -> gradients -> Adam (reference
    optimizer_update_one_step, mapper.py:390-515). ``geo``/``col`` are the
    cloud's feature tensors, trained in place; ``opt`` holds the decoder,
    geometry and colour groups, in that order, every parameter with a
    gradient tensor; ``lrs`` their learning rates; ``feat_mask`` (cap, 1)
    and ``dec_mask`` {"geo_decoder": 0/1, "color_decoder": 0/1} multiply the
    gradients. Returns the losses as 0-d tensors."""
    w_geo, w_color, w_warp = w_losses
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    opt.zero_grad(set_to_none=False)
    depth, _, color, _, _ = render_rays(
        rcfg, decoders, rays_o, rays_d, render_depth, cloud_pos, count, geo,
        col, r_query, stage)
    depth_mask = (render_depth > 0) & torch.isfinite(depth) & inside_mask
    geo_loss = torch.sum(torch.where(depth_mask, (render_depth - depth).abs(),
                                     torch.zeros_like(depth)))
    loss = w_geo * geo_loss
    color_err = (gt_color - color).abs()
    color_loss = torch.sum(torch.where(depth_mask[:, None], color_err,
                                       torch.zeros_like(color_err)))
    if stage == "color":
        loss = loss + w_color * color_loss
    warp_loss = torch.zeros((), device=depth.device)
    if pix_warp:
        warp_loss = pix_warping_loss(rays_o, rays_d, depth, gt_color,
                                     ray_frame_slot, frame_valid, c2ws,
                                     img_colors, intr, Wi, Hi)
        loss = loss + w_warp * warp_loss
    # the backward synchronizes once, inside; its span holds the
    # backward's dispatch as well
    with sync("backward"):
        loss.backward()
    geo.grad.mul_(feat_mask)
    col.grad.mul_(feat_mask)
    for name, p in decoders.named_parameters():
        p.grad.mul_(dec_mask[name.split(".")[0]])
    opt.step()
    return {"geo_loss": geo_loss.detach(), "color_loss": color_loss.detach(),
            "warp_loss": warp_loss.detach(),
            "n_mask": torch.sum(depth_mask).clamp(min=1)}


def make_optimizer(decoders, geo, col):
    """Adam over the decoder weights, the geometry features and the colour
    features (three groups, in that order), with optax ``scale_by_adam``'s
    constants. Every parameter is made trainable and given a zero gradient
    tensor, so that each step counts for every group."""
    dec = list(decoders.parameters())
    for p in dec + [geo, col]:
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    return torch.optim.Adam([{"params": dec}, {"params": [geo]},
                             {"params": [col]}], lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8)


def release(decoders, geo, col):
    """Undo ``make_optimizer``: no parameter trainable, no gradients."""
    for p in list(decoders.parameters()) + [geo, col]:
        p.requires_grad_(False)
        p.grad = None


class Mapper:
    def __init__(self, slam, cfg):
        self.cfg = cfg
        self.video = slam.video
        self.device = self.video.device
        self.printer = slam.printer
        self.output = slam.output

        m = cfg["mapping"]
        self.mapping_pixels = m["pixels"]
        self.pixels_adding = m["pixels_adding"]
        self.pixels_based_on_color_grad = m["pixels_based_on_color_grad"]
        self.geo_iter_first = m["geo_iter_first"]
        self.iters_first = m["iters_first"]
        self.geo_iter_ratio = m["geo_iter_ratio"]
        self.mapping_window_size = m["mapping_window_size"]
        self.frustum_feature_selection = m["frustum_feature_selection"]
        self.keyframe_selection_method = m["keyframe_selection_method"]
        self.frustum_edge = m["frustum_edge"]
        self.min_iter_ratio = m["min_iter_ratio"]
        self.pix_warping = m["pix_warping"]
        self.w_losses = (m["w_geo_loss"], m["w_color_loss"],
                         m["w_pix_warp_loss"])
        self.fix_geo_decoder = m["fix_geo_decoder"]
        self.fix_color_decoder = m["fix_color_decoder"]
        self.render_depth_type = m["render_depth"]
        self.use_mono_to_complete = m["use_mono_to_complete"]
        self.use_dynamic_radius = cfg["pointcloud"]["use_dynamic_radius"]
        self.bind_npc_with_pose = cfg["pointcloud"]["bind_npc_with_pose"]

        seed = cfg.get("setup_seed", 43)
        self.npc = NeuralPointCloud(
            cfg, capacity=cfg["pointcloud"].get("capacity", 1 << 20),
            seed=seed, device=self.device)
        self.H, self.W = slam.H, slam.W
        self.fx, self.fy, self.cx, self.cy = slam.fx, slam.fy, slam.cx, slam.cy
        self.rcfg = RenderConfig.from_cfg(cfg)
        self.decoders = PointDecoders.from_cfg(cfg, seed=seed).to(self.device)
        ckpt = m.get("pretrained")
        if ckpt and os.path.exists(ckpt):
            self.decoders.load_state_dict(load_pointslam_geo_decoder(
                ckpt, self.decoders.state_dict()))
            self._print(f"Loaded Point-SLAM geo decoder from {ckpt}", "info")

        self.keyframe_dict = []
        self.keyframe_list = []
        self.dynamic_r_add = None
        self.dynamic_r_query = None
        self.r_query_store = {}
        # loss curves, sampled every 20 iterations and at the last
        self.loss_history = []
        self.rng = np.random.default_rng(seed)
        self.init = True
        self.frame_reader = slam.stream
        self.n_img = len(slam.stream)
        self.visualizer = Visualizer(
            os.path.join(self.output, "mapping_vis"),
            img_dir=os.path.join(self.output, "rendered_image"),
            printer=self.printer)
        self.save_rendered_image = m.get("save_rendered_image", False)
        self._cur_video_idx = self._cur_mono = None

    def _print(self, msg, sub="mapper"):
        self.printer.print(msg, subsystem=sub)

    def _t(self, x, dtype=torch.float32):
        with sync("map_upload"):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

    def _c2w_nerf(self, video_idx):
        """Estimated c2w in the NeRF convention (y and z flipped)."""
        c2w = self.video.get_pose_c2w(video_idx).copy()
        c2w[:3, 1:3] *= -1
        return c2w

    def _load_mono(self, idx):
        from ..utils.datasets import load_mono_depth

        try:
            return load_mono_depth(idx, self.cfg)
        except FileNotFoundError:
            return None

    # ------------------------------------------------------------------
    def get_c2w_and_depth(self, video_idx, idx, mono_depth,
                          print_info=False):
        """(c2w, aligned mono depth or None, droid depth) on the device, or
        three Nones when the frame has under 100 valid depths (reference
        mapper.py:246-279). Writes the frame's mono scale and shift to the
        video."""
        est_depth, valid_mask, c2w = self.video.get_depth_and_pose(video_idx)
        if print_info:
            total, valid = valid_mask.size, int(valid_mask.sum())
            self._print(f"valid droid depth: {valid}/{total} "
                        f"({100 * valid / total:.2f}%)")
        if valid_mask.sum() < 100:
            self._print(f"Skip mapping frame {idx}: not enough valid depth")
            return None, None, None
        est_depth = np.where(valid_mask, est_depth, 0.0)
        c2w = c2w.copy()
        c2w[:3, 1:3] *= -1
        if mono_depth is None:
            return self._t(c2w), None, self._t(est_depth)
        mono_depth = np.asarray(mono_depth)
        mono_valid = mono_depth < mono_depth.mean() * 3
        scale, shift, _ = alignment.align_scale_and_shift(
            self._t(mono_depth)[None], self._t(est_depth)[None],
            self._t((mono_valid & valid_mask).astype(np.float32))[None])
        with sync("prior_scale", 2):
            s, q = float(scale[0]), float(shift[0])
        if not np.isfinite(s):
            s, q = 1.0, 0.0
        self.video.set_depth_scale_shift(video_idx, s, q)
        return (self._t(c2w), self._t(mono_depth * s + q),
                self._t(est_depth))

    # ------------------------------------------------------------------
    def _rays(self, i, j, c2w):
        return rays_from_uv(self._t(i), self._t(j), c2w, self.fx, self.fy,
                            self.cx, self.cy)

    def anchor_points(self, anchor_depth, gt_color, c2w, video_idx):
        """Anchor new neural points at sampled pixels, then at pixels of
        high colour gradient (reference mapper.py:281-324)."""
        H, W = self.H, self.W
        mask = anchor_depth > 0
        i, j, d, c = sampling.sample_pixels(
            self.rng, self.pixels_adding, H, W, anchor_depth, gt_color, mask)
        rays_o, rays_d = self._rays(i, j, c2w)
        dyn_r = (self._t(self.dynamic_r_add[j, i])
                 if self.use_dynamic_radius else None)
        self.npc.add_points(self.video, video_idx)
        added = self.npc.add_neural_points(
            rays_o, rays_d, self._t(d), self._t(c), video_idx, i, j,
            dynamic_radius=dyn_r)
        if self.pixels_based_on_color_grad > 0:
            i2, j2, d2, c2 = sampling.sample_pixels_with_grad(
                self.rng, self.pixels_based_on_color_grad, H, W,
                anchor_depth, gt_color, mask)
            ro2, rd2 = self._rays(i2, j2, c2w)
            dyn2 = (self._t(self.dynamic_r_add[j2, i2])
                    if self.use_dynamic_radius else None)
            added += self.npc.add_neural_points(
                ro2, rd2, self._t(d2), self._t(c2), video_idx, i2, j2,
                is_pts_grad=True, dynamic_radius=dyn2)
        self._print(f"{added} locations to add points.", "pcl")
        return added

    # ------------------------------------------------------------------
    def keyframe_selection_overlap(self, cur_depth, cur_c2w, k, N_samples=8,
                                   pixels=200):
        """Up to k earlier keyframes that see the current frame's points,
        in random order (reference mapper.py:176-244)."""
        H, W = self.H, self.W
        i, j, d, _ = sampling.sample_pixels(
            self.rng, pixels, H, W, cur_depth, np.zeros((H, W, 3), np.float32),
            cur_depth > 0)
        with sync("rays_to_host", 2):
            rays_o, rays_d = (r.cpu().numpy()
                              for r in self._rays(i, j, cur_c2w))
        t = np.linspace(0.0, 1.0, N_samples)
        near = d[:, None] * 0.8
        far = d[:, None] + 0.5
        z = near * (1 - t) + far * t
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
               ).reshape(-1, 3)
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                      [0, 0, 1.0]])
        scores = []
        for kf_id, kf in enumerate(self.keyframe_dict[:-1]):
            w2c = np.linalg.inv(self._c2w_nerf(kf["video_idx"]))
            cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
            cam[:, 0] *= -1
            uvz = cam @ K.T
            zc = uvz[:, 2] + 1e-5
            uv = uvz[:, :2] / zc[:, None]
            edge = 20
            ok = ((uv[:, 0] > edge) & (uv[:, 0] < W - edge)
                  & (uv[:, 1] > edge) & (uv[:, 1] < H - edge) & (zc < 0))
            scores.append((kf_id, ok.mean()))
        scores.sort(key=lambda x: -x[1])
        chosen = [kf_id for kf_id, s in scores if s > 0.0]
        return (list(self.rng.permutation(np.array(chosen))[:k])
                if chosen else [])

    # ------------------------------------------------------------------
    def _frustum_grad_mask(self, c2w, depth_np):
        """Frustum feature selection as a (cap, 1) gradient mask of the
        points in front of and at most 0.5 behind the frame's depth
        (reference get_mask_from_c2w, mapper.py:126-174), numpy on the host
        over the valid points, as in the JAX package."""
        H, W = self.H, self.W
        n = self.npc.count
        with sync("cloud_to_host"):
            pts = self.npc.cloud_pos[:n].cpu().numpy()
        w2c = np.linalg.inv(c2w)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        cam[:, 0] *= -1
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                      [0, 0, 1.0]])
        uvz = cam @ K.T
        z = uvz[:, 2] + 1e-5
        uv = uvz[:, :2] / z[:, None]
        edge = self.frustum_edge
        ok = ((uv[:, 0] > edge) & (uv[:, 0] < W - edge)
              & (uv[:, 1] > edge) & (uv[:, 1] < H - edge))
        ui = np.clip(uv[:, 0].astype(int), 0, W - 1)
        vi = np.clip(uv[:, 1].astype(int), 0, H - 1)
        d = depth_np[vi, ui]
        d = np.where(d == 0, depth_np.max(), d)
        ok = ok & (-z >= 0) & (-z <= d + 0.5)
        mask = torch.zeros((self.npc.cap, 1), device=self.device)
        mask[:n, 0] = self._t(ok.astype(np.float32))
        return mask

    def _live_mask(self):
        mask = torch.zeros((self.npc.cap, 1), device=self.device)
        mask[:self.npc.count] = 1.0
        return mask

    # ------------------------------------------------------------------
    def _window(self, color_refine, cur_depth, cur_c2w):
        """Indices into ``keyframe_dict`` of the window's keyframes, then
        the last mapped keyframe and -1 (the current frame)."""
        num = self.mapping_window_size - 2
        if len(self.keyframe_dict) == 0:
            frames = []
        elif self.keyframe_selection_method == "global" or color_refine:
            n_kf = len(self.keyframe_dict) - 1
            frames = list(self.rng.permutation(np.arange(n_kf))[:min(n_kf,
                                                                     num)])
        else:
            frames = self.keyframe_selection_overlap(cur_depth, cur_c2w, num)
        if len(self.keyframe_list) > 0:
            frames = list(frames) + [len(self.keyframe_list) - 1]
        return frames + [-1]

    def _window_frames(self, color_refine, cur_depth, cur_gt_color, cur_c2w,
                       cur_r_query):
        """Per window frame: render depth and mask, colour, c2w (numpy) and
        query-radius map."""
        frames = []
        for frame in self._window(color_refine, cur_depth, cur_c2w):
            if frame != -1:
                kf = self.keyframe_dict[int(frame)]
                c2w, mono_wq, droid_depth = self.get_c2w_and_depth(
                    kf["video_idx"], kf["idx"], kf["mono_depth"])
                if c2w is None:
                    continue
                if self.render_depth_type == "proxy":
                    render_depth = self.npc.get_proxy_render_depth(
                        c2w, droid_depth, mono_wq,
                        use_mono_to_complete=self.use_mono_to_complete)
                    with sync("depth_to_host"):
                        render_depth = render_depth.cpu().numpy()
                    render_mask = render_depth > 0
                else:
                    with sync("depth_to_host"):
                        render_depth = mono_wq.cpu().numpy()
                    render_mask = np.ones((self.H, self.W), bool)
                gt_color = kf["color"]
                r_query = self.r_query_store.get(kf["idx"])
                if r_query is not None:
                    r_query = r_query / 3.0 * render_depth
                with sync("pose_to_host"):
                    c2w = c2w.cpu().numpy()
            else:
                if color_refine:
                    continue
                render_depth, render_mask = cur_depth, cur_depth > 0
                gt_color = cur_gt_color
                with sync("pose_to_host"):
                    c2w = cur_c2w.cpu().numpy()
                r_query = cur_r_query
            frames.append(dict(render_depth=render_depth,
                               render_mask=render_mask, gt_color=gt_color,
                               c2w=c2w, r_query=r_query))
        return frames

    def _ray_batch(self, frames, pixs_per_image, c2ws, R_total):
        """Sample each window frame's pixels (host RNG) and pad the batch
        to ``R_total`` rays -> device tensors (rays_o, rays_d, depth,
        color, r_query, inside, slot)."""
        H, W = self.H, self.W
        ro_l, rd_l, dep_l, col_l, rq_l, slot_l = [], [], [], [], [], []
        for sidx, f in enumerate(frames):
            i, j, d, c = sampling.sample_pixels(
                self.rng, pixs_per_image, H, W, f["render_depth"],
                f["gt_color"], f["render_mask"])
            ro, rd = self._rays(i, j, c2ws[sidx])
            ro_l.append(ro)
            rd_l.append(rd)
            dep_l.append(d)
            col_l.append(c)
            slot_l.append(np.full(len(i), sidx, np.int32))
            if self.use_dynamic_radius and f["r_query"] is not None:
                rq_l.append(np.asarray(f["r_query"])[j, i])
            else:
                rq_l.append(np.full(len(i), self.rcfg.radius_query,
                                    np.float32))
        depth_b = np.concatenate(dep_l)
        # inside mask (mapper.py:474-476)
        med = np.median(depth_b)
        inside = depth_b <= min(10 * med, 1.2 * depth_b.max())
        n = len(depth_b)
        pad = R_total - n
        z3 = torch.zeros((pad, 3), device=self.device)
        rays_o = torch.cat(ro_l + [z3])
        rays_d = torch.cat(rd_l + [z3])

        def padded(parts, fill, dtype):
            x = np.concatenate(parts)
            return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                              dtype)])

        return (rays_o, rays_d,
                self._t(padded(dep_l, 0.0, np.float32)),
                self._t(padded(col_l, 0.0, np.float32)),
                self._t(padded(rq_l, 1e-3, np.float32)),
                self._t(padded([inside], False, bool), torch.bool),
                self._t(padded(slot_l, len(frames), np.int32), torch.long))

    def optimize_map(self, num_joint_iters, cur_idx, cur_depth, cur_gt_color,
                     frame_pts_add, cur_c2w, init, color_refine=False):
        """Window optimisation (reference mapper.py:517-684). cur_depth and
        cur_gt_color numpy; cur_c2w a device tensor."""
        cur_r_query = (self.dynamic_r_query / 3.0 * cur_depth
                       if self.use_dynamic_radius else None)
        with span("mapper.window_frames"):
            frames = self._window_frames(color_refine, cur_depth,
                                         cur_gt_color, cur_c2w, cur_r_query)
        if not frames:
            return
        pixs_per_image = self.mapping_pixels // len(frames)
        if self.frustum_feature_selection and not color_refine:
            with sync("pose_to_host"):
                c2w_np = cur_c2w.cpu().numpy()
            feat_mask = self._frustum_grad_mask(c2w_np, cur_depth)
        else:
            feat_mask = self._live_mask()
        fix_color = True if color_refine else self.fix_color_decoder
        dec_mask = {"geo_decoder": 0.0 if self.fix_geo_decoder else 1.0,
                    "color_decoder": 0.0 if fix_color else 1.0}

        if not init and not color_refine:
            num_joint_iters = int(np.clip(
                int(num_joint_iters * frame_pts_add / 300),
                int(self.min_iter_ratio * num_joint_iters),
                2 * num_joint_iters))
        F = len(frames)
        c2ws = self._t(np.stack([f["c2w"] for f in frames]))
        img_colors = self._t(np.stack([f["gt_color"] for f in frames]))
        frame_valid = torch.ones(F, dtype=torch.bool, device=self.device)
        intr = (self.fx, self.fy, self.cx, self.cy)
        R_total = bucket(pixs_per_image * F)
        geo_iter = (self.geo_iter_first if init
                    else int(num_joint_iters * self.geo_iter_ratio))
        stage_name = "init" if init else "stage"

        geo, col = self.npc.geo_feats, self.npc.col_feats
        opt = make_optimizer(self.decoders, geo, col)
        try:
            for it in range(num_joint_iters):
                stage = "geometry" if it <= geo_iter else "color"
                sub = "color" if color_refine else stage
                lr_cfg = self.cfg["mapping"][stage_name][sub]
                lrs = (lr_cfg["decoders_lr"], lr_cfg["geometry_lr"],
                       lr_cfg["color_lr"])
                with span("mapper.ray_batch"):
                    (rays_o, rays_d, depth_b, color_b, rq_b, inside,
                     slot_b) = self._ray_batch(frames, pixs_per_image, c2ws,
                                               R_total)
                with span("mapper.train_step"):
                    metrics = _map_train_step(
                        self.decoders, self.rcfg, opt, geo, col, lrs,
                        self.npc.cloud_pos, self.npc.count, rays_o, rays_d,
                        depth_b, color_b, rq_b, inside, slot_b, frame_valid,
                        c2ws, img_colors, feat_mask, dec_mask, intr,
                        self.w_losses, stage, self.pix_warping, self.W,
                        self.H)
                if it % 20 == 0 or it == num_joint_iters - 1:
                    with sync("map_loss", 2):
                        losses = {"geo": float(metrics["geo_loss"]),
                                  "color": float(metrics["color_loss"])}
                    self.loss_history.append({
                        "idx": int(cur_idx), "iter": it, "stage": sub,
                        "refine": bool(color_refine), **losses})
                if it % 100 == 0 and not self.printer.silence:
                    with sync("map_loss"):
                        geo_loss = float(metrics["geo_loss"])
                    self._print(f"iter {it}: geo_loss {geo_loss:.5f}")
        finally:
            release(self.decoders, geo, col)
        self._print("Mapper has updated point features.")
        if not color_refine and not self.cfg.get("silence", False):
            self._visualize(cur_idx, num_joint_iters - 1, cur_depth,
                            cur_gt_color, init)

    def _visualize(self, cur_idx, iter_i, cur_depth, cur_gt_color, init):
        """The visualizer's panels on its cadence (the first mapped
        keyframe and every ``freq``-th), the keyframe re-rendered (JAX
        mapper.py:600-632)."""
        vis = self.visualizer
        if not (init or (vis.freq > 0 and cur_idx % vis.freq == 0)):
            return
        video_idx, mono = self._cur_video_idx, self._cur_mono
        _, mono_vis, droid_vis = self.get_c2w_and_depth(video_idx, cur_idx,
                                                        mono)
        rendered_depth = rendered_color = None
        out = self.render_keyframe_img(video_idx, cur_idx, mono)
        if out is not None:
            rendered_depth, rendered_color, _ = out
        gt_depth = self.frame_reader[int(cur_idx)][2]
        vis.vis(cur_idx, iter_i, gt_depth, cur_depth, droid_vis, mono_vis,
                cur_gt_color, rendered_depth, rendered_color,
                freq_override=init,
                save_rendered_image=self.save_rendered_image)

    # ------------------------------------------------------------------
    def _deform_cloud(self):
        """Re-anchor the points of frames marked ``npc_dirty`` and refresh
        their full-resolution rows (reference update_points_pos,
        neural_point.py:504-536)."""
        v = self.video
        dirty = v.npc_dirty.copy()
        dirty_idx = np.flatnonzero(dirty)
        if len(dirty_idx) == 0 or self.npc.pts_num() == 0:
            return
        v.npc_dirty[dirty_idx] = False
        n = v.counter                   # every anchor's and dirty frame's
        disps_up = v.disps_up[:n]
        depths = torch.where(v.valid_depth_mask[:n],
                             1.0 / disps_up.clamp(min=1e-8),
                             torch.zeros_like(disps_up))
        c2ws = lie.to_matrix(lie.inv(v.poses[:n])).clone()
        c2ws[:, :3, 1:3] *= -1
        with sync("map_upload"):
            dirty_d = torch.as_tensor(dirty[:n], device=self.device)
        self.npc.deform(depths, c2ws, dirty_d)
        self.npc.add_points(v, dirty_idx)

    def mapping_keyframe(self, idx, video_idx, mono_depth, outer_iters,
                         num_joint_iters, gt_color, init=False,
                         color_refine=False):
        """reference mapper.py:686-740. Returns False when the frame has too
        little valid depth to map."""
        if self.bind_npc_with_pose:
            self._print("Updating pointcloud position ...", "pcl")
            self._deform_cloud()
        cur_c2w, depth_wq, droid_depth = self.get_c2w_and_depth(
            video_idx, idx, mono_depth, print_info=True)
        if cur_c2w is None:
            return False
        # for the visualizer's re-render after the optimisation
        self._cur_video_idx, self._cur_mono = video_idx, mono_depth
        if self.render_depth_type == "proxy":
            with sync("depth_to_host"):
                anchor_depth = droid_depth.cpu().numpy()
            if depth_wq is not None:
                inv = anchor_depth == 0
                with sync("depth_to_host"):
                    anchor_depth[inv] = depth_wq.cpu().numpy()[inv]
        else:
            with sync("depth_to_host"):
                anchor_depth = depth_wq.cpu().numpy()
        if self.use_dynamic_radius:
            self.dynamic_r_add = self.dynamic_r_add / 3.0 * anchor_depth
        frame_pts_add = 0
        if not color_refine:
            frame_pts_add = self.anchor_points(anchor_depth, gt_color,
                                               cur_c2w, video_idx)
        if self.render_depth_type == "proxy":
            render_depth = self.npc.get_proxy_render_depth(
                cur_c2w, droid_depth, depth_wq,
                use_mono_to_complete=self.use_mono_to_complete)
        else:
            render_depth = depth_wq
        if color_refine and idx in self.r_query_store:
            self.dynamic_r_query = self.r_query_store[idx]
        with sync("depth_to_host"):
            render_depth = render_depth.cpu().numpy()
        for _ in range(outer_iters):
            self.optimize_map(num_joint_iters, idx, render_depth, gt_color,
                              frame_pts_add, cur_c2w, init,
                              color_refine=color_refine)
        return True

    # ------------------------------------------------------------------
    @traced("mapper.on_keyframe")
    def on_keyframe(self, frame_info):
        """The tracker's keyframe handshake (reference mapper.py:742-814)."""
        if frame_info.get("end"):
            return
        idx = frame_info["timestamp"]
        video_idx = frame_info["video_idx"]
        self._print(f"Mapping Frame {idx} ...")
        _, gt_color, gt_depth, _ = self.frame_reader[int(idx)]
        mono_depth = self._load_mono(idx)
        if self.use_dynamic_radius:
            r_add, r_query = sampling.dynamic_radius_maps(gt_color, self.cfg)
            self.dynamic_r_add, self.dynamic_r_query = r_add, r_query
            self.r_query_store[int(idx)] = r_query
        if not self.init:
            num_joint_iters = self.cfg["mapping"]["iters"]
            self.mapping_window_size = (
                self.cfg["mapping"]["mapping_window_size"]
                * (2 if self.n_img > 4000 else 1))
        else:
            num_joint_iters = self.iters_first
        valid = self.mapping_keyframe(
            int(idx), int(video_idx), mono_depth, 1, num_joint_iters,
            gt_color, init=self.init, color_refine=False)
        self.init = False
        if not valid:
            return
        self.keyframe_list.append(int(idx))
        self.keyframe_dict.append({
            "idx": int(idx), "video_idx": int(video_idx),
            "color": np.asarray(gt_color),
            "mono_depth": (np.asarray(mono_depth)
                           if mono_depth is not None else None),
            "gt_depth": (np.asarray(gt_depth)
                         if gt_depth is not None else None)})

    # ------------------------------------------------------------------
    def final_refine(self, save_final_pcl=True):
        """Global colour refinement over every keyframe with the geometry
        and colour decoders fixed, then the point cloud files
        (``final_point_cloud.npy`` / ``.ply``, ``npc_cloud.npy``)
        (reference mapper.py:816-855)."""
        if self.video.counter < 2 or self.npc.pts_num() == 0:
            return
        video_idx = self.video.counter - 1
        idx = int(self.video.timestamp[video_idx])
        num_joint_iters = self.cfg["mapping"]["iters"] * 2
        self.mapping_window_size = self.video.counter - 1
        self.geo_iter_ratio = 0.0
        self.fix_color_decoder = True
        self.frustum_feature_selection = False
        self.keyframe_selection_method = "global"
        _, gt_color, _, _ = self.frame_reader[idx]
        self.mapping_keyframe(idx, video_idx, self._load_mono(idx), 5,
                              num_joint_iters, gt_color, init=False,
                              color_refine=True)
        if save_final_pcl:
            n = self.npc.count_in
            cloud_pos = self.npc.input_pos[:n].cpu().numpy()
            cloud_rgb = self.npc.input_rgb[:n].cpu().numpy()
            np.save(f"{self.output}/final_point_cloud",
                    np.hstack([cloud_pos, cloud_rgb]))
            np.save(f"{self.output}/npc_cloud",
                    self.npc.cloud_pos[:self.npc.count].cpu().numpy())
            self._write_ply(f"{self.output}/final_point_cloud.ply",
                            cloud_pos, cloud_rgb / 255.0)
            self._print("Saved point cloud.", "info")

    @staticmethod
    def _write_ply(path, pos, rgb):
        """ASCII PLY with uchar colours (the reference writes it with
        Open3D, mapper.py:845-849)."""
        rgb8 = np.clip(rgb * 255, 0, 255).astype(np.uint8)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(pos)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n")
            for p, c in zip(pos, rgb8):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")

    # ------------------------------------------------------------------
    def render_keyframe_img(self, video_idx, idx, mono_depth=None):
        """Render a keyframe at its proxy depth -> numpy (depth, color,
        proxy depth), or None when it has too little valid depth."""
        c2w, mono_wq, droid_depth = self.get_c2w_and_depth(video_idx, idx,
                                                           mono_depth)
        if c2w is None:
            return None
        render_depth = self.npc.get_proxy_render_depth(
            c2w, droid_depth, mono_wq,
            use_mono_to_complete=self.use_mono_to_complete)
        r_query = self.r_query_store.get(int(idx))
        if r_query is not None:
            r_query = self._t(r_query / 3.0 * render_depth.cpu().numpy())
        depth, _, color, _, _ = render_img(
            self.rcfg, self.decoders, c2w, self.H, self.W, self.fx, self.fy,
            self.cx, self.cy, render_depth, self.npc.cloud_pos,
            self.npc.count, self.npc.geo_feats, self.npc.col_feats, r_query,
            stage="color")
        return depth, color, render_depth.cpu().numpy()

    def eval_kf_imgs(self):
        return eval_render.eval_kf_imgs(self)

    def eval_imgs(self):
        return eval_render.eval_imgs(self)
