"""Deformable neural point cloud in fixed-capacity device tensors.

Counterpart of ``glorie_slam_tpu/mapping/point_cloud.py`` (reference
src/neural_point.py:18-575). Points, their geometry and colour features and
the per-anchor metadata live in tensors of fixed capacity on one device,
with host-side counts; each anchor (a sampled pixel ray) holds ``N_add``
points along its ray. The kNN is ``ops/knn.py``; the re-anchoring after
pose and depth updates (``deform``) is one batched pass over every anchor.

Rays use the NeRF-style camera frame of the reference mapper (x right, y up,
z back): c2w matrices have columns 1:2 negated relative to the tracker's
convention (reference common.py:40-52), and the splat flips x
(neural_point.py:480).

Differences from the JAX package, none of which changes a result:

- new features are ``0.1 * N(0, 1)`` drawn from a CPU ``torch.Generator``
  seeded by ``setup_seed`` (the JAX package draws from ``jax.random``; the
  tests carry its draws across), then moved to the cloud's device, so the
  card and the CPU draw the same values;
- ``add_points`` takes the video it reads from the caller (the mapper's
  current view: the live video, or the asynchronous worker's snapshot);
- the splat projects only the full-resolution rows written so far.
"""

import numpy as np
import torch

from ..geom import projective
from ..ops import knn as knn_mod
from ..utils.phase_timer import sync

TILE = knn_mod.TILE


def _f32(x, device):
    """``x`` as a float32 tensor on ``device``: a number is copied there
    from the host."""
    if torch.is_tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    with sync("number_upload"):
        return torch.as_tensor(x, dtype=torch.float32, device=device)


def linspace(start, stop, num, device=None):
    """``num`` float32 values from start to stop, rounded as
    ``jnp.linspace`` rounds them: start * (1 - s) + stop * s with
    s = iota / (num - 1), and stop itself last. ``start`` and ``stop`` may
    be numbers or 0-d tensors."""
    start, stop = _f32(start, device), _f32(stop, device)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=start.device) / float(div)
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def rays_from_uv(i, j, c2w, fx, fy, cx, cy):
    """Rays through pixels (i = u, j = v) of a NeRF-convention c2w (4, 4)
    -> (rays_o (N, 3), rays_d (N, 3))."""
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


class NeuralPointCloud:
    def __init__(self, cfg, capacity: int = 1 << 20, seed: int = 43,
                 device=None):
        from ..slam import update_cam

        self.cfg = cfg
        self.device = dev = torch.device(device if device is not None
                                         else "cpu")
        self.c_dim = cfg["model"]["c_dim"]
        pc = cfg["pointcloud"]
        self.nn_num = pc["nn_num"]
        self.N_add = pc["N_add"]
        self.radius_add = pc["radius_add"]
        self.radius_min = pc["radius_min"]
        self.radius_query = pc["radius_query"]
        self.near_end_surface = pc["near_end_surface"]
        self.far_end_surface = pc["far_end_surface"]
        self.fix_interval = pc["fix_interval_when_add_along_ray"]

        self.cap = (capacity // TILE) * TILE
        self.cap_in = self.cap // self.N_add
        self.count = 0          # points (= anchors * N_add)
        self.count_in = 0       # anchors
        self.max_video_idx = -1  # largest frame index an anchor holds
        self.n_frames = 0       # full-resolution rows written (max idx + 1)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.cloud_pos = z(self.cap, 3)
        self.geo_feats = z(self.cap, self.c_dim)
        self.col_feats = z(self.cap, self.c_dim)
        self.input_pos = z(self.cap_in, 3)
        self.input_rgb = z(self.cap_in, 3)
        self.input_depth = z(self.cap_in)
        self.input_video_idx = torch.full((self.cap_in,), -1,
                                          dtype=torch.int32, device=dev)
        self.input_i = z(self.cap_in, dtype=torch.int32)     # u (column)
        self.input_j = z(self.cap_in, dtype=torch.int32)     # v (row)

        self.H, self.W, self.fx, self.fy, self.cx, self.cy = update_cam(cfg)
        buf = cfg["tracking"]["buffer"]
        # full-resolution unprojected depth per keyframe, bf16 as in the JAX
        # package (the reference keeps float32)
        self.full_pcl = z(buf, self.H, self.W, 3, dtype=torch.bfloat16)
        self.full_mask = z(buf, self.H, self.W, dtype=torch.bool)
        self.generator = torch.Generator().manual_seed(seed)
        # the JAX package's PRNG key (uint32 (2,)) where a checkpoint gave
        # one; else ``utils/checkpoint.py`` writes ``PRNGKey(seed)``
        self.seed = seed
        self.key = None

    def pts_num(self):
        return self.count

    def load_arrays(self, arrays):
        """Copy another cloud's state: numpy arrays under this class's
        attribute names (the JAX package's cloud, whose full-resolution
        cloud is bf16, or this one's on another device) and its counts
        (``count``, ``count_in``)."""
        for name in ("cloud_pos", "geo_feats", "col_feats", "input_pos",
                     "input_rgb", "input_depth", "input_video_idx",
                     "input_i", "input_j", "full_pcl", "full_mask"):
            cur = getattr(self, name)
            val = np.asarray(arrays[name])
            if cur.dtype == torch.bfloat16:
                val = val.astype(np.float32)
            cur.copy_(torch.tensor(val))
        self.count = int(arrays["count"])
        self.count_in = int(arrays["count_in"])
        self.max_video_idx = int(self.input_video_idx[:self.count_in].max()
                                 ) if self.count_in else -1
        rows = torch.nonzero(self.full_mask.flatten(1).any(1))
        self.n_frames = int(rows.max()) + 1 if rows.numel() else 0

    # ------------------------------------------------------------------
    def find_neighbors(self, pos, step="query", is_pts_grad=False,
                       dynamic_radius=None):
        """(D, I, neighbour counts) of ``pos`` against the cloud; D squared
        (reference find_neighbors_faiss, neural_point.py:264-313)."""
        D, I = knn_mod.knn_search(pos, self.cloud_pos, self.count,
                                  k=self.nn_num)
        if dynamic_radius is not None:
            nn = knn_mod.neighbor_count(D, dynamic_radius)
        else:
            if step == "query":
                r = self.radius_query
            else:
                r = self.radius_min if is_pts_grad else self.radius_add
            nn = knn_mod.neighbor_count(D, r)
        return D, I, nn

    # ------------------------------------------------------------------
    def add_points(self, video, video_idxs):
        """Unproject keyframes ``video_idxs`` of ``video`` into the
        full-resolution cloud with their validity masks (reference
        neural_point.py:145-162); returns how many pixels are valid."""
        idx_np = np.atleast_1d(np.asarray(video_idxs, np.int64))
        with sync("cloud_index"):
            idx = torch.as_tensor(idx_np, device=self.device)
        intr = video.intrinsics * float(video.down_scale)
        pts = projective.iproj_world(video.poses[idx], video.disps_up[idx],
                                     intr)
        mask = video.valid_depth_mask[idx]
        self.full_pcl[idx] = pts.to(torch.bfloat16)
        self.full_mask[idx] = mask
        self.n_frames = max(self.n_frames, int(idx_np.max()) + 1)
        with sync("cloud_count"):
            return int(mask.sum())

    # ------------------------------------------------------------------
    def _draw_features(self, n):
        """(geo, col) initial features (n, c_dim): 0.1 * N(0, 1)."""
        g = torch.randn((n, self.c_dim), generator=self.generator)
        c = torch.randn((n, self.c_dim), generator=self.generator)
        with sync("feature_upload", 2):
            return (0.1 * g).to(self.device), (0.1 * c).to(self.device)

    def add_neural_points(self, rays_o, rays_d, gt_depth, gt_color,
                          video_idx, i, j, is_pts_grad=False,
                          dynamic_radius=None):
        """Anchor new points along the rays whose depth is valid, below
        twice its 80th percentile, and has no cloud point within the add
        radius (reference neural_point.py:165-262). i, j: host arrays.
        Returns how many anchors were added."""
        if rays_o.shape[0] == 0:
            return 0
        mask = gt_depth > 0
        q80 = torch.quantile(gt_depth, 0.8)
        mask = mask & (gt_depth < q80 * 2.0)
        pts_gt = rays_o + rays_d * gt_depth[:, None]
        if self.count > 0:
            _, _, nn = self.find_neighbors(pts_gt, step="add",
                                           is_pts_grad=is_pts_grad,
                                           dynamic_radius=dynamic_radius)
            mask = mask & (nn == 0)
        with sync("anchor_mask"):
            sel = np.flatnonzero(mask.cpu().numpy())
        n_new = min(len(sel), self.cap_in - self.count_in)
        if n_new <= 0:
            return 0
        sel = sel[:n_new]
        with sync("cloud_index"):
            sel_d = torch.as_tensor(sel, device=self.device)

        a = slice(self.count_in, self.count_in + n_new)
        self.input_pos[a] = pts_gt[sel_d]
        self.input_rgb[a] = gt_color[sel_d] * 255.0
        self.input_depth[a] = gt_depth[sel_d]
        self.input_video_idx[a] = int(video_idx)
        self.max_video_idx = max(self.max_video_idx, int(video_idx))
        with sync("cloud_index", 2):
            self.input_i[a] = torch.as_tensor(np.asarray(i, np.int32)[sel],
                                              device=self.device)
            self.input_j[a] = torch.as_tensor(np.asarray(j, np.int32)[sel],
                                              device=self.device)
        self.count_in += n_new

        # N_add points along each selected ray in
        # [near_end_surface * d, far_end_surface * d] (neural_point.py:218-237)
        z_vals = self._z_vals_along_ray(gt_depth[sel_d])     # (n_new, N_add)
        pts = (rays_o[sel_d][:, None, :]
               + rays_d[sel_d][:, None, :] * z_vals[..., None]).reshape(-1, 3)
        p = slice(self.count, self.count + n_new * self.N_add)
        self.cloud_pos[p] = pts
        self.geo_feats[p], self.col_feats[p] = self._draw_features(
            n_new * self.N_add)
        self.count += n_new * self.N_add
        return n_new

    def _z_vals_along_ray(self, depths):
        if self.fix_interval:
            iv = linspace(-0.04, 0.04, self.N_add, self.device)
            return depths[:, None] + iv[None, :]
        t = linspace(0.0, 1.0, self.N_add, self.device)
        return (self.near_end_surface * depths[:, None] * (1 - t)[None, :]
                + self.far_end_surface * depths[:, None] * t[None, :])

    # ------------------------------------------------------------------
    def deform(self, render_depths, c2ws, dirty_mask_frames):
        """Re-anchor every anchor of a dirty frame in one pass.

        render_depths (F, H, W) depth per keyframe (0 where invalid),
        c2ws (F, 4, 4) NeRF-convention camera-to-world, dirty_mask_frames
        (F,) bool, for frames 0..F-1 (F past every anchor's frame). An anchor
        whose new depth is invalid takes its old depth times its frame's
        least-squares scale between old and new depths (reference
        update_points_pos, neural_point.py:377-438, 504-536)."""
        if self.count_in == 0:
            return
        if self.max_video_idx >= render_depths.shape[0]:
            raise ValueError(
                f"an anchor of frame {self.max_video_idx} is past the "
                f"{render_depths.shape[0]} frames given to deform")
        n = self.count_in
        vi = self.input_video_idx[:n].long()
        ii, jj = self.input_i[:n].long(), self.input_j[:n].long()
        old_depth = self.input_depth[:n]
        dirty = dirty_mask_frames[vi]

        new_depth = render_depths[vi, jj, ii]
        invalid_new = new_depth == 0.0
        F = render_depths.shape[0]
        m = dirty & ~invalid_new
        zero = torch.zeros_like(old_depth)
        num = torch.zeros(F, device=self.device).index_add_(
            0, vi, torch.where(m, old_depth * new_depth, zero))
        den = torch.zeros(F, device=self.device).index_add_(
            0, vi, torch.where(m, old_depth ** 2, zero))
        scale = torch.where(den > 1e-12, num / den, torch.ones_like(num))
        new_depth = torch.where(invalid_new, scale[vi] * old_depth, new_depth)

        c2w_pts = c2ws[vi]
        dirs = torch.stack([(ii - self.cx) / self.fx,
                            -(jj - self.cy) / self.fy,
                            -torch.ones_like(old_depth)], -1)
        rays_d = torch.einsum("nij,nj->ni", c2w_pts[:, :3, :3], dirs)
        rays_o = c2w_pts[:, :3, 3]
        pts_in = rays_o + rays_d * new_depth[:, None]
        self.input_pos[:n] = torch.where(dirty[:, None], pts_in,
                                         self.input_pos[:n])
        self.input_depth[:n] = torch.where(dirty, new_depth, old_depth)

        z_vals = self._z_vals_along_ray(new_depth)            # (n, N_add)
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
               ).reshape(-1, 3)
        n3 = n * self.N_add
        upd = dirty.repeat_interleave(self.N_add)
        self.cloud_pos[:n3] = torch.where(upd[:, None], pts,
                                          self.cloud_pos[:n3])

    # ------------------------------------------------------------------
    def proj_depth_map(self, c2w, exclude_recent_from=None, neural_pcl=False):
        """Z-buffer splat of the cloud into a NeRF-convention camera
        -> depth (H, W), 0 where nothing lands (reference
        neural_point.py:446-501, with its x flip and truncating cast)."""
        H, W = self.H, self.W
        if neural_pcl:
            points = self.cloud_pos[:self.count]
            valid = torch.ones(points.shape[0], dtype=torch.bool,
                               device=self.device)
        else:
            n = self.n_frames
            if exclude_recent_from is not None:
                n = min(n, max(int(exclude_recent_from), 0))
            points = self.full_pcl[:n].reshape(-1, 3).float()
            valid = self.full_mask[:n].reshape(-1)
        with sync("pose_inverse"):
            w2c = torch.linalg.inv(c2w)
        cam = points @ w2c[:3, :3].T + w2c[:3, 3]
        cx_ = -cam[:, 0]                                # x flip
        z = cam[:, 2] + 1e-6
        u = self.fx * cx_ / z + self.cx
        vv = self.fy * cam[:, 1] / z + self.cy
        depth = -z
        ok = (valid & (u >= 0) & (u < W) & (vv >= 0) & (vv < H)
              & (depth > 0))
        ui = u.to(torch.int32).clamp(0, W - 1)
        vi = vv.to(torch.int32).clamp(0, H - 1)
        flat = torch.where(ok, vi * W + ui, torch.full_like(ui, H * W)).long()
        inf = torch.full_like(depth, float("inf"))
        zbuf = torch.full((H * W + 1,), float("inf"), device=self.device)
        zbuf.scatter_reduce_(0, flat, torch.where(ok, depth, inf),
                             reduce="amin", include_self=True)
        dm = zbuf[:H * W].reshape(H, W)
        return torch.where(torch.isfinite(dm), dm, torch.zeros_like(dm))

    def get_proxy_render_depth(self, c2w, droid_depth, mono_depth,
                               exclude_recent_from=None,
                               use_mono_to_complete=True):
        """droid depth, then the splatted cloud where droid has none, then
        the scaled mono prior where both have none (reference
        neural_point.py:538-575)."""
        proj = self.proj_depth_map(c2w, exclude_recent_from)
        proxy = torch.where(~(droid_depth > 0.0) & (proj > 0.0), proj,
                            droid_depth)
        if use_mono_to_complete and mono_depth is not None:
            proxy = torch.where(proxy == 0.0, mono_depth, proxy)
        return proxy
