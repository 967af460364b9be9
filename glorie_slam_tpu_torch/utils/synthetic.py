"""Synthetic textured-plane stream and the tracking configs that drive it.

The port's own copy of ``tests/synthetic.py`` (``make_texture``,
``render_frame``, ``SyntheticStream``) with its pose maths in this
package's torch ``lie`` (float32 on the CPU), and ``base_cfg`` as a plain
dict. ``bench_cfg`` is the configuration of ``bench.py``: window 25,
ba_freq 12, loop closure and online BA on, every frame admitted.
``mapping_cfg`` is the mapper's configuration at the Replica widths
(``configs/mono_point_slam.yaml`` under ``configs/Replica/replica.yaml``;
the card's machine has no PyYAML).
"""

import numpy as np
import torch

from ..geom import lie

PLANE_Z = 3.0


def make_texture(size=256, seed=0):
    """Smooth random RGB texture with rich gradients."""
    rng = np.random.default_rng(seed)
    tex = rng.random((size, size, 3)).astype(np.float32)
    for _ in range(2):
        tex = (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
               + np.roll(tex, 1, 1) + np.roll(tex, -1, 1) + tex) / 5.0
    lo, hi = tex.min(), tex.max()
    return (tex - lo) / (hi - lo)


def render_frame(T_c2w, intrinsics, H, W, texture, tex_scale=50.0):
    """Render the textured plane z = PLANE_Z from camera-to-world matrix
    ``T_c2w`` (4, 4) -> (rgb (H, W, 3), depth (H, W)), float32."""
    fx, fy, cx, cy = intrinsics
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    Rwc, origin = T_c2w[:3, :3], T_c2w[:3, 3]
    dirs_w = dirs_cam @ Rwc.T
    t = (PLANE_Z - origin[2]) / dirs_w[..., 2]
    pts = origin + t[..., None] * dirs_w
    depth = ((pts - origin) @ Rwc)[..., 2]

    size = texture.shape[0]
    tu = (pts[..., 0] * tex_scale) % size
    tv = (pts[..., 1] * tex_scale) % size
    i0, j0 = np.floor(tv).astype(int) % size, np.floor(tu).astype(int) % size
    i1, j1 = (i0 + 1) % size, (j0 + 1) % size
    fv, fu = tv - np.floor(tv), tu - np.floor(tu)
    rgb = (texture[i0, j0] * ((1 - fv) * (1 - fu))[..., None]
           + texture[i0, j1] * ((1 - fv) * fu)[..., None]
           + texture[i1, j0] * (fv * (1 - fu))[..., None]
           + texture[i1, j1] * (fv * fu)[..., None])
    return rgb.astype(np.float32), depth.astype(np.float32)


class SyntheticStream:
    """Indexable RGB stream with ground-truth poses and depths:
    ``stream[i] = (i, rgb (H, W, 3) in [0, 1], depth (H, W), c2w (4, 4))``.

    trajectory="circuit" sweeps along +x and back, so late frames revisit
    early ones (loop closure fires); "walk" drifts sideways and forward.
    """

    def __init__(self, n_frames=30, H=64, W=96, seed=0, motion_scale=0.02,
                 trajectory="walk"):
        rng = np.random.default_rng(seed)
        self.H, self.W = H, W
        self.intrinsics = np.array([W * 0.8, W * 0.8, W / 2 - 0.5,
                                    H / 2 - 0.5], np.float32)
        self.texture = make_texture(seed=seed)
        if trajectory == "circuit":
            t = np.linspace(0, 2 * np.pi, n_frames)
            xi = np.zeros((n_frames, 6))
            xi[:, 0] = 2.0 * np.sin(t / 2) ** 2
            xi[:, 1] = 0.15 * np.sin(t)
            xi[:, 2] = 0.1 * np.sin(t)
            xi[:, 3:] = rng.normal(size=(n_frames, 3)) * motion_scale * 0.2
        else:
            twists = rng.normal(size=(n_frames, 6))
            twists[:, :2] = np.abs(twists[:, :2]) * motion_scale * 4
            twists[:, 2] *= motion_scale
            twists[:, 3:] *= motion_scale * 0.3
            xi = np.cumsum(twists, 0)
        poses = lie.exp(torch.as_tensor(xi, dtype=torch.float32))
        self.poses_w2c = poses.numpy()
        c2w_all = lie.to_matrix(lie.inv(poses)).numpy()
        self.poses = list(c2w_all)
        self.frames, self.depths = [], []
        for T in c2w_all:
            rgb, depth = render_frame(T, self.intrinsics, H, W, self.texture)
            self.frames.append(rgb)
            self.depths.append(depth)
        self.n_img = n_frames

    def __len__(self):
        return self.n_img

    def get_intrinsic(self):
        return self.intrinsics

    def __getitem__(self, index):
        return index, self.frames[index], self.depths[index], \
            self.poses[index]


def base_cfg(H=64, W=96, buffer=64, out="output"):
    """Tracking config for synthetic runs (DBA mode, no mono prior): the
    run, tracking, camera and data sections of ``tests/synthetic.base_cfg``
    (``SLAM`` writes under ``{out}/test/synth``)."""
    return {
        "dataset": "synthetic", "scene": "synth", "setting": "test",
        "silence": True, "only_tracking": True, "mono_prior": {},
        "tracking": {
            "pretrained": None, "buffer": buffer, "beta": 0.6, "warmup": 5, "max_age": 25,
            "mono_thres": False,
            "motion_filter": {"thresh": 0.0},
            "multiview_filter": {"thresh": 0.05, "visible_num": 2},
            "frontend": {
                "enable_loop": False, "enable_online_ba": False,
                "keyframe_thresh": 0.0, "thresh": 25.0, "window": 12,
                "radius": 2, "nms": 1, "max_factors": 48,
            },
            "backend": {
                "final_ba": False, "ba_freq": 20, "thresh": 25.0,
                "radius": 1, "nms": 2, "loop_window": 12,
                "loop_thresh": 25.0, "loop_radius": 1, "loop_nms": 2,
                "BA_type": "DBA", "normalize": False,
            },
        },
        "cam": {
            "H": H, "W": W, "H_out": H, "W_out": W, "H_edge": 0, "W_edge": 0,
            "fx": W * 0.8, "fy": W * 0.8, "cx": W / 2 - 0.5, "cy": H / 2 - 0.5,
        },
        "data": {"input_folder": "", "output": out},
    }


def bench_cfg(H=320, W=640, buffer=400, out="output"):
    """``bench.py``'s tracking config on ``base_cfg``."""
    cfg = base_cfg(H=H, W=W, buffer=buffer, out=out)
    tc = cfg["tracking"]
    tc["warmup"] = 8
    tc["max_age"] = 50
    tc["motion_filter"]["thresh"] = 0.0
    tc["multiview_filter"] = {"thresh": 0.01, "visible_num": 2}
    tc["frontend"].update(dict(
        enable_loop=True, enable_online_ba=True, keyframe_thresh=0.0,
        thresh=25.0, window=25, radius=2, nms=1, max_factors=100))
    tc["backend"].update(dict(
        ba_freq=12, loop_window=25, loop_nms=12, BA_type="DSPO",
        normalize=True))
    return cfg


def _stage_lrs():
    """Learning rates of one stage table: geometry, then colour."""
    def lrs(dec, geo, col):
        return {"decoders_lr": dec, "geometry_lr": geo, "color_lr": col}
    return {"geometry": lrs(0.001, 0.03, 0.0),
            "color": lrs(0.005, 0.005, 0.005)}


def mapping_cfg():
    """The ``mapping``, ``pointcloud``, ``model`` and ``rendering`` sections
    and ``setup_seed`` of ``configs/mono_point_slam.yaml`` with
    ``configs/Replica/replica.yaml``'s overrides (window 12, 5000 pixels,
    1000 colour-gradient pixels, 400 iterations), as a dict to merge into a
    run's config."""
    return {
        "setup_seed": 43,
        "mapping": {
            "pretrained": "./pretrained/middle_fine.pt",
            "async_mapping": True, "geo_iter_ratio": 0.3,
            "geo_iter_first": 400, "every_keyframe": 1, "every_frame": 5,
            "frustum_edge": -4, "fix_geo_decoder": True,
            "fix_color_decoder": False, "mapping_window_size": 12,
            "frustum_feature_selection": True,
            "keyframe_selection_method": "overlap",
            "keyframe_setting_method": "period", "pixels": 5000,
            "pixels_adding": 6000, "pixels_based_on_color_grad": 1000,
            "iters_first": 1500, "iters": 400, "save_rendered_image": True,
            "min_iter_ratio": 0.95, "pix_warping": True,
            "w_pix_warp_loss": 1000.0, "w_geo_loss": 1.0,
            "w_color_loss": 0.1, "render_depth": "proxy",
            "use_mono_to_complete": True, "save_depth": False,
            "color_refine": True, "init": _stage_lrs(),
            "stage": _stage_lrs(),
        },
        "pointcloud": {
            "capacity": 1 << 20, "nn_num": 8, "min_nn_num": 2, "N_add": 3,
            "nn_weighting": "distance", "radius_add": 0.04,
            "radius_min": 0.02, "radius_query": 0.08,
            "radius_add_max": 0.08, "radius_add_min": 0.02,
            "radius_query_ratio": 2, "color_grad_threshold": 0.15,
            "near_end_surface": 0.95, "far_end_surface": 1.05,
            "nlist": 400, "nprobe": 4,
            "fix_interval_when_add_along_ray": False,
            "use_dynamic_radius": True, "bind_npc_with_pose": True,
        },
        "model": {
            "c_dim": 32, "exposure_dim": 8,
            "pos_embedding_method": "fourier",
            "encode_rel_pos_in_col": True, "use_view_direction": True,
            "encode_viewd": True,
        },
        "rendering": {
            "N_surface": 10, "near_end": 0.3, "near_end_surface": 0.95,
            "far_end_surface": 1.05, "sigmoid_coef": 0.1,
            "sample_near_pcl": True,
        },
    }
