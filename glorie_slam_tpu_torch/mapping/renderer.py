"""Depth-guided volume rendering of the neural point cloud.

Counterpart of ``glorie_slam_tpu/mapping/renderer.py`` (reference
src/utils/Renderer.py:6-306 and raw2outputs_nerf_color, common.py:261-299):
``N_surface`` samples in [0.95, 1.05] x depth per ray; rays without depth
sample where the cloud is (25 probes between ``near_end`` and ``far``,
between the first and the last probe that has a point within the query
radius) or uniformly; one kNN of all samples serves both decoders;
occupancy -> alpha = sigmoid(coef * occ); normalised alpha compositing of
depth, colour and depth variance. Samples without enough neighbours get
occupancy -100 (Renderer.py:206-207).

``far`` = min(5 mean(depth), max(1.2 depth)) is taken over the whole ray
batch, padding rays included: callers pad their batches as the JAX package
does (``mapper.py`` to ``bucket(pixels per frame * frames)``, ``render_img``
to ``ray_batch_size``), or ``far`` and every sample past it differ.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops import knn as knn_mod
from .point_cloud import linspace

PROBES = 25


class RenderConfig(NamedTuple):
    N_surface: int = 10
    near_end: float = 0.3
    near_end_surface: float = 0.95
    far_end_surface: float = 1.05
    sigmoid_coef: float = 0.1
    sample_near_pcl: bool = True
    radius_query: float = 0.08
    use_dynamic_radius: bool = True
    nn_num: int = 8

    @classmethod
    def from_cfg(cls, cfg):
        r, pc = cfg["rendering"], cfg["pointcloud"]
        return cls(N_surface=r["N_surface"], near_end=r["near_end"],
                   near_end_surface=r["near_end_surface"],
                   far_end_surface=r["far_end_surface"],
                   sigmoid_coef=r["sigmoid_coef"],
                   sample_near_pcl=r["sample_near_pcl"],
                   radius_query=pc["radius_query"],
                   use_dynamic_radius=pc["use_dynamic_radius"],
                   nn_num=pc["nn_num"])


def raw2outputs(raw, z_vals, coef=0.1):
    """Alpha compositing of raw (R, S, 4) [rgb, occupancy] at depths
    z_vals (R, S) -> (depth (R,), depth_var (R,), rgb (R, 3),
    weights (R, S))."""
    rgb = raw[..., :-1]
    alpha = torch.sigmoid(coef * raw[..., -1])
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], -1),
                          dim=-1)[..., :-1]
    weights = alpha * trans
    wsum = torch.sum(weights, -1, keepdim=True) + 1e-10
    rgb_map = torch.sum(weights[..., None] * rgb, -2) / wsum
    depth_map = torch.sum(weights * z_vals, -1) / wsum[..., 0]
    depth_var = torch.sum(weights * (z_vals - depth_map[..., None]) ** 2, -1)
    return depth_map, depth_var, rgb_map, weights


def sample_near_cloud(rcfg, cloud_pos, count, rays_o, rays_d, near, far,
                      num, radius_query):
    """Depths for rays without one, near the cloud (reference
    neural_point.py:315-375) -> (z (R, num), invalid (R,))."""
    R = rays_o.shape[0]
    dev = rays_o.device
    z_sect = linspace(near, far, PROBES, dev)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_sect[None, :, None]
    D, _ = knn_mod.knn_search(pts.reshape(-1, 3), cloud_pos, count,
                              k=rcfg.nn_num)
    has = (knn_mod.neighbor_count(D, radius_query) > 0).reshape(R, PROBES)
    invalid = torch.sum(has, dim=1) < 2
    hi = has.to(torch.int32)
    first = torch.argmax(hi, dim=1)
    last = PROBES - 1 - torch.argmax(torch.flip(hi, [1]), dim=1)
    t = linspace(0.0, 1.0, num, dev)
    z_near = (z_sect[first][:, None] * (1 - t)[None, :]
              + z_sect[last][:, None] * t[None, :])
    z_uniform = linspace(rcfg.near_end, far, num, dev).expand(R, num)
    return torch.where(invalid[:, None], z_uniform, z_near), invalid


def render_rays(rcfg, decoders, rays_o, rays_d, gt_depth, cloud_pos, count,
                geo_feats, col_feats, dynamic_r_query=None, stage="color"):
    """Render a ray batch (reference Renderer.py:80-219). ``count`` is the
    host point count; the kNN runs without autograd (no trained tensor
    reaches it). Returns (depth (R,), var (R,), color (R, 3),
    valid_ray (R,), counts (R,))."""
    R = rays_o.shape[0]
    S = rcfg.N_surface
    dev = rays_o.device
    far = torch.minimum(5 * torch.mean(gt_depth), torch.max(gt_depth * 1.2))
    nz = gt_depth > 0
    t = linspace(0.0, 1.0, S, dev)
    z_surface = (rcfg.near_end_surface * gt_depth[:, None] * (1 - t)
                 + rcfg.far_end_surface * gt_depth[:, None] * t)
    mask_near = torch.ones(R, dtype=torch.bool, device=dev)
    with torch.no_grad():
        if rcfg.sample_near_pcl:
            z_zero, invalid = sample_near_cloud(
                rcfg, cloud_pos, count, rays_o, rays_d, rcfg.near_end, far,
                S, rcfg.radius_query)
            mask_near = torch.where(~nz, ~invalid, mask_near)
            z_vals = torch.where(nz[:, None], z_surface, z_zero)
        else:
            z_uniform = linspace(rcfg.near_end, far, S, dev).expand(R, S)
            z_vals = torch.where(nz[:, None], z_surface, z_uniform)
        pts_flat = (rays_o[:, None, :] + rays_d[:, None, :]
                    * z_vals[..., None]).reshape(-1, 3)
        if rcfg.use_dynamic_radius and dynamic_r_query is not None:
            r_q = dynamic_r_query.reshape(-1).repeat_interleave(S)[:, None] ** 2
        else:
            r_q = torch.tensor(rcfg.radius_query, dtype=torch.float32,
                               device=dev) ** 2
        D, I = knn_mod.knn_search(pts_flat, cloud_pos, count, k=rcfg.nn_num)
        nn = torch.sum(D < r_q, dim=-1).to(torch.int32)
    views_d = rays_d.repeat_interleave(S, dim=0)
    raw, point_mask = decoders(pts_flat, D, I, nn, geo_feats, col_feats,
                               cloud_pos, r_q, views_d, stage)
    occ = torch.where(point_mask, raw[..., -1],
                      torch.full_like(raw[..., -1], -100.0))
    raw = torch.cat([raw[..., :3], occ[..., None]], -1).reshape(R, S, 4)
    depth, var, color, _ = raw2outputs(raw, z_vals, rcfg.sigmoid_coef)
    counts = torch.sum(point_mask.reshape(R, S), dim=1)
    valid_ray = (counts >= 3) & mask_near                # decoder.py:202-203
    if not rcfg.sample_near_pcl:
        depth = torch.where(nz, depth, torch.zeros_like(depth))
    return depth, var, color, valid_ray, counts


def get_rays(H, W, fx, fy, cx, cy, c2w):
    """Rays through every pixel of a NeRF-convention c2w -> (rays_o,
    rays_d), each (H, W, 3)."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       -1)
    rays_d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


@torch.no_grad()
def render_img(rcfg, decoders, c2w, H, W, fx, fy, cx, cy, gt_depth,
               cloud_pos, count, geo_feats, col_feats, dynamic_r_query=None,
               stage="color", ray_batch_size=3000):
    """Whole-image rendering in zero-padded batches of ``ray_batch_size``
    rays (reference Renderer.py:221-306) -> numpy (depth (H, W),
    var (H, W), color (H, W, 3), mask (H, W), count (H, W))."""
    rays_o, rays_d = get_rays(H, W, fx, fy, cx, cy, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    gt_depth = gt_depth.reshape(-1)
    if dynamic_r_query is not None:
        dynamic_r_query = dynamic_r_query.reshape(-1)
    outs = [[] for _ in range(5)]
    B = ray_batch_size
    n = rays_o.shape[0]
    for s in range(0, n, B):
        take = min(B, n - s)

        def padz(x):
            x = x[s:s + take]
            return torch.cat([x, x.new_zeros((B - take,) + x.shape[1:])])

        res = render_rays(
            rcfg, decoders, padz(rays_o), padz(rays_d), padz(gt_depth),
            cloud_pos, count, geo_feats, col_feats,
            padz(dynamic_r_query) if dynamic_r_query is not None else None,
            stage)
        for lst, r in zip(outs, res):
            lst.append(r[:take].cpu().numpy())
    depth, var, color, mask, cnt = (np.concatenate(lst) for lst in outs)
    return (depth.reshape(H, W), var.reshape(H, W), color.reshape(H, W, 3),
            mask.reshape(H, W), cnt.reshape(H, W))
