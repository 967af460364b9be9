"""3D reconstruction evaluation: accuracy, completion, F-score, depth L1.

Counterpart of ``glorie_slam_tpu/utils/eval_recon.py`` (reference
src/utils/eval_recon.py:1-283, which uses trimesh, Open3D and the external
``evaluate_3d_reconstruction``): point-to-point ICP (scipy ``cKDTree`` and
Umeyama), area-weighted surface sampling and kd-tree distances (accuracy,
completion, completion ratio, precision, recall, F-score at 5 cm), and the
depth L1 over 1000 random virtual views. Host numpy, copied from the JAX
module, except the views' rasterizer: the JAX module's z-buffer loops over
triangles in Python, which takes hours for 1000 views of a mesh with 1e5
triangles, so ``render_mesh_depth`` here tests every (triangle, pixel of
its bounding box) pair as tensor ops on the device, with the same float64
barycentric test, perspective-correct depth and nearest-depth rule. An
evaluation that fails raises.
"""

import random

import numpy as np
import torch
from scipy.spatial import cKDTree as KDTree

from ..device import resolve_device
from ..geom import alignment
from ..mapping import mesher

PAIRS_PER_CHUNK = 1 << 24


def icp_align(src_pts, dst_pts, iters=20, threshold=0.1):
    """Point-to-point ICP returning a 4x4 transform aligning src -> dst
    (replaces o3d registration_icp, reference eval_recon.py:46-61)."""
    T = np.eye(4)
    src = src_pts.copy()
    tree = KDTree(dst_pts)
    for _ in range(iters):
        d, idx = tree.query(src)
        m = d < threshold
        if m.sum() < 10:
            break
        R, t, _ = alignment.umeyama_alignment(
            src[m].T, dst_pts[idx[m]].T, with_scale=False
        )
        src = src @ R.T + t
        Ti = np.eye(4)
        Ti[:3, :3] = R
        Ti[:3, 3] = t
        T = Ti @ T
    return T


def calc_3d_metric(rec_meshfile, gt_meshfile, align=True, n_samples=200000,
                   dist_th=0.05):
    """accuracy/completion/completion-ratio + precision/recall/F-score
    (reference eval_recon.py:25-118 + the external F-score evaluation)."""
    rv, rf = mesher.read_ply_mesh(rec_meshfile)
    gv, gf = mesher.read_ply_mesh(gt_meshfile)

    if align:
        T = icp_align(rv, gv)
        rv = rv @ T[:3, :3].T + T[:3, 3]

    rec_pc = mesher.sample_points_from_mesh(rv, rf, n_samples)
    gt_pc = mesher.sample_points_from_mesh(gv, gf, n_samples)

    gt_tree = KDTree(gt_pc)
    rec_tree = KDTree(rec_pc)
    d_rec_to_gt, _ = gt_tree.query(rec_pc)   # accuracy / precision
    d_gt_to_rec, _ = rec_tree.query(gt_pc)   # completion / recall

    precision = float((d_rec_to_gt < dist_th).mean())
    recall = float((d_gt_to_rec < dist_th).mean())
    fscore = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
    return {
        "accuracy": float(d_rec_to_gt.mean()) * 100,       # cm
        "completion": float(d_gt_to_rec.mean()) * 100,     # cm
        "completion_ratio": recall * 100,                  # %
        "precision": precision * 100,
        "recall": recall * 100,
        "normal consistency": float("nan"),                # not computed
        "f-score": fscore * 100,
    }


def render_mesh_depth(verts, faces, c2w, W=500, H=500, fx=300.0, fy=300.0,
                      cx=None, cy=None, z_far=20.0, device=None):
    """Z-buffer depth image (H, W) float32 of a mesh from a CV-convention
    camera (replaces the Open3D offscreen capture, eval_recon.py:193-216):
    triangles with every vertex in (0.05, z_far) and some part on screen,
    the pixels of their bounding box inside by the barycentric test, the
    nearest perspective-correct depth per pixel, 0 where none lands."""
    dev = resolve_device(device)
    cx = W / 2.0 - 0.5 if cx is None else cx
    cy = H / 2.0 - 0.5 if cy is None else cy
    f64 = dict(dtype=torch.float64, device=dev)
    w2c = torch.as_tensor(np.linalg.inv(c2w), **f64)
    cam = torch.as_tensor(verts, **f64) @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    zc = z.clamp(min=1e-9)
    u = fx * cam[:, 0] / zc + cx
    v = fy * cam[:, 1] / zc + cy

    tri = torch.as_tensor(faces, dtype=torch.long, device=dev)
    z_t = z[tri]
    tri = tri[((z_t > 0.05) & (z_t < z_far)).all(1)]
    u_t, v_t, z_t = u[tri], v[tri], z[tri]
    on = ~((u_t.max(1).values < 0) | (u_t.min(1).values >= W)
           | (v_t.max(1).values < 0) | (v_t.min(1).values >= H))
    u_t, v_t, z_t = u_t[on], v_t[on], z_t[on]
    # the bounding box, clipped to the image
    x0 = torch.floor(u_t.min(1).values).clamp(min=0)
    x1 = torch.clamp(torch.ceil(u_t.max(1).values) + 1, max=W)
    y0 = torch.floor(v_t.min(1).values).clamp(min=0)
    y1 = torch.clamp(torch.ceil(v_t.max(1).values) + 1, max=H)
    d = ((v_t[:, 1] - v_t[:, 2]) * (u_t[:, 0] - u_t[:, 2])
         + (u_t[:, 2] - u_t[:, 1]) * (v_t[:, 0] - v_t[:, 2]))
    keep = (x1 > x0) & (y1 > y0) & (d.abs() >= 1e-12)
    u_t, v_t, z_t, d = u_t[keep], v_t[keep], z_t[keep], d[keep]
    x0, y0 = x0[keep].long(), y0[keep].long()
    bw = x1[keep].long() - x0
    area = bw * (y1[keep].long() - y0)

    zbuf = torch.full((H * W,), torch.inf, **f64)
    ends = torch.cumsum(area, 0)
    starts = ends - area
    n, start = len(area), 0
    while start < n:
        # triangles [start, stop): at most PAIRS_PER_CHUNK pairs, or one
        stop = max(start + 1, int(torch.searchsorted(
            ends, starts[start] + PAIRS_PER_CHUNK, right=True)))
        sl = slice(start, stop)
        k = torch.repeat_interleave(
            torch.arange(stop - start, device=dev), area[sl])
        local = (torch.arange(len(k), device=dev)
                 - (starts[sl] - starts[start])[k])
        xs = (x0[sl][k] + local % bw[sl][k]).double()
        ys = (y0[sl][k] + local // bw[sl][k]).double()
        ut, vt, zt, dk = u_t[sl][k], v_t[sl][k], z_t[sl][k], d[sl][k]
        a = ((vt[:, 1] - vt[:, 2]) * (xs - ut[:, 2])
             + (ut[:, 2] - ut[:, 1]) * (ys - vt[:, 2])) / dk
        b = ((vt[:, 2] - vt[:, 0]) * (xs - ut[:, 2])
             + (ut[:, 0] - ut[:, 2]) * (ys - vt[:, 2])) / dk
        c = 1 - a - b
        inside = (a >= 0) & (b >= 0) & (c >= 0)
        zi = 1.0 / (a / zt[:, 0] + b / zt[:, 1] + c / zt[:, 2] + 1e-12)
        pix = (ys * W + xs).long()
        zbuf.scatter_reduce_(0, pix[inside], zi[inside], "amin")
        start = stop
    depth = torch.where(torch.isinf(zbuf), 0.0, zbuf).float()
    return depth.reshape(H, W).cpu().numpy()


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3, :4] = np.stack([vec0, vec1, vec2, pos], 1)
    return m


def calc_2d_metric(rec_meshfile, gt_meshfile, printer=None, align=True,
                   n_imgs=1000, seed=0, device=None):
    """Depth-L1 from random virtual views avoiding unseen regions
    (reference eval_recon.py:140-226): ``{gt_mesh}_pc_unseen.npy`` next to
    the ground-truth mesh, where present, lists points no view may see;
    such views are drawn again. Views come from ``random.Random(seed)``
    and the global numpy generator, in the JAX package's order; both
    meshes are rasterized on ``device``."""
    rng = random.Random(seed)
    H = W = 500
    fx = fy = 300.0
    cx = cy = H / 2.0 - 0.5

    rv, rf = mesher.read_ply_mesh(rec_meshfile)
    gv, gf = mesher.read_ply_mesh(gt_meshfile)
    unseen_file = gt_meshfile.replace(".ply", "_pc_unseen.npy")
    try:
        pc_unseen = np.load(unseen_file)
    except FileNotFoundError:
        pc_unseen = np.zeros((0, 3))
    if align:
        T = icp_align(rv, gv)
        rv = rv @ T[:3, :3].T + T[:3, 3]

    # sampling box inside the room (eval_recon.py:120-128)
    center = 0.5 * (gv.min(0) + gv.max(0))
    extents = (gv.max(0) - gv.min(0)) * np.array([0.3, 0.7, 0.7])
    center = center + np.array([0, 0, 0.4])

    def check_unseen_proj(c2w):
        if len(pc_unseen) == 0:
            return False
        cc = c2w.copy()
        cc[:3, 1] *= -1
        cc[:3, 2] *= -1
        w2c = np.linalg.inv(cc)
        cam = pc_unseen @ w2c[:3, :3].T + w2c[:3, 3]
        cam[:, 0] *= -1
        z = cam[:, 2] + 1e-5
        u = fx * cam[:, 0] / z + cx
        v = fy * cam[:, 1] / z + cy
        edge = 10
        m = ((0 <= -z) & (u < W - edge) & (u > edge)
             & (v < H - edge) & (v > edge))
        return m.sum() > 0

    dev = resolve_device(device)
    meshes = [(torch.as_tensor(vs, dtype=torch.float64, device=dev),
               torch.as_tensor(fs, dtype=torch.long, device=dev))
              for vs, fs in ((gv, gf), (rv, rf))]
    errors = []
    for _ in range(n_imgs):
        for _attempt in range(50):
            up = np.array([0, 0, -1.0])
            origin = center + (np.random.rand(3) - 0.5) * extents
            target = np.array([rng.uniform(-1, 1) for _ in range(3)])
            c2w = _viewmatrix(target, up, origin)
            if not check_unseen_proj(c2w):
                break
        # the o3d renderer uses a standard CV pinhole: flip to CV convention
        cc = c2w.copy()
        cc[:3, 1] *= -1
        cc[:3, 2] *= -1
        gt_depth, ours = (render_mesh_depth(vs, fs, cc, W, H, fx, fy, cx,
                                            cy, device=dev)
                          for vs, fs in meshes)
        m = ours > 0
        if m.sum() > 0:
            errors.append(float(np.abs(gt_depth[m] - ours[m]).mean()))
    if not errors:
        return {"depth l1": float("nan")}
    return {"depth l1": float(np.mean(errors)) * 100}


def eval_recon(rec_mesh, gt_mesh, eval_2d, eval_3d, align, printer=None,
               n_imgs_2d=1000, device=None):
    result = {}
    if eval_3d:
        r3 = calc_3d_metric(rec_mesh, gt_mesh, align=align)
        result.update(r3)
        if printer:
            printer.print(str(r3), subsystem="eval")
    if eval_2d:
        r2 = calc_2d_metric(rec_mesh, gt_mesh, printer, align=align,
                            n_imgs=n_imgs_2d, device=device)
        result.update(r2)
        if printer:
            printer.print(str(r2), subsystem="eval")
    return result


def eval_recon_with_cfg(cfg, eval_3d=True, eval_2d=True, kf_mesh=True,
                        every_mesh=False, printer=None, n_imgs_2d=1000,
                        device=None):
    """reference eval_recon.py:250-268 (takes the merged cfg dict)."""
    output = f"{cfg['data']['output']}/{cfg['setting']}/{cfg['scene']}"
    gt_mesh = cfg["meshing"]["gt_mesh_path"]
    result = {}
    if kf_mesh:
        rec = f"{output}/mesh/rendered_mesh_kf.ply"
        for k, v in eval_recon(rec, gt_mesh, eval_2d, eval_3d, True,
                               printer, n_imgs_2d, device).items():
            result[f"{k}_kf"] = v
    if every_mesh:
        rec = f"{output}/mesh/rendered_mesh_every.ply"
        for k, v in eval_recon(rec, gt_mesh, eval_2d, eval_3d, True,
                               printer, n_imgs_2d, device).items():
            result[f"{k}_every"] = v
    return result
