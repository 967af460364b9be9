"""Mesh of the re-rendered keyframes by TSDF fusion.

Counterpart of ``glorie_slam_tpu/utils/generate_mesh.py`` (reference
src/utils/generate_mesh.py:55-133, ``generate_mesh_kf``): the keyframe
depth dumps of ``eval_render.eval_kf_imgs``, scaled by the Sim(3) scale of
the keyframe trajectory's alignment to the ground truth, are integrated at
the aligned poses into a TSDF volume bounded by their back-projections
(plus 0.1), whose voxel grows by 1.26x until the volume holds at most 3e8
voxels; the mesh goes to ``mesh/rendered_mesh_{suffix}.ply``. Integration
runs on ``device``; extraction on the host (``mapping/mesher.py``).
"""

import os

import numpy as np

from ..mapping import mesher
from . import eval_traj


def generate_mesh_kf(cfg, rendered_path="rendered_every_keyframe",
                     mesh_name_suffix="kf", stream=None, printer=None,
                     voxel_size=0.01, device=None):
    """Fuse the rendered keyframe depths into a mesh. Returns (verts, faces)
    or None when there is nothing to fuse."""
    from ..slam import update_cam

    output = f"{cfg['data']['output']}/{cfg['setting']}/{cfg['scene']}"
    render_dir = f"{output}/{rendered_path}"
    if not os.path.isdir(render_dir):
        if printer:
            printer.print("No rendered keyframes; skip meshing.",
                          subsystem="error")
        return None

    # depths scaled by the Sim(3) scale so the mesh lives in the ground
    # truth's metric space (reference generate_mesh.py:66-75)
    scale, _, _, est_c2w, _, timestamps = eval_traj.align_kf_traj(
        f"{output}/video.npz", stream)
    H, W, fx, fy, cx, cy = update_cam(cfg)
    intr = (fx, fy, cx, cy)

    frames = []
    for i, ts in enumerate(timestamps):
        idx = int(round(float(ts)))
        dpath = f"{render_dir}/depth_{idx:05d}.npy"
        cpath = f"{render_dir}/color_{idx:05d}.npy"
        if not os.path.exists(dpath):
            continue
        depth = np.load(dpath) * scale
        color = np.load(cpath) if os.path.exists(cpath) else None
        frames.append((depth, color, est_c2w[i].copy()))
    if not frames:
        if printer:
            printer.print("No depth dumps found; skip meshing.",
                          subsystem="error")
        return None

    # volume bounds from the back-projected depth extents
    mins, maxs = [], []
    for depth, _, c2w in frames[:: max(1, len(frames) // 20)]:
        v, u = np.nonzero(depth > 0)
        if len(v) == 0:
            continue
        z = depth[v, u]
        x = (u - cx) / fx * z
        y = (v - cy) / fy * z
        pts = np.stack([x, y, z], -1) @ c2w[:3, :3].T + c2w[:3, 3]
        mins.append(pts.min(0))
        maxs.append(pts.max(0))
    if not mins:
        return None
    bmin = np.min(mins, 0) - 0.1
    bmax = np.max(maxs, 0) + 0.1

    extent = bmax - bmin
    n_vox = np.prod(np.ceil(extent / voxel_size))
    while n_vox > 3e8:
        voxel_size *= 1.26
        n_vox = np.prod(np.ceil(extent / voxel_size))

    vol = mesher.TSDFVolume(bmin, bmax, voxel_size=voxel_size, device=device)
    for depth, color, c2w in frames:
        vol.integrate(depth, color, intr, c2w)

    verts, faces, colors = vol.extract_mesh()
    os.makedirs(f"{output}/mesh", exist_ok=True)
    mesh_path = f"{output}/mesh/rendered_mesh_{mesh_name_suffix}.ply"
    mesher.write_ply_mesh(mesh_path, verts, faces, colors)
    if printer:
        printer.print(f"Mesh saved: {mesh_path} ({len(verts)} verts, "
                      f"{len(faces)} faces, voxel {voxel_size:.3f})",
                      subsystem="eval")
    return verts, faces
