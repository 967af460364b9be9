"""Pinhole projection with analytic Jacobians, edge-batched.

Counterpart of ``glorie_slam_tpu/geom/projective.py``: points use the
inverse-depth parameterization [x/z, y/z, 1, disp]; given buffer-wide
``poses (N,7)``, ``disps (N,ht,wd)`` and edge lists ``ii/jj (E,)`` the
functions return per-edge dense fields ``(E, ht, wd, ...)``. Intrinsics are
one shared ``[fx, fy, cx, cy]`` tensor.
"""

import torch

from . import lie

MIN_DEPTH = 0.2
_STEREO = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def coords_grid(ht: int, wd: int, dtype=torch.float32, device=None):
    """Pixel coordinate grid (ht, wd, 2) ordered [x, y]."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def iproj(disps, intrinsics):
    """disps (..., ht, wd) -> homogeneous points (..., ht, wd, 4)."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    X = ((grid[..., 0] - cx) / fx).expand(disps.shape)
    Y = ((grid[..., 1] - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs, intrinsics, return_depth=False):
    """Project homogeneous points -> pixel coords (..., 2), or (..., 3)
    with the projected inverse depth appended."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    if return_depth:
        return torch.stack([x, y, D * d], dim=-1)
    return torch.stack([x, y], dim=-1)


def rel_poses(poses, ii, jj):
    """Per-edge G_ij = T_jj ∘ T_ii^-1, with the stereo transform on ii == jj."""
    Gij = lie.rel(poses[ii], poses[jj])
    stereo = torch.tensor(_STEREO, dtype=Gij.dtype, device=Gij.device)
    return torch.where((ii == jj)[:, None], stereo, Gij)


def projective_transform(poses, disps, intrinsics, ii, jj, jacobian=False,
                         return_depth=False):
    """Map pixels of frames ``ii`` into frames ``jj``.

    Returns coords (E, ht, wd, 2) (3 with ``return_depth``: the projected
    inverse depth), valid (E, ht, wd, 1) and, with
    ``jacobian``, (Ji, Jj, Jz) of shapes (E, ht, wd, 2, 6) x2 and
    (E, ht, wd, 2, 1).
    """
    X0 = iproj(disps[ii], intrinsics)
    Gij = rel_poses(poses, ii, jj)
    Gb = Gij[:, None, None, :]
    X1 = lie.act(Gb, X0)
    x1 = proj(X1, intrinsics, return_depth=return_depth)
    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)).to(
        disps.dtype)[..., None]
    if not jacobian:
        return x1, valid

    fx, fy, cx, cy = intrinsics.unbind(-1)
    X, Y, Z, h = X1.unbind(-1)
    Zs = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Zs
    d2 = d * d
    o = torch.zeros_like(d)
    Jj0 = torch.stack([fx * h * d, o, -fx * X * h * d2,
                       -fx * X * Y * d2, fx * (1.0 + X * X * d2),
                       -fx * Y * d], dim=-1)
    Jj1 = torch.stack([o, fy * h * d, -fy * Y * h * d2,
                       -fy * (1.0 + Y * Y * d2), fy * X * Y * d2,
                       fy * X * d], dim=-1)
    Jj = torch.stack([Jj0, Jj1], dim=-2)
    Ji = -lie.adjT(Gb[..., None, :], Jj)
    tij = Gij[:, None, None, :3]
    Jz0 = fx * (tij[..., 0] * d - tij[..., 2] * X * d2)
    Jz1 = fy * (tij[..., 1] * d - tij[..., 2] * Y * d2)
    Jz = torch.stack([Jz0, Jz1], dim=-1)[..., None]
    return x1, valid, (Ji, Jj, Jz)


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow induced by camera motion -> (flow (E, ht, wd, 2),
    valid (E, ht, wd, 1))."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, disps.dtype, disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid


def iproj_world(poses, disps, intrinsics):
    """Backproject disparity maps (N, ht, wd) with world->camera poses
    (N, 7) to world points (N, ht, wd, 3): T^-1 [X/d, Y/d, 1/d]."""
    pts = iproj(disps, intrinsics)
    d = pts[..., 3:4].clamp(min=1e-8)
    cam_pts = pts[..., :3] / d
    return lie.act3(lie.inv(poses)[:, None, None, :], cam_pts)


def projmap(poses, disps, intrinsics, ii, jj):
    """Dense reprojection map: coords (E, ht, wd, 3) with the projected
    inverse depth, and validity (E, ht, wd, 1)."""
    return projective_transform(poses, disps, intrinsics, ii, jj,
                                return_depth=True)
