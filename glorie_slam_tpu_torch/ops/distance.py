"""Frame distance: mean induced-flow magnitude between keyframes.

Counterpart of ``glorie_slam_tpu/ops/distance.py``: full-SE3 flow and
translation-only flow mixed by ``beta``; 1000 when fewer than 75% of the
pixels stay valid. Large edge lists are processed in slices so the
per-edge temporaries stay bounded.
"""

import torch

from ..geom import lie, projective

_MIN_DEPTH = 0.25
_CHUNK = 4096


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3):
    """Mean flow distance for each edge i -> j. Returns (E,)."""
    E = ii.shape[0]
    if E > _CHUNK:
        return torch.cat([
            _frame_distance(poses, disps, intrinsics, ii[s:s + _CHUNK],
                            jj[s:s + _CHUNK], beta)
            for s in range(0, E, _CHUNK)])
    return _frame_distance(poses, disps, intrinsics, ii, jj, beta)


def _frame_distance(poses, disps, intrinsics, ii, jj, beta):
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = projective.coords_grid(ht, wd, disps.dtype, disps.device)
    X0 = projective.iproj(disps[ii], intrinsics)
    Gij = lie.rel(poses[ii], poses[jj])[:, None, None, :]

    def flow_mag(Xj):
        z = Xj[..., 2]
        u = fx * Xj[..., 0] / z + cx
        v = fy * Xj[..., 1] / z + cy
        d = torch.sqrt((u - grid[..., 0]) ** 2 + (v - grid[..., 1]) ** 2)
        return d, (z > _MIN_DEPTH).to(disps.dtype)

    d1, v1 = flow_mag(lie.act(Gij, X0))
    Xt = torch.cat([X0[..., :3] + X0[..., 3:4] * Gij[..., :3], X0[..., 3:]],
                   dim=-1)
    d2, v2 = flow_mag(Xt)
    accum = (beta * torch.sum(d1 * v1, dim=(1, 2))
             + (1 - beta) * torch.sum(d2 * v2, dim=(1, 2)))
    valid = (beta * torch.sum(v1, dim=(1, 2))
             + (1 - beta) * torch.sum(v2, dim=(1, 2)))
    frac = valid / (ht * wd + 1e-8)
    return torch.where(frac < 0.75, torch.full_like(accum, 1000.0),
                       accum / valid.clamp(min=1e-8))


def frame_distance_bidirectional(poses, disps, intrinsics, ii, jj, beta=0.3):
    """0.5 * (d(i->j) + d(j->i))."""
    return 0.5 * (frame_distance(poses, disps, intrinsics, ii, jj, beta)
                  + frame_distance(poses, disps, intrinsics, jj, ii, beta))
