"""Multiview depth-consistency filter.

Counterpart of ``glorie_slam_tpu/ops/depth_filter.py``: each pixel of frame
ix is reprojected into the 6 neighbour keyframes ix + {-1,-2,-3,+3,+4,+5};
a neighbour counts when the projected depth matches any of the 4 bilinear
corner depths within the frame's threshold. The reprojection is plain
tensor code; the 4-corner test is kernel B (``cuda_corr.depth_agree``),
for the full-resolution mask and the 1/8-resolution refresh alike (the JAX
package's two paths compute the same function).
"""

import torch

from ..geom import lie, projective
from ..utils.phase_timer import sync
from . import cuda_corr

NEIGH_OFFSETS = (-1, -2, -3, 3, 4, 5)


def pack_agreement_inputs(poses, disps, intrinsics, inds, thresh):
    """Reproject frames ``inds`` into their 6 neighbours.

    Returns (jx_safe (M, 6) int32, in_range (M, 6) bool,
    cu (M, 24, npix) float32 packed per neighbour as [u, v, izd, thr])."""
    N, ht, wd = disps.shape
    npix = ht * wd
    fx, fy, cx, cy = intrinsics.unbind(-1)
    M = inds.shape[0]
    with sync("neighbour_offsets"):
        offs = torch.tensor(NEIGH_OFFSETS, dtype=torch.long,
                            device=disps.device)
    ix = inds.long()
    jx = ix[:, None] + offs[None, :]
    in_range = (jx >= 0) & (jx < N)
    jx_safe = jx.clamp(0, N - 1)
    X0 = projective.iproj(disps[ix], intrinsics)           # (M, ht, wd, 4)
    Gij = lie.rel(poses[ix][:, None], poses[jx_safe])      # (M, 6, 7)
    Xj = lie.act(Gij[:, :, None, None], X0[:, None])       # (M,6,ht,wd,4)
    z = Xj[..., 2]
    u = fx * Xj[..., 0] / z + cx
    v = fy * Xj[..., 1] / z + cy
    izd = 1.0 / (Xj[..., 3] / z)
    thr = thresh.float()[:, None, None, None].expand(M, 6, ht, wd)
    cu = torch.stack([u, v, izd, thr], dim=2).reshape(M, 24, npix)
    return jx_safe.to(torch.int32), in_range, cu.contiguous()


def depth_filter(poses, disps, intrinsics, inds, thresh, chunk=None):
    """Agreement counts (M, ht, wd) for frames ``inds`` with per-frame
    thresholds ``thresh`` (M,). Source frames go through in chunks of
    ``chunk`` (default: ~4M pixels per chunk), which bounds the
    reprojection temporaries at full resolution and is one launch at 1/8."""
    N, ht, wd = disps.shape
    if chunk is None:
        chunk = max(1, (1 << 22) // (ht * wd))
    dmaps = disps.float().contiguous()
    counts = []
    for s in range(0, inds.shape[0], chunk):
        ix = inds[s:s + chunk]
        jx, in_range, cu = pack_agreement_inputs(
            poses, disps, intrinsics, ix, thresh[s:s + chunk])
        agree = cuda_corr.depth_agree(dmaps, jx, cu)
        agree = agree * in_range[:, :, None].to(agree.dtype)
        counts.append(agree.sum(dim=1).reshape(-1, ht, wd))
    return torch.cat(counts).to(disps.dtype)
