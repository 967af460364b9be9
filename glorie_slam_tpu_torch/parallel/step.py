"""One tracking step (ConvGRU update + BA with the RGB-D term), edge-sharded.

Counterpart of ``glorie_slam_tpu/parallel/step.py`` (``tracking_step``):
one recurrent update of the edges followed by ``iters`` Gauss-Newton BA
iterations with ``sensor_disps``. Under an edge group each rank updates
and linearizes the edges of its source-frame range (``mesh.py``); the pose
system is summed across ranks, the solve is replicated, and the results
are gathered, so that every rank returns the whole step's outputs.
"""

import numpy as np
import torch

from ..core.factor_graph import graph_update_step
from ..geom import ba as ba_mod, projective
from . import mesh


def tracking_step(tn, poses, disps, intrinsics, feat_pyr, net, inp, target,
                  eta, sensor_disps, ii, jj, t0, t1, kbase, *, P_max, K_max,
                  iters=2, group=None):
    """-> (poses, disps, net, target, weight, eta_agg, upmask).

    tn: ``TrackerNet``; poses (N,7), disps (N,h,w), feat_pyr: the frames'
    lookup stores (``DepthVideo.corr_pyr``), replicated; net/inp (E,h,w,128)
    and target (E,h,w,2) per edge; eta/sensor_disps (N,h,w); ii/jj host
    ints (E,). eta_agg (M,h,w) and upmask (M,576,h,w) are per source frame
    of ``np.unique(ii)``. ``group``: edge-sharded over its ranks."""
    ii = np.asarray(ii, np.int64)
    jj = np.asarray(jj, np.int64)
    dev = poses.device
    h, w = disps.shape[-2:]
    coords0 = projective.coords_grid(h, w, device=dev)
    bounds = None
    if group is not None:
        bounds = mesh.frame_bounds(ii, group.world, disps.shape[0])
        act = mesh.rank_edges(ii, bounds)
        net, inp, target = mesh.shard_edge_arrays(group, bounds, ii, net,
                                                  inp, target)
        ii_l, jj_l = ii[act[group.rank]], jj[act[group.rank]]
    else:
        ii_l, jj_l = ii, jj
    kx, kk = np.unique(ii_l, return_inverse=True)

    def idx(x):
        return torch.as_tensor(x, device=dev)

    net2, target2, weight2, eta_agg, upmask, _ = graph_update_step(
        tn, poses, disps, intrinsics, feat_pyr, net, inp, target, idx(ii_l),
        idx(jj_l), idx(kk), coords0, len(kx))
    poses2, disps2 = ba_mod.ba(
        poses, disps, intrinsics, target2, weight2, eta, ii, jj, t0, t1,
        kbase, P_max=P_max, K_max=K_max, iters=iters,
        sensor_disps=sensor_disps, group=group, bounds=bounds)
    if group is None:
        return poses2, disps2, net2, target2, weight2, eta_agg, upmask

    sizes = [len(a) for a in act]
    order = idx(np.concatenate(act))

    def edges(x):
        out = torch.empty((len(ii),) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[order] = torch.cat(group.gather_rows(x, sizes))
        return out

    frames = np.unique(ii)
    return (poses2, disps2, edges(net2), edges(target2), edges(weight2),
            mesh.gather_frame_rows(group, bounds, frames, eta_agg),
            mesh.gather_frame_rows(group, bounds, frames, upmask))
