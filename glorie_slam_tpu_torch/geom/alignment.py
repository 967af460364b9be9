"""Least-squares alignment. Counterpart of
``glorie_slam_tpu/geom/alignment.py``:

- ``align_scale_and_shift``: weighted scale/shift fit of the mono-depth
  prior to the estimated disparity (torch, on the video's device);
- ``umeyama_alignment`` / ``ate_rmse``: the Sim(3) trajectory alignment of
  the ATE evaluation (numpy on the host, as in the JAX package).
"""

import numpy as np
import torch


def align_scale_and_shift(prediction, target, weights=None):
    """min_{s,o} sum w (s * prediction + o - target)^2 per batch item.

    prediction/target/weights (B, H, W). Returns (scale, shift, avg_error),
    each (B,), including the unguarded determinant division (callers
    replace non-finite results)."""
    if prediction.dim() < 3:
        prediction, target = prediction[None], target[None]
        if weights is not None:
            weights = weights[None]
    if weights is None:
        weights = torch.ones_like(prediction)
    weights = weights.to(prediction.dtype)
    dims = (1, 2)
    a_00 = torch.sum(weights * prediction * prediction, dim=dims)
    a_01 = torch.sum(weights * prediction, dim=dims)
    a_11 = torch.sum(weights, dim=dims)
    b_0 = torch.sum(weights * prediction * target, dim=dims)
    b_1 = torch.sum(weights * target, dim=dims)
    det = a_00 * a_11 - a_01 * a_01
    scale = (a_11 * b_0 - a_01 * b_1) / det
    shift = (-a_01 * b_0 + a_00 * b_1) / det
    error = (scale[:, None, None] * prediction + shift[:, None, None]
             - target).abs()
    avg_error = torch.sum(error * weights, dim=dims) / a_11
    return scale, shift, avg_error


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Closed-form s, R, t minimizing ||y - (s R x + t)||.

    x, y: (3, N) point sets. Returns (R (3, 3), t (3,), s float)."""
    if x.shape != y.shape:
        raise ValueError("umeyama: input shapes must match")
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    n = x.shape[1]
    sigma_x = ((x - mean_x[:, None]) ** 2).sum() / n
    cov_xy = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov_xy)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ v
    c = 1.0
    if with_scale:
        c = np.trace(np.diag(d) @ s_mat) / max(sigma_x, 1e-12)
    t = mean_y - c * (r @ mean_x)
    return r, t, float(c)


def ate_rmse(traj_est: np.ndarray, traj_gt: np.ndarray,
             align_scale: bool = True):
    """ATE-RMSE between (N, 3) translation trajectories after Sim(3) (or
    SE(3)) alignment. Returns (rmse, stats dict, aligned_est (N, 3))."""
    r, t, s = umeyama_alignment(traj_est.T, traj_gt.T,
                                with_scale=align_scale)
    aligned = (s * (r @ traj_est.T) + t[:, None]).T
    err = np.linalg.norm(aligned - traj_gt, axis=1)
    stats = {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "scale": s,
    }
    return stats["rmse"], stats, aligned
