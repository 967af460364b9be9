"""Weighted scale/shift fit of the mono-depth prior to the estimated
disparity. Counterpart of ``align_scale_and_shift`` in
``glorie_slam_tpu/geom/alignment.py`` (the ATE/Umeyama helpers of that
module belong to the evaluation slice and are not ported yet)."""

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
