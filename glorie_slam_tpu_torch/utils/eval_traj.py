"""Trajectory evaluation: keyframe and full ATE-RMSE after Sim(3) alignment.

Counterpart of ``glorie_slam_tpu/utils/eval_traj.py``: the same metrics
files (``{traj_dir}/metrics_{label}.txt``) and, where matplotlib imports,
the same trajectory plots. Alignment and statistics run in numpy on the
host.
"""

import os

import numpy as np
import torch

from ..geom import alignment, lie


def _gt_c2w_from_stream(stream, timestamps):
    """Ground-truth c2w 4x4s for the given frame timestamps (= frame index)."""
    return np.stack([np.asarray(stream.poses[int(round(float(t)))],
                                np.float64) for t in timestamps])


def _aligned(est_c2w, gt):
    """Sim(3)-align the estimate's positions to the ground truth; returns
    (scale, R, t, est_aligned (N, 4, 4))."""
    r, t, s = alignment.umeyama_alignment(est_c2w[:, :3, 3].T,
                                          gt[:, :3, 3].T, with_scale=True)
    est_aligned = est_c2w.copy()
    est_aligned[:, :3, 3] = (s * (r @ est_c2w[:, :3, 3].T) + t[:, None]).T
    est_aligned[:, :3, :3] = np.einsum("ij,njk->nik", r, est_c2w[:, :3, :3])
    return s, r, t, est_aligned


def align_kf_traj(npz_path, stream):
    """Load video.npz, associate with the ground truth by timestamp and
    Sim(3)-align. Returns (scale, R, t, est_aligned (N, 4, 4), gt (N, 4, 4),
    timestamps)."""
    data = np.load(npz_path)
    est = data["poses"]                       # (N, 4, 4) c2w
    timestamps = data["timestamps"]
    gt = _gt_c2w_from_stream(stream, timestamps)
    s, r, t, est_aligned = _aligned(est, gt)
    return s, r, t, est_aligned, gt, timestamps


def _ape_stats(est_aligned, gt):
    err = np.linalg.norm(est_aligned[:, :3, 3] - gt[:, :3, 3], axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "sse": float(np.sum(err ** 2)),
    }


def _plot_traj(est_aligned, gt, out_png, title):
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gt[:, 0, 3], gt[:, 1, 3], "k-", label="ground truth", lw=1)
    ax.plot(est_aligned[:, 0, 3], est_aligned[:, 1, 3], "b-",
            label="estimate", lw=1)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def _write(traj_dir, label, stats, s, est_aligned, gt):
    os.makedirs(traj_dir, exist_ok=True)
    with open(os.path.join(traj_dir, f"metrics_{label}.txt"), "w") as f:
        f.write(f"ATE-RMSE [m]: {stats['rmse']}\n")
        for k, v in stats.items():
            f.write(f"{k}: {v}\n")
        f.write(f"scale: {s}\n")
    _plot_traj(est_aligned, gt, os.path.join(traj_dir, f"{label}.png"),
               f"{label} ATE-RMSE {stats['rmse']:.4f} m")


def kf_traj_eval(npz_path, traj_dir, label, stream, printer=None):
    """Keyframe-trajectory ATE. Writes ``metrics_{label}.txt`` (and a
    plot); returns (ate_rmse, stats, scale)."""
    s, _, _, est_aligned, gt, _ = align_kf_traj(npz_path, stream)
    stats = _ape_stats(est_aligned, gt)
    _write(traj_dir, label, stats, s, est_aligned, gt)
    if printer is not None:
        printer.print(f"kf ATE-RMSE [m]: {stats['rmse']:.5f} "
                      f"(scale {s:.4f})", subsystem="eval")
    return stats["rmse"], stats, s


def full_traj_eval(traj_filler, traj_dir, label, stream, printer=None):
    """Full-trajectory ATE after the trajectory filler recovered every
    frame's pose. Returns (est_w2c (N, 7), ate_rmse, stats)."""
    est_w2c = traj_filler(stream)                        # (N, 7)
    est_c2w = lie.to_matrix(lie.inv(torch.as_tensor(
        est_w2c, dtype=torch.float32))).numpy().astype(np.float64)
    gt = _gt_c2w_from_stream(stream, np.arange(len(stream)))
    s, _, _, est_aligned = _aligned(est_c2w, gt)
    stats = _ape_stats(est_aligned, gt)
    _write(traj_dir, label, stats, s, est_aligned, gt)
    if printer is not None:
        printer.print(f"full ATE-RMSE [m]: {stats['rmse']:.5f} "
                      f"(scale {s:.4f})", subsystem="eval")
    return est_w2c, stats["rmse"], stats
