"""Visual diagnostics: per-mapping-frame panels and 3D trajectory plots.

Counterpart of ``glorie_slam_tpu/utils/visualizer.py`` (reference
src/utils/Visualizer.py):

* ``Visualizer.vis``: one figure of ten panels for a mapped keyframe (input,
  proxy, rendered, droid and mono depth, the depth residual, input and
  rendered colour, the colour residual, valid-ray counts), written to
  ``{vis_dir}/{idx:05d}_{iter:04d}.jpg``, and with ``save_rendered_image``
  the rendered colour to ``{img_dir}/frame_{idx:05d}.png``;
* ``CameraPoseVisualizer.plot``: camera frusta along the estimated (and
  ground-truth) trajectory, written to ``out_path``.

matplotlib is imported when a figure is drawn. Where it is not installed,
the first call prints that the panels are skipped and every call returns
without drawing; any other failure raises.
"""

import os

import numpy as np


def _pyplot(owner):
    """matplotlib.pyplot (Agg backend), or None after one message."""
    try:
        import matplotlib
    except ImportError:
        if not owner._warned:
            owner._warned = True
            msg = ("matplotlib is not installed: the visualizer's figures "
                   "are skipped")
            if owner.printer is not None:
                owner.printer.print(msg, subsystem="info")
            else:
                print(msg)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    if x is None:
        return None
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


class Visualizer:
    def __init__(self, vis_dir, img_dir=None, freq=50, printer=None):
        self.vis_dir = vis_dir
        self.img_dir = img_dir
        self.freq = freq
        self.printer = printer
        self._warned = False
        os.makedirs(vis_dir, exist_ok=True)
        if img_dir:
            os.makedirs(img_dir, exist_ok=True)

    def vis(self, idx, iter_i, gt_depth, render_depth, droid_depth,
            mono_depth, gt_color, rendered_depth, rendered_color,
            valid_count=None, freq_override=False,
            save_rendered_image=False):
        """The panel figure of keyframe ``idx`` (every ``freq``-th, or any
        with ``freq_override``)."""
        if not freq_override and idx % self.freq != 0:
            return
        plt = _pyplot(self)
        if plt is None:
            return
        gt_depth, render_depth = _np(gt_depth), _np(render_depth)
        droid_depth, mono_depth = _np(droid_depth), _np(mono_depth)
        gt_color, rendered_depth = _np(gt_color), _np(rendered_depth)
        rendered_color = _np(rendered_color)
        if rendered_color is not None:
            rendered_color = np.clip(rendered_color, 0, 1)
        panels = [
            ("input depth", gt_depth, "plasma"),
            ("proxy depth", render_depth, "plasma"),
            ("rendered depth", rendered_depth, "plasma"),
            ("depth residual",
             None if rendered_depth is None or render_depth is None
             else np.abs(render_depth - rendered_depth), "plasma"),
            ("droid depth", droid_depth, "plasma"),
            ("mono depth", mono_depth, "plasma"),
            ("input color", gt_color, None),
            ("rendered color", rendered_color, None),
            ("color residual",
             None if rendered_color is None or gt_color is None
             else np.abs(gt_color - rendered_color), None),
            ("valid ray count", _np(valid_count), "viridis"),
        ]
        fig, axes = plt.subplots(4, 3, figsize=(12, 12))
        for ax, (title, img, cmap) in zip(axes.reshape(-1), panels):
            ax.set_title(title, fontsize=8)
            ax.axis("off")
            if img is not None:
                ax.imshow(img, cmap=cmap)
        for ax in axes.reshape(-1)[len(panels):]:
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(f"{self.vis_dir}/{idx:05d}_{iter_i:04d}.jpg", dpi=90)
        plt.close(fig)
        if save_rendered_image and self.img_dir and rendered_color is not None:
            plt.imsave(f"{self.img_dir}/frame_{idx:05d}.png", rendered_color)


class CameraPoseVisualizer:
    """Camera frusta along a trajectory (reference Visualizer.py)."""

    def __init__(self, out_path, printer=None):
        self.out_path = out_path
        self.printer = printer
        self._warned = False

    def plot(self, c2ws_est, c2ws_gt=None, frustum_scale=0.05, stride=1):
        plt = _pyplot(self)
        if plt is None:
            return
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")

        def draw(poses, color, label):
            ts = poses[:, :3, 3]
            ax.plot(ts[:, 0], ts[:, 1], ts[:, 2], color=color, lw=1,
                    label=label)
            for T in poses[::stride]:
                o = T[:3, 3]
                for corner in ([1, 1, 2], [1, -1, 2], [-1, -1, 2],
                               [-1, 1, 2]):
                    d = T[:3, :3] @ (np.asarray(corner) * frustum_scale)
                    ax.plot(*zip(o, o + d), color=color, lw=0.3, alpha=0.5)

        draw(_np(c2ws_est), "tab:blue", "estimate")
        if c2ws_gt is not None:
            draw(_np(c2ws_gt), "k", "ground truth")
        ax.legend()
        fig.savefig(self.out_path, dpi=120)
        plt.close(fig)
