"""SLAM entry point for tracking-only runs.

Counterpart of ``glorie_slam_tpu/slam.py`` with ``only_tracking``:
``SLAM(cfg, stream).run()`` tracks every frame of the stream, then
terminates: the final global BA (``tracking.backend.final_ba``),
``video.npz``, the keyframe ATE, the trajectory filler and the
full-trajectory ATE (``traj/``), and the phase times
(``logs/phase_times.json``).

Not here: the mapper and its evaluations (later slices), checkpoints and
resume, wandb, online mono-depth prediction, loading ``droid.pth``, and
the JAX package's ahead-of-time compile warm-up and shape profile (XLA
machinery with no counterpart in eager PyTorch). An evaluation that fails
fails the run; nothing in ``terminate`` is best-effort.
"""

import os

import numpy as np

from .core.depth_video import DepthVideo
from .device import resolve_device
from .nets.tracker_net import TrackerNet
from .tracking.backend import Backend
from .tracking.tracker import Tracker
from .tracking.trajectory_filler import PoseTrajectoryFiller
from .utils.eval_traj import full_traj_eval, kf_traj_eval
from .utils.phase_timer import PhaseTimer
from .utils.printer import Printer


def update_cam(cfg):
    """Output camera intrinsics after resize and crop (reference
    common.py:377-398) -> (H_out, W_out, fx, fy, cx, cy)."""
    cam = cfg["cam"]
    H, W = cam["H"], cam["W"]
    h_edge, w_edge = cam["H_edge"], cam["W_edge"]
    H_out, W_out = cam["H_out"], cam["W_out"]
    fx = cam["fx"] * (W_out + w_edge * 2) / W
    fy = cam["fy"] * (H_out + h_edge * 2) / H
    cx = cam["cx"] * (W_out + w_edge * 2) / W - w_edge
    cy = cam["cy"] * (H_out + h_edge * 2) / H - h_edge
    return H_out, W_out, fx, fy, cx, cy


def load_mono_depth(idx, cfg):
    """A cached mono-depth prior, ``{data.output}/{scene}_priors/depths/
    {idx:05d}.npy`` (reference datasets.py:10-15)."""
    dir_path = f"{cfg['data']['output']}/{cfg['scene']}_priors/depths"
    return np.load(f"{dir_path}/{int(idx):05d}.npy")


class SLAM:
    def __init__(self, cfg, stream, device=None):
        """cfg: the config dict; stream: indexable frames ``(timestamp,
        image (H, W, 3) in [0, 1], ...)`` with ``len``, ``poses`` (c2w
        ground truth, for the ATE) and ``get_intrinsic()``; device: the
        card unless ``"cpu"`` is asked for."""
        self.cfg = cfg
        self.stream = stream
        self.device = resolve_device(device)
        if not cfg.get("only_tracking", False):
            raise NotImplementedError(
                "the mapper is not ported yet; set only_tracking: True")
        self.output = (f"{cfg['data']['output']}/{cfg['setting']}/"
                       f"{cfg['scene']}")
        os.makedirs(f"{self.output}/logs/", exist_ok=True)

        self.H, self.W, self.fx, self.fy, self.cx, self.cy = update_cam(cfg)
        self.printer = Printer(len(stream), cfg.get("silence", False))
        ckpt = cfg["tracking"].get("pretrained")
        if ckpt and os.path.exists(ckpt):
            raise NotImplementedError(
                f"loading {ckpt} is not ported yet; unset "
                "tracking.pretrained to run with random weights")
        self.tracker_net = TrackerNet(device=self.device)
        self.printer.print(
            "WARNING: no droid checkpoint found, using random weights",
            subsystem="error")

        self.video = DepthVideo(cfg, device=self.device)
        self.backend = Backend(self.tracker_net, self.video, cfg)
        self.traj_filler = PoseTrajectoryFiller(self.tracker_net, self.video,
                                                self.printer)
        self.timer = PhaseTimer()
        self.tracker = Tracker(
            self.tracker_net, self.video, cfg, printer=self.printer,
            mono_predictor=self._make_mono_predictor(cfg), timer=self.timer)

    def _make_mono_predictor(self, cfg):
        """Mono-depth priors from the cache written beside the output
        (``load_mono_depth``); a frame without one gets none."""
        mp_cfg = cfg.get("mono_prior", {})
        if not mp_cfg:
            return None
        if mp_cfg.get("predict_online", False):
            raise NotImplementedError(
                "online mono-depth prediction is not ported yet; cache the "
                f"priors under {cfg['data']['output']}/{cfg['scene']}"
                "_priors/depths")

        def load(tstamp, image):
            try:
                return load_mono_depth(tstamp, cfg)
            except FileNotFoundError:
                return None

        return load

    def run(self):
        """Track the stream, then terminate."""
        self.tracker.run(self.stream)
        self.terminate()

    def final_ba(self):
        """Final global BA: 7 then 12 steps (reference slam.py:119-126)."""
        self.printer.print("Final Global BA Triggered!", subsystem="tracker")
        self.backend.dense_ba(7)
        self.backend.dense_ba(12)
        self.printer.print("Final Global BA Done!", subsystem="tracker")

    def terminate(self):
        """Final BA -> save video -> keyframe ATE -> trajectory filler and
        full ATE -> phase times. Nothing overlaps these phases, so each
        ends with a device synchronize and its time includes its work."""
        timer = self.timer
        timer.sync = True
        if self.cfg["tracking"]["backend"].get("final_ba", True):
            with timer.phase("final_ba"):
                self.final_ba()
        with timer.phase("save_video"):
            self.video.save_video(f"{self.output}/video.npz")

        traj_dir = f"{self.output}/traj"
        with timer.phase("eval_traj"):
            kf_traj_eval(f"{self.output}/video.npz", traj_dir, "kf_traj",
                         self.stream, self.printer)
        with timer.phase("trajectory_filler"):
            est_w2c, _, _ = full_traj_eval(self.traj_filler, traj_dir,
                                           "full_traj", self.stream,
                                           self.printer)
        np.save(f"{traj_dir}/full_traj_w2c.npy", np.asarray(est_w2c))
        timer.dump(f"{self.output}/logs/phase_times.json",
                   printer=self.printer)
        self.printer.print("Metrics have been written to logs/",
                           subsystem="eval")
        self.printer.terminate()
