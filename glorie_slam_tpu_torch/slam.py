"""SLAM entry point: tracking, mapping and the end-of-run evaluations.

Counterpart of ``glorie_slam_tpu/slam.py``: ``SLAM(cfg, stream).run()``
tracks every frame of the stream and, unless ``only_tracking``, maps each
``mapping.every_keyframe``-th keyframe, on a worker thread against a
snapshot of the video (``mapping.async_mapping``, the default) or inside
the tracker's handshake. Mono-depth priors come from the omnidata DPT run
online (``mono_prior.predict_online``: ``mapping/mono_prior.py``, cached as
``.npy``) or from that cache. It then terminates: the worker is joined, the
final global BA (``tracking.backend.final_ba``), the mapper's
``final_refine`` and point-cloud files, ``video.npz``, the keyframe ATE,
the trajectory filler and the full-trajectory ATE (``traj/``); with the
mapper, the keyframe render metrics (``eval_kf_imgs``), the TSDF mesh
(``generate_mesh_kf``), the full-trajectory render metrics
(``eval_imgs``) and, where ``meshing.gt_mesh_path`` exists, the
reconstruction metrics (``logs/metrics_recon.txt``); and the phase times
(``logs/phase_times.json``). ``tracking.pretrained``,
``mapping.pretrained`` and ``mono_prior.depth_pretrained`` load
``droid.pth``, ``middle_fine.pt`` and the omnidata checkpoint where the
files exist; otherwise the weights are random.

``tracking.checkpoint_every`` N > 0 saves the whole SLAM state to
``{output}/state.npz`` every N keyframes (``save_state``, in the JAX
package's layout: ``utils/checkpoint.py``), and ``run(resume_from=path)``
continues from such a file. With ``wandb: True`` a wandb run is opened
where ``wandb`` is installed (a message says so where it is not).

``tracking.mesh_devices`` n > 1 runs the tracker edge-sharded over the n
ranks of an edge group (``parallel/``; the CLI starts them, or torchrun):
every rank tracks, with the edge work split and the host decisions taken
from rank 0; the mapper, the asynchronous worker, checkpoints, the
trajectory filler, every evaluation, every file written and the printing
are rank 0's, while the final BA runs on every rank. Without such a group
the run raises. A resume loads the file on every rank.

Not here: the JAX package's ahead-of-time compile warm-up and shape profile
(XLA machinery with no counterpart in eager PyTorch). A mapper, an online
prior or an evaluation that fails fails the run: the JAX package's
fall-backs (to tracking alone, to cached priors) and its best-effort
evaluations are not copied.
"""

import os

import numpy as np
import torch

from .core.depth_video import DepthVideo
from .device import resolve_device
from .mapping.async_worker import AsyncMapper
from .mapping.mapper import Mapper
from .mapping.mono_prior import MonoDepthEstimator
from .nets.tracker_net import TrackerNet
from .ops import cuda_corr
from .parallel import mesh as mesh_mod
from .tracking.backend import Backend
from .tracking.tracker import Tracker
from .tracking.trajectory_filler import PoseTrajectoryFiller
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.datasets import load_mono_depth
from .utils.eval_recon import eval_recon_with_cfg
from .utils.eval_traj import full_traj_eval, kf_traj_eval
from .utils.generate_mesh import generate_mesh_kf
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


class SLAM:
    def __init__(self, cfg, stream, device=None):
        """cfg: the config dict; stream: indexable frames ``(timestamp,
        image (H, W, 3) in [0, 1], ...)`` with ``len``, ``poses`` (c2w
        ground truth, for the ATE) and ``get_intrinsic()``; device: the
        card unless ``"cpu"`` is asked for."""
        self.cfg = cfg
        self.stream = stream
        self.group = mesh_mod.group_for(cfg)
        if self.group is not None:
            if (device is not None
                    and torch.device(device).type != self.group.device.type):
                raise ValueError(f"device {device} but the edge group runs "
                                 f"on {self.group.device}")
            device = self.group.device
        self.rank0 = self.group is None or self.group.rank == 0
        self.device = resolve_device(device)
        self.output = (f"{cfg['data']['output']}/{cfg['setting']}/"
                       f"{cfg['scene']}")
        os.makedirs(f"{self.output}/logs/", exist_ok=True)

        self.H, self.W, self.fx, self.fy, self.cx, self.cy = update_cam(cfg)
        self.printer = Printer(len(stream),
                               cfg.get("silence", False) or not self.rank0)
        self.logger = self._wandb_run(cfg) if self.rank0 else None
        ckpt = cfg["tracking"].get("pretrained")
        if ckpt and os.path.exists(ckpt):
            self.tracker_net = TrackerNet.from_checkpoint(ckpt,
                                                          device=self.device)
            self.printer.print(f"Loaded droid checkpoint from {ckpt}",
                               subsystem="info")
        else:
            self.tracker_net = TrackerNet(device=self.device)
            self.printer.print(
                "WARNING: no droid checkpoint found, using random weights",
                subsystem="error")

        self.video = DepthVideo(cfg, device=self.device)
        self.backend = Backend(self.tracker_net, self.video, cfg)
        self.traj_filler = PoseTrajectoryFiller(self.tracker_net, self.video,
                                                self.printer)
        self.timer = PhaseTimer()
        # the CUDA kernels' launches since this SLAM was built go into
        # logs/phase_times.json
        self._launches = {k.name: k.launches for k in cuda_corr.KERNELS}
        mono_predictor = self._make_mono_predictor(cfg)
        self.mapper = self.async_mapper = on_kf = None
        mapping = not cfg.get("only_tracking", False)
        if mapping and self.rank0:
            self.mapper = Mapper(self, cfg)
            if cfg["mapping"].get("async_mapping", True):
                self.async_mapper = AsyncMapper(self.mapper, self.video,
                                                printer=self.printer)
                on_kf = self.async_mapper.on_keyframe
            else:
                on_kf = self.mapper.on_keyframe
        self.tracker = Tracker(
            self.tracker_net, self.video, cfg, printer=self.printer,
            mono_predictor=mono_predictor, on_keyframe=on_kf,
            timer=self.timer)
        # the mapper writes scale/shift rows on rank 0 alone
        self.tracker.sync_scale_shift = mapping and self.group is not None
        if self.tracker.checkpoint_every and self.rank0:
            self.tracker.checkpoint_cb = lambda nxt: self.save_state(
                f"{self.output}/state.npz", nxt)

    def _wandb_run(self, cfg):
        """A wandb run with ``wandb: True`` (reference slam.py:28-37), or
        None; without the ``wandb`` package, a message and None."""
        if not cfg.get("wandb", False):
            return None
        try:
            import wandb
        except ImportError:
            self.printer.print("wandb is not installed: the run is not "
                               "logged to wandb", subsystem="info")
            return None
        return wandb.init(
            resume="allow", config=cfg,
            project=cfg.get("setting", "glorie_slam_tpu"),
            group=cfg.get("dataset", ""), name=cfg.get("scene", ""),
            dir=cfg.get("wandb_folder", "output/wandb"),
            tags=[cfg.get("scene", "")])

    def _make_mono_predictor(self, cfg):
        """Mono-depth priors: the DPT online (``self.mono_estimator``, its
        predictions cached) with ``mono_prior.predict_online``, else the
        cache written beside the output (``load_mono_depth``), where a
        frame without one gets none."""
        mp_cfg = cfg.get("mono_prior", {})
        self.mono_estimator = None
        if not mp_cfg:
            return None
        if mp_cfg.get("predict_online", False):
            self.mono_estimator = MonoDepthEstimator(
                cfg, device=self.device, write_cache=self.rank0)
            return self.mono_estimator.predict_and_cache

        def load(tstamp, image):
            try:
                return load_mono_depth(tstamp, cfg)
            except FileNotFoundError:
                return None

        return load

    def run(self, resume_from=None):
        """Track the stream, then terminate. ``resume_from``: a checkpoint
        (``save_state``'s, or the JAX package's) to restore first; tracking
        continues from its next frame."""
        start = 0
        if resume_from:
            with self.timer.phase("load_checkpoint"):
                start = self.load_state(resume_from)
            self.printer.print(f"resumed from {resume_from} at frame {start}",
                               subsystem="tracker")
        self.tracker.run(self.stream, start=start)
        self.terminate()

    def save_state(self, path, next_frame):
        """Write the live SLAM state to ``path`` (between frames;
        ``next_frame`` is the first stream index a resume runs). The
        asynchronous mapper finishes its queued jobs first."""
        if self.async_mapper is not None:
            self.async_mapper.quiesce()
        save_checkpoint(path, self.tracker, next_frame, mapper=self.mapper)

    def load_state(self, path):
        """Restore a checkpoint; returns the stream index to resume from."""
        return load_checkpoint(path, self.tracker, mapper=self.mapper)

    def final_ba(self):
        """Final global BA: 7 then 12 steps (reference slam.py:119-126)."""
        self.printer.print("Final Global BA Triggered!", subsystem="tracker")
        self.backend.dense_ba(7)
        self.backend.dense_ba(12)
        self.printer.print("Final Global BA Done!", subsystem="tracker")

    def terminate(self):
        """Join the mapper -> final BA -> final refine -> save video ->
        keyframe ATE -> trajectory filler and full ATE -> (with the mapper)
        keyframe render metrics -> mesh -> full-trajectory render metrics
        -> reconstruction metrics -> phase times. Nothing overlaps these
        phases, so each ends with a device synchronize and its time
        includes its work."""
        timer = self.timer
        timer.sync = True
        if not self.rank0:
            if self.cfg["tracking"]["backend"].get("final_ba", True):
                self.final_ba()
            self.printer.terminate()
            return
        if self.async_mapper is not None:
            # the tracker's end handshake joined it already; a run cut short
            # still gets a quiescent mapper here
            self.async_mapper.join()
        if self.cfg["tracking"]["backend"].get("final_ba", True):
            with timer.phase("final_ba"):
                self.final_ba()
        if self.mapper is not None:
            with timer.phase("final_refine"):
                self.mapper.final_refine(save_final_pcl=True)
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
        if self.mapper is not None:
            self.evaluate()
        launches = {k.name: k.launches - self._launches[k.name]
                    for k in cuda_corr.KERNELS}
        timer.dump(f"{self.output}/logs/phase_times.json",
                   printer=self.printer, kernel_launches=launches)
        self.printer.print("Metrics have been written to logs/",
                           subsystem="eval")
        self.printer.terminate()

    def evaluate(self):
        """The mapper's evaluations, in the JAX package's order, each in
        its own phase (reference slam.py:176-187)."""
        timer, cfg = self.timer, self.cfg
        with timer.phase("eval_kf_imgs"):
            self.mapper.eval_kf_imgs()
        with timer.phase("generate_mesh_kf"):
            mesh = generate_mesh_kf(cfg, stream=self.stream,
                                    printer=self.printer, device=self.device)
        with timer.phase("eval_imgs"):
            self.mapper.eval_imgs()
        gt_mesh = cfg.get("meshing", {}).get("gt_mesh_path", "")
        if not (gt_mesh and os.path.exists(gt_mesh)):
            return
        if mesh is None or len(mesh[1]) == 0:
            # nothing rendered or no surface crossed: nothing to score
            self.printer.print("No mesh to evaluate against the ground "
                               "truth.", subsystem="eval")
            return
        with timer.phase("eval_recon"):
            result = eval_recon_with_cfg(cfg, printer=self.printer,
                                         device=self.device)
        with open(f"{self.output}/logs/metrics_recon.txt", "w+") as fp:
            for k, v in result.items():
                fp.write(f"{k}: {v}\n")
