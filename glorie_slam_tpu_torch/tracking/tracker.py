"""Tracker loop: motion filter -> frontend -> periodic online global BA
-> mapper handshake.

Counterpart of ``glorie_slam_tpu/tracking/tracker.py``: every
``mapping.every_keyframe``-th keyframe calls ``on_keyframe`` inside a
``mapper`` phase (the synchronous ``Mapper.on_keyframe`` or
``AsyncMapper.on_keyframe``), and the end of the stream sends a final
``{"end": True}``, in the same phase (the asynchronous mapper drains its
queue there). Checkpoint hooks are not ported.
"""

from ..utils.phase_timer import PhaseTimer
from .backend import Backend
from .frontend import Frontend
from .motion_filter import MotionFilter


class Tracker:
    def __init__(self, tracker_net, video, cfg, printer=None,
                 mono_predictor=None, on_keyframe=None, timer=None):
        self.cfg = cfg
        self.video = video
        self.printer = printer
        self.on_keyframe = on_keyframe
        if on_keyframe is not None:
            self.every_kf = cfg["mapping"]["every_keyframe"]
        self.timer = timer if timer is not None else PhaseTimer()
        tcfg = cfg["tracking"]
        predict_every = None
        if cfg.get("mono_prior", {}).get("predict_online"):
            predict_every = int(cfg.get("mapping", {}).get("every_frame") or 1)
        self.motion_filter = MotionFilter(
            tracker_net, video, thresh=tcfg["motion_filter"]["thresh"],
            mono_predictor=mono_predictor, predict_every=predict_every)
        self.frontend = Frontend(tracker_net, video, cfg)
        self.online_ba = Backend(tracker_net, video, cfg)
        self.enable_online_ba = tcfg["frontend"]["enable_online_ba"]
        self.ba_freq = tcfg["backend"]["ba_freq"]
        self.prev_kf_idx = 0
        self.prev_ba_idx = 0
        self.number_of_kf = 0

    def step(self, i, stream):
        """Track stream frame ``i``: motion filter, prefetch of frame
        i + 1, frontend, online BA every ``ba_freq`` keyframes, and the
        mapper handshake."""
        timer = self.timer
        timestamp, image = stream[i][0], stream[i][1]
        with timer.phase("motion_filter"):
            self.motion_filter.track(timestamp, image,
                                     stream.get_intrinsic())
        if i + 1 < len(stream):
            with timer.phase("prefetch"):
                self.motion_filter.prefetch(stream[i + 1][0],
                                            stream[i + 1][1])
        with timer.phase("frontend"):
            self.frontend()
        curr_kf_idx = self.video.counter - 1
        if curr_kf_idx != self.prev_kf_idx and self.frontend.is_initialized:
            self.number_of_kf += 1
            timer.keyframe()
            if (self.enable_online_ba
                    and curr_kf_idx >= self.prev_ba_idx + self.ba_freq):
                if self.printer is not None:
                    self.printer.print(
                        f"Online BA at {curr_kf_idx}th keyframe, frame "
                        f"index: {timestamp}", subsystem="tracker")
                with timer.phase("online_ba"):
                    self.online_ba.dense_ba(2)
                self.prev_ba_idx = curr_kf_idx
            if (self.on_keyframe is not None
                    and self.number_of_kf % self.every_kf == 0):
                with timer.phase("mapper"):
                    self.on_keyframe({"is_keyframe": True,
                                      "video_idx": curr_kf_idx,
                                      "timestamp": timestamp, "end": False})
        self.prev_kf_idx = curr_kf_idx
        if self.printer is not None:
            self.printer.update_pbar()

    def run(self, stream):
        """Track every frame of ``stream`` (indexable, ``len``, yielding
        (timestamp, image_hw3_01, ...), with ``get_intrinsic()``)."""
        for i in range(len(stream)):
            self.step(i, stream)
        if self.on_keyframe is not None:
            with self.timer.phase("mapper"):
                self.on_keyframe({"is_keyframe": True, "video_idx": None,
                                  "timestamp": None, "end": True})
