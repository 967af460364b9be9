"""Tracker loop: motion filter -> frontend -> periodic online global BA.

Counterpart of ``glorie_slam_tpu/tracking/tracker.py`` for the tracking
slice (``only_tracking``; the mapper handshake and checkpoint hooks belong
to later slices).
"""

from ..utils.phase_timer import PhaseTimer
from .backend import Backend
from .frontend import Frontend
from .motion_filter import MotionFilter


class Tracker:
    def __init__(self, tracker_net, video, cfg, mono_predictor=None,
                 timer=None):
        self.cfg = cfg
        self.video = video
        self.timer = timer if timer is not None else PhaseTimer()
        tcfg = cfg["tracking"]
        self.motion_filter = MotionFilter(
            tracker_net, video, thresh=tcfg["motion_filter"]["thresh"],
            mono_predictor=mono_predictor)
        self.frontend = Frontend(tracker_net, video, cfg)
        self.online_ba = Backend(tracker_net, video, cfg)
        self.enable_online_ba = tcfg["frontend"]["enable_online_ba"]
        self.ba_freq = tcfg["backend"]["ba_freq"]
        self.prev_kf_idx = 0
        self.prev_ba_idx = 0

    def step(self, i, stream):
        """Track stream frame ``i``: motion filter, prefetch of frame
        i + 1, frontend, and online BA every ``ba_freq`` keyframes."""
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
            if (self.enable_online_ba
                    and curr_kf_idx >= self.prev_ba_idx + self.ba_freq):
                with timer.phase("online_ba"):
                    self.online_ba.dense_ba(2)
                self.prev_ba_idx = curr_kf_idx
        self.prev_kf_idx = curr_kf_idx

    def run(self, stream):
        """Track every frame of ``stream`` (indexable, ``len``, yielding
        (timestamp, image_hw3_01, ...), with ``get_intrinsic()``)."""
        for i in range(len(stream)):
            self.step(i, stream)
