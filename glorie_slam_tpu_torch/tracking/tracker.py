"""Tracker loop: motion filter -> frontend -> periodic online global BA
-> mapper handshake.

Counterpart of ``glorie_slam_tpu/tracking/tracker.py``: every
``mapping.every_keyframe``-th keyframe calls ``on_keyframe`` inside a
``mapper`` phase (the synchronous ``Mapper.on_keyframe`` or
``AsyncMapper.on_keyframe``), and the end of the stream sends a final
``{"end": True}``, in the same phase (the asynchronous mapper drains its
queue there). With ``tracking.checkpoint_every`` N > 0, every N-th keyframe
calls ``checkpoint_cb(next_frame)`` (``SLAM`` saves its state there), and
``run(stream, start=)`` resumes from a checkpoint's next frame.
"""

from ..utils.phase_timer import PhaseTimer, traced
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
        # cadence counters, on the instance so that a checkpoint
        # (``utils/checkpoint.py``) captures and restores them
        self.prev_kf_idx = 0
        self.prev_ba_idx = 0
        self.number_of_kf = 0
        self.checkpoint_every = int(tcfg.get("checkpoint_every", 0) or 0)
        self.checkpoint_cb = None
        self._next = None       # (index, stream, frame) read by prefetch
        # under an edge group with a mapper: take rank 0's scale/shift rows
        # before each frame
        self.sync_scale_shift = False

    def _frame(self, stream, i):
        """(timestamp, image) of stream frame ``i``, read from the stream
        once: the prefetch of frame i keeps it for the step that tracks
        it."""
        nxt = self._next
        if nxt is not None and nxt[0] == i and nxt[1] is stream:
            return nxt[2]
        item = stream[i]
        return item[0], item[1]

    @traced("tracker.step")
    def step(self, i, stream):
        """Track stream frame ``i``: motion filter, prefetch of frame
        i + 1, frontend, online BA every ``ba_freq`` keyframes, and the
        mapper handshake."""
        timer = self.timer
        if self.sync_scale_shift:
            self.video.sync_scale_shift()
        timestamp, image = self._frame(stream, i)
        with timer.phase("motion_filter"):
            self.motion_filter.track(timestamp, image,
                                     stream.get_intrinsic())
        if i + 1 < len(stream):
            with timer.phase("prefetch"):
                frame = self._frame(stream, i + 1)
                self._next = (i + 1, stream, frame)
                self.motion_filter.prefetch(*frame)
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
            if (self.checkpoint_cb is not None and self.checkpoint_every
                    and self.number_of_kf % self.checkpoint_every == 0):
                with timer.phase("checkpoint"):
                    self.checkpoint_cb(i + 1)
        self.prev_kf_idx = curr_kf_idx
        if self.printer is not None:
            self.printer.update_pbar()

    def run(self, stream, start=0):
        """Track every frame of ``stream`` (indexable, ``len``, yielding
        (timestamp, image_hw3_01, ...), with ``get_intrinsic()``) from
        index ``start`` (a checkpoint's next frame) on."""
        for i in range(start, len(stream)):
            self.step(i, stream)
        if self.on_keyframe is not None:
            with self.timer.phase("mapper"):
                self.on_keyframe({"is_keyframe": True, "video_idx": None,
                                  "timestamp": None, "end": True})
