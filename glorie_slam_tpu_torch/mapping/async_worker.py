"""Tracking and mapping overlap: a worker thread runs the mapper off the
tracking path.

Counterpart of ``glorie_slam_tpu/mapping/async_worker.py``. The tracker
calls ``AsyncMapper.on_keyframe`` where it would call
``Mapper.on_keyframe``; the call takes a snapshot of the video and queues
the job; the worker maps against the snapshot while tracking goes on.

The JAX package's snapshot holds references, which is enough there because
JAX arrays are immutable. This port's ``DepthVideo`` updates its tensors in
place, so ``VideoSnapshot`` clones what the mapper reads: the first
``counter + 5`` rows (the depth filter's farthest neighbour) of the poses,
full-resolution disparities, timestamps, mono scale and shift and validity
mask, the intrinsics and the stale-mask flags. It clones on the tracker's
CUDA stream and records an event; the worker runs every job on a stream of
its own that first waits for that event, and synchronises it when the job
ends, so a job's work is done before its snapshot is freed or the next job
starts. On the CPU the snapshot is the same clone, without streams.

``npc_dirty`` stays aliased to the live video, as in the JAX package: the
tracker sets the flags, the mapper clears them after a deform.
``VideoSnapshot.set_depth_scale_shift`` writes the snapshot's row and the
live video's row, under the video's lock and on the tracker's stream.
"""

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from ..core.depth_video import DepthVideo, valid_mask_update
from ..ops.depth_filter import NEIGH_OFFSETS


def _on_stream(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class VideoSnapshot:
    """The mapper's read view of a ``DepthVideo`` at one instant."""

    def __init__(self, video):
        self._live = video
        self.cfg = video.cfg
        self.device = video.device
        self.counter = video.counter
        self.down_scale = video.down_scale
        rows = min(video.counter + max(NEIGH_OFFSETS), video.buffer)
        cuda = video.device.type == "cuda"
        self.track_stream = torch.cuda.current_stream(video.device) \
            if cuda else None
        with torch.no_grad():
            self.poses = video.poses[:rows].clone()
            self.disps_up = video.disps_up[:rows].clone()
            self.intrinsics = video.intrinsics.clone()
            self.timestamp = video.timestamp[:rows].clone()
            self.depth_scale = video.depth_scale[:rows].clone()
            self.depth_shift = video.depth_shift[:rows].clone()
            self._valid_depth_mask = video._valid_depth_mask[:rows].clone()
        self.dirty = video.dirty[:rows].copy()
        self.npc_dirty = video.npc_dirty
        self.ready = None
        if cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(self.track_stream)

    @property
    def valid_depth_mask(self):
        """Full-resolution multiview mask over the snapshot's poses and
        disparities, refreshed on read for its stale rows."""
        dirty_index = np.flatnonzero(self.dirty)
        if len(dirty_index):
            mv = self.cfg["tracking"]["multiview_filter"]
            idx = torch.as_tensor(dirty_index, device=self.device)
            self._valid_depth_mask[idx] = valid_mask_update(
                self.poses, self.disps_up, self.intrinsics * self.down_scale,
                idx, float(mv["thresh"]), int(mv["visible_num"]))
            self.dirty[dirty_index] = False
        return self._valid_depth_mask

    def get_pose_c2w(self, index):
        return DepthVideo.get_pose_c2w(self, index)

    def get_depth_and_pose(self, index):
        return DepthVideo.get_depth_and_pose(self, index)

    def use_on(self, stream):
        """Make ``stream`` wait for the clone, and keep the clones' memory
        from reuse until the work queued on ``stream`` is done."""
        stream.wait_event(self.ready)
        for t in (self.poses, self.disps_up, self.intrinsics, self.timestamp,
                  self.depth_scale, self.depth_shift, self._valid_depth_mask):
            t.record_stream(stream)

    def set_depth_scale_shift(self, ix, s, q):
        self.depth_scale[ix] = s
        self.depth_shift[ix] = q
        with _on_stream(self.track_stream):
            self._live.set_depth_scale_shift(ix, s, q)


class AsyncMapper:
    """A bounded job queue and a worker thread around ``Mapper.on_keyframe``.

    The queue holds ``queue_size`` jobs (default 2: one running, one
    waiting), so the tracker waits only when mapping falls a whole mapped
    keyframe behind. The ``end`` handshake drains the queue and joins the
    thread. A worker exception is raised on the tracker's thread at the next
    handshake, ``quiesce`` or ``join``.

    ``stats``: ``mapped`` jobs done, ``busy_s`` worker seconds inside jobs,
    ``lag_s`` the delay from each snapshot to its job's start, ``block_s``
    tracker seconds spent waiting on a full queue (the put alone; the
    snapshot's clone is not counted as waiting).
    """

    def __init__(self, mapper, video, queue_size=2, printer=None):
        self.mapper = mapper
        self.video = video
        self.printer = printer
        self.stream = (torch.cuda.Stream(video.device)
                       if video.device.type == "cuda" else None)
        self._q = queue.Queue(maxsize=queue_size)
        self._exc = None
        self.stats = {"mapped": 0, "busy_s": 0.0, "lag_s": [],
                      "block_s": 0.0}
        self._thread = threading.Thread(target=self._run,
                                        name="mapper-worker", daemon=True)
        self._thread.start()

    def _raise_pending(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def on_keyframe(self, frame_info):
        self._raise_pending()
        if frame_info.get("end"):
            self.join()
            return
        snap = VideoSnapshot(self.video)
        t0 = time.perf_counter()
        self._q.put((frame_info, snap, t0))
        self.stats["block_s"] += time.perf_counter() - t0

    def quiesce(self):
        """Wait until every queued job is done; the worker stays alive."""
        self._q.join()
        self._raise_pending()

    def join(self):
        """Drain the queue and stop the worker (idempotent)."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self._raise_pending()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            frame_info, snap, t_snap = item
            t_start = time.perf_counter()
            self.stats["lag_s"].append(t_start - t_snap)
            live = self.mapper.video
            self.mapper.video = snap
            try:
                with _on_stream(self.stream):
                    if self.stream is not None:
                        snap.use_on(self.stream)
                    self.mapper.on_keyframe(frame_info)
                    if self.stream is not None:
                        self.stream.synchronize()
                self.stats["mapped"] += 1
            except Exception as e:  # noqa: BLE001 - raised on the tracker
                self._exc = e
                if self.printer is not None:
                    self.printer.print(f"mapper worker failed: {e!r}",
                                       subsystem="error")
            finally:
                self.stats["busy_s"] += time.perf_counter() - t_start
                self.mapper.video = live
                item = snap = None
                self._q.task_done()
