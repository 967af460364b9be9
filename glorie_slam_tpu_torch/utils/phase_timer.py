"""Per-phase wall time of the pipeline.

Counterpart of ``glorie_slam_tpu/utils/phase_timer.py``: totals, call
counts and per-call means per phase name, the keyframe count, and ``dump``
to ``logs/phase_times.json``. Keyframes/s over the tracking phases
(motion filter, frontend, online BA) is derived as in the JAX package.
With ``sync`` set, each phase ends with ``torch.cuda.synchronize()`` so
device work is charged to the phase that queued it (off by default: the
card then overlaps phases).
"""

import json
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

TRACK_PHASES = ("motion_filter", "frontend", "online_ba")


class PhaseTimer:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.n_keyframes = 0
        self._start = time.perf_counter()

    @contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def keyframe(self):
        self.n_keyframes += 1

    def summary(self):
        """{phase: {total_s, calls, mean_ms}}."""
        return {name: {"total_s": self.total[name], "calls": self.count[name],
                       "mean_ms": 1e3 * self.total[name]
                       / max(self.count[name], 1)}
                for name in sorted(self.total)}

    def dump(self, path, printer=None, kernel_launches=None):
        """Write the JAX package's ``phase_times.json`` layout to ``path``
        (wall, tracked and untracked seconds, keyframes, the phases, and
        keyframes/s over the tracking phases), with ``kernel_launches``
        (name -> launches) where given; print one line of it."""
        wall = time.perf_counter() - self._start
        tracked = sum(self.total.values())
        s = {"wall_s": wall, "tracked_s": tracked,
             "untracked_s": wall - tracked, "n_keyframes": self.n_keyframes,
             "phases": self.summary()}
        track_s = sum(self.total[p] for p in TRACK_PHASES)
        if self.n_keyframes and track_s > 0:
            s["keyframe_fps"] = self.n_keyframes / track_s
        if kernel_launches is not None:
            s["kernel_launches"] = kernel_launches
        with open(path, "w") as f:
            json.dump(s, f, indent=2)
        if printer is not None:
            lines = [f"{name}: {v['total_s']:.1f}s over {v['calls']} calls "
                     f"({v['mean_ms']:.1f} ms/call)"
                     for name, v in s["phases"].items()]
            if "keyframe_fps" in s:
                lines.append(f"keyframe FPS (tracking): {s['keyframe_fps']}")
            printer.print("phase times: " + "; ".join(lines),
                          subsystem="info")
        return s
