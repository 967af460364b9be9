"""Per-phase wall time of the pipeline, and the port's spans and counters.

Counterpart of ``glorie_slam_tpu/utils/phase_timer.py``: totals, call
counts and per-call means per phase name, the keyframe count, and ``dump``
to ``logs/phase_times.json``. Keyframes/s over the tracking phases
(motion filter, frontend, online BA) is derived as in the JAX package.
With ``sync`` set, each phase ends with ``torch.cuda.synchronize()`` so
device work is charged to the phase that queued it (off by default: the
card then overlaps phases).

Spans and counters record only while a ``torch.profiler`` session records,
so a run under the profiler sees them with no flag or setting of its own:

* ``span(name)`` (or ``@traced(name)`` on a function): a
  ``record_function`` range, on the clock of the device
  kernels in the profiler's trace, so each idle gap of the card is named by
  the innermost span open on the host; its host seconds (unsynchronized:
  what the host spent dispatching and waiting) and calls are summed;
* ``count(name, n)``: a counter;
* ``sync(site, n)``: a context manager around ``n`` calls that block the
  host until the card has run what is queued (a device-to-host read, or a
  copy from pageable host memory to the card, which PyTorch ends with a
  stream synchronize): span ``sync.<site>``, counted under the same name;
* ``snapshot()``: the spans' calls and host seconds and the counters.

With no session recording, each call costs one check of the profiler's
flag: no range, no clock read, no synchronize. The sums are cleared when a
new session begins (the first call that finds the profiler on after one
that found it off), so they hold one session's stretch. ``PhaseTimer.phase(name)`` opens span
``phase.<name>``.
"""

import functools
import json
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

TRACK_PHASES = ("motion_filter", "frontend", "online_ba")

_recording = torch.autograd._profiler_enabled
_spans = {}             # name -> [calls, host seconds]
_counts = {}            # name -> total
_live = False           # whether the last call found the profiler on


def _begin():
    global _live
    _live = True
    _spans.clear()
    _counts.clear()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        if not _live:
            _begin()
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        s = _spans.get(self.name)
        if s is None:
            _spans[self.name] = [1, dt]
        else:
            s[0] += 1
            s[1] += dt


_OFF = nullcontext()


def span(name):
    """Context manager: span ``name`` while a profiler session records,
    nothing otherwise."""
    global _live
    if _recording():
        return _Span(name)
    _live = False
    return _OFF


def traced(name):
    """Decorator: each call of the function inside span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, n=1):
    """Add ``n`` to counter ``name`` while a profiler session records."""
    global _live
    if _recording():
        if not _live:
            _begin()
        _counts[name] = _counts.get(name, 0) + n
    else:
        _live = False


def sync(site, n=1):
    """Context manager around ``n`` calls that block the host on the card:
    while a profiler session records, span ``sync.<site>``, with ``n``
    added to counter ``sync.<site>``; nothing otherwise."""
    global _live
    if not _recording():
        _live = False
        return _OFF
    name = "sync." + site
    count(name, n)
    return _Span(name)


def snapshot():
    """{"spans": {name: {"calls", "host_s"}}, "counts": {name: total}} of
    the last (or the current) profiler session."""
    return {"spans": {k: {"calls": c, "host_s": s}
                      for k, (c, s) in _spans.items()},
            "counts": dict(_counts)}


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
            with span("phase." + name):
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
