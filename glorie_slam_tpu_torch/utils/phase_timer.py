"""Per-phase wall time of the tracker loop.

Counterpart of ``glorie_slam_tpu/utils/phase_timer.py``, reduced to what
the tracking slice reads: totals and call counts per phase name. With ``sync`` set, each phase ends with
``torch.cuda.synchronize()`` so device work is charged to the phase that
queued it (off by default: the card then overlaps phases).
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class PhaseTimer:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.total = defaultdict(float)
        self.count = defaultdict(int)

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

    def summary(self):
        return {name: {"total_s": self.total[name],
                       "calls": self.count[name]}
                for name in sorted(self.total)}
