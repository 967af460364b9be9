"""Endurance run of the port on a long synthetic stream.

    python -m glorie_slam_tpu_torch.tools.long_run_synthetic [n_frames]
        [out_dir] [--mapping] [--map-light] [--every-kf K] [--device cpu]

Counterpart of ``scripts/long_run_synthetic.py``. Tracks ``n_frames``
(default 420) frames of a 240x320 synthetic stream (ScanNet's operating
size: a 30x40 grid at 1/8) through the tracker loop (``Tracker.run``:
motion filter with lookahead, frontend with loop closure, online global BA
every 20 keyframes; with ``--mapping`` the mapper's handshake every K-th
keyframe, on its worker thread), then the final global BA and
``video.npz``. Every frame is admitted (motion-filter and keyframe
thresholds 0); the mono priors are the stream's true depths, fed through
the motion filter. ``--map-light`` cuts each mapped keyframe to 60
iterations (80 for the first), 300 / 500 pixels and 65,536 points: the run
measures what the worker costs the tracker, not the map's quality.

Writes ``{out_dir}/test/synth/logs/phase_times.json`` and
``logs/long_run.json``:

* the JAX report's keys that still mean something: ``n_frames``,
  ``mapping``, ``every_kf``, ``n_keyframes``, ``wall_s`` (the tracker loop),
  ``keyframe_fps`` (over the motion filter, frontend and online BA) and
  ``tracking_only_kf_fps`` (the prefetch counted too);
* ``device`` and ``peak_device_bytes`` (``torch.cuda.max_memory_allocated``
  over the run; None on the CPU);
* ``kf_series``: one row per 20 frames, with the keyframes, ``counter``,
  the window's wall seconds (host clock after the tracker's stream
  synchronises), its KF/s over the tracking phases and each phase's
  seconds in it (``PhaseTimer``, unsynchronised as in the pipeline: device
  work lands in the phase that waits for it). Whether tracking slows as the
  graph grows shows here;
* with ``--mapping``: ``mapper_overlap`` (``AsyncMapper.stats`` as the JAX
  report has them) and ``snapshot`` (``SnapshotProbe``: the bytes each
  handshake's ``VideoSnapshot`` clones and the clone's time on the
  tracker's stream).

Not ported: the JAX script's compile capture (``jax_log_compiles``), its
bucket-ladder warm-up (``--no-warm``, ``warm_ladder``) and ``live_bytes``.
They are XLA machinery, which the port leaves out (ROADMAP, North star).

Runs on the card unless ``--device cpu``; without a card it raises.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..mapping import async_worker
from ..ops import cuda_corr
from ..ops.depth_filter import NEIGH_OFFSETS
from ..slam import SLAM
from ..utils.phase_timer import TRACK_PHASES
from ..utils.synthetic import SyntheticStream, base_cfg, small_mapping_cfg

WINDOW = 20                   # frames per row of the KF/s series
REPLICA_HW = (680, 1200)      # Replica's frames, for the snapshot arithmetic
REPLICA_KEYFRAMES = 300


class SnapshotProbe:
    """While active, wraps ``async_worker.VideoSnapshot`` (the name
    ``AsyncMapper.on_keyframe`` calls) so that each handshake's snapshot
    records the bytes of the tensors it cloned and the clone's time: CUDA
    events on the tracker's stream on the card, the host clock on the
    CPU."""

    def __init__(self, H, W):
        self.hw = (H, W)
        # (rows, bytes, bytes per row, bytes per row at REPLICA_HW)
        self.snaps = []
        self._events = []         # (start, end) CUDA events
        self.host_ms = []

    def __enter__(self):
        probe, base = self, async_worker.VideoSnapshot

        class TimedSnapshot(base):
            def __init__(self, video):
                probe._start(video)
                super().__init__(video)
                probe._stop(self)

        self._base = base
        async_worker.VideoSnapshot = TimedSnapshot
        return self

    def __exit__(self, *exc):
        async_worker.VideoSnapshot = self._base

    def _start(self, video):
        self._cuda = video.device.type == "cuda"
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events.append((start, None))
        self._t0 = time.perf_counter()

    def _stop(self, snap):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events[-1] = (self._events[-1][0], end)
        self.host_ms.append(1e3 * (time.perf_counter() - self._t0))
        cloned = [t for t in vars(snap).values()
                  if isinstance(t, torch.Tensor)]
        rows = len(snap.timestamp)
        scale = REPLICA_HW[0] * REPLICA_HW[1] / (self.hw[0] * self.hw[1])
        per_row = replica_row = 0.0
        for t in cloned:
            if t.dim() and t.shape[0] == rows:
                row = t[0].nbytes
                per_row += row
                replica_row += row * (scale if tuple(t.shape[1:3])
                                      == self.hw else 1)
        self.snaps.append((rows, sum(t.nbytes for t in cloned), per_row,
                           replica_row))

    def summary(self):
        """Per-handshake bytes and clone ms, their means and largest, the
        bytes per row, and the arithmetic extrapolation to Replica's
        680x1200 frames at 300 keyframes (rows = keyframes + the depth
        filter's farthest neighbour, as ``VideoSnapshot`` takes)."""
        if not self.snaps:
            return None
        if self._events:
            torch.cuda.synchronize()
            ms = [s.elapsed_time(e) for s, e in self._events]
            timer = "cuda_events_on_tracker_stream"
        else:
            ms, timer = list(self.host_ms), "host_clock"
        nbytes = [s[1] for s in self.snaps]
        row_bytes = self.snaps[-1][2]
        replica_row = self.snaps[-1][3]
        fixed = self.snaps[-1][1] - self.snaps[-1][0] * row_bytes
        rows = REPLICA_KEYFRAMES + max(NEIGH_OFFSETS)
        return {
            "handshakes": len(self.snaps), "rows": [s[0] for s in self.snaps],
            "bytes": nbytes, "bytes_mean": float(np.mean(nbytes)),
            "bytes_max": max(nbytes), "bytes_per_row": row_bytes,
            "clone_ms": ms, "clone_ms_mean": float(np.mean(ms)),
            "clone_ms_max": max(ms), "clone_timer": timer,
            "host_ms_mean": float(np.mean(self.host_ms)),
            "replica_680x1200_300kf_bytes_arithmetic":
                fixed + rows * replica_row,
        }


def long_run_cfg(n_frames, H, W, out, mapping=False, map_light=False,
                 every_kf=1):
    """The JAX script's config: ``tests/synthetic.base_cfg`` (here
    ``base_cfg`` with ``small_mapping_cfg``) and its tracking settings."""
    cfg = base_cfg(H=H, W=W, buffer=min(600, n_frames + 40), out=out)
    cfg.update(small_mapping_cfg())
    cfg["only_tracking"] = not mapping
    cfg["mapping"]["every_keyframe"] = every_kf
    if map_light:
        cfg["mapping"].update(dict(iters=60, iters_first=80, pixels=300,
                                   pixels_adding=500))
        cfg["pointcloud"]["capacity"] = 65536
    tc = cfg["tracking"]
    tc["warmup"] = 8
    tc["max_age"] = 50
    tc["motion_filter"]["thresh"] = 0.0
    tc["multiview_filter"] = {"thresh": 0.01, "visible_num": 2}
    tc["frontend"].update(dict(
        enable_loop=True, enable_online_ba=True, keyframe_thresh=0.0,
        thresh=25.0, window=25, radius=2, nms=1, max_factors=75))
    tc["backend"].update(dict(
        ba_freq=20, final_ba=True, loop_window=25, loop_nms=12,
        BA_type="DSPO", normalize=True))
    return cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def long_run(n_frames=420, out="output/long_run", mapping=False,
             map_light=False, every_kf=1, H=240, W=320, device=None,
             window=WINDOW):
    """Run the endurance run (see the module doc) and return its report,
    also written to ``{output}/logs/long_run.json``: one row of
    ``kf_series`` per ``window`` frames, each printed as it closes."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=7,
                             motion_scale=0.015)
    print(f"[long-run] stream built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = long_run_cfg(n_frames, H, W, out, mapping, map_light, every_kf)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    slam = SLAM(cfg, stream, device=dev)
    slam.tracker.motion_filter.mono_predictor = \
        lambda ts, img: stream.depths[int(ts)]
    timer, video = slam.timer, slam.video
    launches0 = {k.name: k.launches for k in cuda_corr.KERNELS}

    series, last = [], {"t": None, "kf": 0, "phases": {}, "frame": 0}
    update_pbar = slam.printer.update_pbar

    def window_hook(n=1):
        last["frame"] += 1
        if last["frame"] % window == 0:
            _sync(dev)
            now = time.perf_counter()
            phases = {k: timer.total[k] - last["phases"].get(k, 0.0)
                      for k in timer.total}
            tracked = sum(phases.get(k, 0.0) for k in TRACK_PHASES)
            kfs = timer.n_keyframes - last["kf"]
            series.append({
                "frame": last["frame"], "counter": video.counter,
                "keyframes": kfs, "wall_s": now - last["t"],
                "kf_per_s": kfs / tracked if tracked > 0 else None,
                "phases_s": phases})
            last.update(t=now, kf=timer.n_keyframes,
                        phases=dict(timer.total))
            print(f"[long-run] frame {last['frame']}/{n_frames}  kf="
                  f"{video.counter}  {series[-1]['kf_per_s'] or 0:.2f} KF/s "
                  f"over the last {window} frames", flush=True)
        update_pbar(n)

    slam.printer.update_pbar = window_hook
    probe = SnapshotProbe(H, W)
    _sync(dev)
    t_run = last["t"] = time.perf_counter()
    with probe:
        slam.tracker.run(stream)
    _sync(dev)
    wall = time.perf_counter() - t_run

    timer.sync = True
    with timer.phase("final_ba"):
        slam.final_ba()
    with timer.phase("save_video"):
        video.save_video(f"{slam.output}/video.npz")
    launches = {k.name: k.launches - launches0[k.name]
                for k in cuda_corr.KERNELS}
    summary = timer.dump(f"{slam.output}/logs/phase_times.json",
                         kernel_launches=launches)
    tracked_s = sum(timer.total.get(k, 0.0)
                    for k in (*TRACK_PHASES, "prefetch"))
    report = {
        "n_frames": n_frames, "mapping": mapping, "every_kf": every_kf,
        "n_keyframes": video.counter, "wall_s": wall,
        "keyframe_fps": summary.get("keyframe_fps"),
        "tracking_only_kf_fps": video.counter / max(tracked_s, 1e-9),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "kf_series": series,
    }
    if mapping and slam.async_mapper is not None:
        st = slam.async_mapper.stats
        lags = st["lag_s"]
        report["mapper_overlap"] = {
            "mapped_keyframes": st["mapped"],
            "mapper_busy_s": st["busy_s"],
            # optimisation steps/s while the worker was busy (iterations
            # per mapped keyframe from the config)
            "mapper_steps_per_s": (st["mapped"] * cfg["mapping"]["iters"]
                                   / max(st["busy_s"], 1e-9)),
            "snapshot_lag_s_mean": float(np.mean(lags)) if lags else None,
            "snapshot_lag_s_max": float(np.max(lags)) if lags else None,
            "tracker_blocked_s": st["block_s"],
        }
        report["snapshot"] = probe.summary()
    with open(f"{slam.output}/logs/long_run.json", "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="endurance run of glorie_slam_tpu_torch on a long "
                    "synthetic stream")
    ap.add_argument("n_frames", nargs="?", type=int, default=420)
    ap.add_argument("out_dir", nargs="?", default="output/long_run")
    ap.add_argument("--mapping", action="store_true")
    ap.add_argument("--map-light", action="store_true")
    ap.add_argument("--every-kf", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu on request)")
    args = ap.parse_args(argv)
    report = long_run(args.n_frames, args.out_dir, mapping=args.mapping,
                      map_light=args.map_light, every_kf=args.every_kf,
                      device=args.device)
    print("[long-run]", json.dumps(
        {k: v for k, v in report.items() if k != "kf_series"}), flush=True)
    return report


if __name__ == "__main__":
    main()
