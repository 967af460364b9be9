"""Seeded problems for the edge-sharded path, run on one rank or on every
rank of an edge group: the tracking step, the DSPO rounds, the backend's
GRU sweep and ``Backend.dense_ba``, and a tracking-only ``SLAM.run``.

Each ``*_rank`` function builds its problem from a seed (numpy on the
host, then moved to the device), so every rank and the one-rank run start
from bitwise the same state; inside an edge group it runs sharded over the
group (``tracking.mesh_devices`` = the group's size), else on one device.
They return host numpy results with, under a group, the rank's launches of
every kernel (A-F), the bytes it received from other ranks and its seconds.
``parallel.launch.launch`` starts them by name in each rank; the tests and
``chip_smoke.py`` hold the ranks' results against the one-rank run.

A helper of the tests, not of the package: it imports no JAX, because the
spawned ranks and ``chip_smoke.py`` import it (as ``torch_drills``, with
``tests/`` on the path).
"""

import time

import numpy as np
import torch

from glorie_slam_tpu_torch.parallel import mesh

SNAP_KEYS = ("poses", "disps", "disps_up", "scale", "shift", "vmask",
             "net", "target", "weight", "damping")


def _device(device):
    g = mesh.active_group()
    return g.device if g is not None else torch.device(device)


def _mesh_devices():
    g = mesh.active_group()
    return 0 if g is None else g.world


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernels():
    from glorie_slam_tpu_torch.ops import cuda_corr, knn

    return (*cuda_corr.KERNELS, knn.KNN)


def _counters():
    g = mesh.active_group()
    if g is not None:
        g.reset_counters()
    for k in _kernels():
        k.launches = 0


def _report(out, seconds):
    g = mesh.active_group()
    out["seconds"] = seconds
    out["launches"] = {k.name: k.launches for k in _kernels()}
    out["bytes_received"] = 0 if g is None else g.bytes_received
    out["collectives"] = 0 if g is None else g.collectives
    out["rank"] = 0 if g is None else g.rank
    return out


def snapshot(video, graph, n):
    """The state the sharded path must reproduce, as host numpy."""
    def h(x):
        # a copy: on the CPU ``numpy()`` shares the tensor's memory
        return x.detach().float().cpu().numpy().copy()

    E = len(graph.ii)
    return dict(
        poses=h(video.poses[:n]), disps=h(video.disps[:n]),
        disps_up=h(video.disps_up[:n]), scale=h(video.depth_scale[:n]),
        shift=h(video.depth_shift[:n]),
        vmask=video.valid_depth_mask_small[:n].cpu().numpy().copy(),
        net=h(graph.net[:E]), target=h(graph.target[:E]),
        weight=h(graph.weight[:E]), damping=h(graph.damping[:n]),
        ii=graph.ii.copy(), jj=graph.jj.copy())


# ---------------------------------------------------------------------------
# the DSPO rounds
# ---------------------------------------------------------------------------


_STREAMS = {}


def _stream(n, H, W, trajectory):
    """The seeded synthetic stream (rendered once per process)."""
    from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream

    key = (n, H, W, trajectory)
    if key not in _STREAMS:
        _STREAMS[key] = SyntheticStream(n_frames=n, H=H, W=W, seed=5,
                                        trajectory=trajectory)
    return _STREAMS[key]


def _contiguous_args(fn):
    def call(*args, **kw):
        return fn(*[a.contiguous() if torch.is_tensor(a) else a
                    for a in args], **kw)
    return call


def rounds_state(H=64, W=96, n=6, r=2, n_inactive=2, buffer=16, seed=7,
                 device="cpu", dtype=None, batch_invariant=False):
    """A DSPO video of ``n`` frames of a synthetic walk (the first two at
    their true poses, the rest at identity, disparities with a smooth
    pattern so that the mono fit is well conditioned, mono priors at 1.5x
    depth), random features, and a graph of the temporal edges within
    ``r`` frames, the first ``n_inactive`` moved to the inactive pool.
    ``dtype``: the net's (a torch dtype or its name; None: the device's
    default). ``batch_invariant``: the net's update and GraphAgg take
    contiguous NCHW inputs. The tracker hands them channels-last views, and
    on the card cuDNN's channels-last bf16 kernels round an edge's result
    differently with the number of edges in the batch, so that a sharded
    run matches one rank only to that rounding; with contiguous inputs each
    edge's result does not depend on the batch (PERF.md §6)."""
    from glorie_slam_tpu_torch.core.depth_video import DepthVideo
    from glorie_slam_tpu_torch.core.factor_graph import FactorGraph
    from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
    from glorie_slam_tpu_torch.utils.synthetic import base_cfg

    dev = _device(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    stream = _stream(n, H, W, "walk")
    cfg = base_cfg(H=H, W=W, buffer=buffer)
    cfg["tracking"]["backend"]["BA_type"] = "DSPO"
    cfg["tracking"]["mono_thres"] = 0.1
    cfg["tracking"]["mesh_devices"] = _mesh_devices()
    video = DepthVideo(cfg, device=dev)
    tn = TrackerNet(seed=seed, device=dev, dtype=dtype)
    if batch_invariant:
        for name in ("update", "agg"):
            setattr(tn, name, _contiguous_args(getattr(tn, name)))
    rng = np.random.default_rng(seed)
    rng_pat = np.random.default_rng(99)
    h8, w8 = H // 8, W // 8

    def feat():
        x = rng.normal(size=(h8, w8, 128)).astype(np.float32) * 0.1
        return torch.as_tensor(x, device=dev)

    for t in range(n):
        pat = rng_pat.random((H, W)).astype(np.float32)
        for _ in range(3):
            pat = (np.roll(pat, 1, 0) + np.roll(pat, -1, 0)
                   + np.roll(pat, 1, 1) + np.roll(pat, -1, 1) + pat) / 5.0
        disp_full = (1.0 / stream.depths[t]) * (1.0 + 0.8 * pat)
        mono = 1.0 / (disp_full / 1.5)
        video.append(
            t, (stream.frames[t] * 255).astype(np.uint8),
            stream.poses_w2c[t] if t < 2 else None,
            disp_full[3::8, 3::8], mono, stream.intrinsics / 8.0,
            feat(), feat(), feat())
    graph = FactorGraph(video, tn, max_factors=8 * n)
    graph.add_neighborhood_factors(0, n, r=r)
    graph.rm_factors(np.arange(len(graph.ii)) < n_inactive, store=True)
    return video, graph


def rounds_rank(spec):
    """``graph_update_rounds`` on ``rounds_state(**spec["state"])``:
    spec["rounds"] rounds, DSPO alternation when spec["alternate"]."""
    from glorie_slam_tpu_torch.tracking.fused import graph_update_rounds

    video, graph = rounds_state(**spec["state"])
    dev = video.device
    _sync(dev)
    _counters()
    t0 = time.perf_counter()
    graph_update_rounds(graph, spec["rounds"], use_inactive=True,
                        alternate=spec["alternate"])
    _sync(dev)
    seconds = time.perf_counter() - t0
    out = snapshot(video, graph, spec["state"]["n"])
    out = {k: v for k, v in out.items() if k in spec.get("keys", out)}
    out = _report(out, seconds)
    out["edges"] = len(graph.ii)
    return out


# ---------------------------------------------------------------------------
# the backend: GRU sweep and dense_ba
# ---------------------------------------------------------------------------


def backend_state(H=64, W=96, n=24, buffer=32, seed=1, device="cpu",
                  dtype=None):
    """A DSPO video of ``n`` keyframes of a synthetic circuit at their true
    poses and depths (mono priors at the true depths), random features."""
    from glorie_slam_tpu_torch.core.depth_video import DepthVideo
    from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
    from glorie_slam_tpu_torch.utils.synthetic import base_cfg

    dev = _device(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    stream = _stream(n, H, W, "circuit")
    cfg = base_cfg(H=H, W=W, buffer=buffer)
    cfg["tracking"]["backend"]["BA_type"] = "DSPO"
    cfg["tracking"]["mesh_devices"] = _mesh_devices()
    video = DepthVideo(cfg, device=dev)
    rng = np.random.default_rng(seed)
    h8, w8 = H // 8, W // 8

    def feat():
        x = rng.normal(size=(h8, w8, 128)).astype(np.float32) * 0.1
        return torch.as_tensor(x, device=dev)

    for t in range(n):
        depth = stream.depths[t]
        video.append(t, (stream.frames[t] * 255).astype(np.uint8),
                     stream.poses_w2c[t], 1.0 / depth[3::8, 3::8], depth,
                     stream.intrinsics / 8.0, feat(), feat(), feat())
    return cfg, video, TrackerNet(seed=seed, device=dev, dtype=dtype)


def sweep_rank(spec):
    """One ``update_lowmem`` GRU sweep (its BA left out) over the backend's
    proximity edges of ``backend_state(**spec["state"])``."""
    from glorie_slam_tpu_torch.core.factor_graph import FactorGraph

    cfg, video, tn = backend_state(**spec["state"])
    b = cfg["tracking"]["backend"]
    n = video.counter
    graph = FactorGraph(video, tn)
    graph.add_backend_proximity_factors(
        0, n, b["nms"], b["radius"], b["thresh"], (b["radius"] + 2) * 2 * n,
        cfg["tracking"]["beta"])
    video.ba = lambda *a, **k: None
    _counters()
    t0 = time.perf_counter()
    graph.update_lowmem(t0=1, t1=n, steps=1)
    _sync(video.device)
    return _report(snapshot(video, graph, n), time.perf_counter() - t0)


def dense_ba_rank(spec):
    """``Backend.dense_ba(steps=spec["steps"])`` on
    ``backend_state(**spec["state"])``."""
    from glorie_slam_tpu_torch.tracking.backend import Backend

    cfg, video, tn = backend_state(**spec["state"])
    backend = Backend(tn, video, cfg)
    _sync(video.device)
    _counters()
    t0 = time.perf_counter()
    n, n_edges = backend.dense_ba(steps=spec["steps"])
    _sync(video.device)
    seconds = time.perf_counter() - t0
    h = video.counter
    out = dict(poses=video.poses[:h].cpu().numpy().copy(),
               disps=video.disps[:h].cpu().numpy().copy(),
               disps_up=video.disps_up[:h].cpu().numpy().copy(),
               n_edges=n_edges)
    return _report(out, seconds)


# ---------------------------------------------------------------------------
# the tracking step and a whole run
# ---------------------------------------------------------------------------


def step_rank(inputs):
    """``parallel.step.tracking_step`` on host inputs: ``inputs`` holds the
    net's state dict (numpy), ``fmaps`` (N,h,w,128) for the lookup stores
    and the step's arrays (see ``tracking_step``)."""
    from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
    from glorie_slam_tpu_torch.ops import corr as corr_mod
    from glorie_slam_tpu_torch.parallel.step import tracking_step

    dev = _device(inputs.get("device", "cpu"))
    dtype = inputs.get("dtype", torch.float32)
    tn = TrackerNet({k: torch.as_tensor(v) for k, v in
                     inputs["state_dict"].items()}, dtype=dtype, device=dev)

    def t(name, dt=torch.float32):
        return torch.as_tensor(inputs[name], dtype=dt, device=dev)

    fmaps = t("fmaps", torch.bfloat16)
    N, h, w, C = fmaps.shape
    levels = []
    for p in corr_mod.pool_feat_levels(fmaps):
        hl, wl = levels[-1].shape[1:3] if levels else (h, w)
        levels.append(p[:, :hl // 2, :wl // 2])
    feat_pyr = (fmaps.reshape(N, h * w, C),) + tuple(levels)
    _counters()
    t0 = time.perf_counter()
    out = tracking_step(
        tn, t("poses"), t("disps"), t("intrinsics"), feat_pyr,
        t("net", torch.bfloat16), t("inp", torch.bfloat16), t("target"),
        t("eta"), t("sensor_disps"), inputs["ii"], inputs["jj"],
        inputs["t0"], inputs["t1"], inputs["kbase"], P_max=inputs["P_max"],
        K_max=inputs["K_max"], iters=inputs.get("iters", 2),
        group=mesh.active_group())
    _sync(dev)
    names = ("poses", "disps", "net", "target", "weight", "eta_agg",
             "upmask")
    res = {k: v.detach().float().cpu().numpy() for k, v in zip(names, out)}
    return _report(res, time.perf_counter() - t0)


def slam_rank(spec):
    """A tracking-only ``SLAM.run`` on a synthetic stream: spec holds
    ``n_frames``, ``H``, ``W``, ``out`` (the output root), ``tracking``
    overrides, and optionally ``config`` ("base": ``base_cfg``, or
    "bench": bench.py's tracking config with the final BA and true-depth
    priors cached under ``out``, as ``chip_smoke.pipeline`` runs it),
    ``stream`` (``SyntheticStream`` keywords), ``device`` and
    ``batch_invariant`` (the net's update and GraphAgg take contiguous
    NCHW inputs, as in ``rounds_state``). Returns the
    state at the end of tracking, the poses and disparities after the
    final BA, and the frames at which the last loop closure and online BA
    ran."""
    import os

    from glorie_slam_tpu_torch.slam import SLAM
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       base_cfg, bench_cfg)

    H, W = spec["H"], spec["W"]
    stream = SyntheticStream(n_frames=spec["n_frames"], H=H, W=W,
                             **spec.get("stream", {"seed": 3}))
    if spec.get("config", "base") == "bench":
        cfg = bench_cfg(H=H, W=W, buffer=2 * spec["n_frames"] + 16,
                        out=spec["out"])
        cfg["tracking"]["backend"]["final_ba"] = True
        cfg["mono_prior"] = {"predict_online": False}
        priors = os.path.join(spec["out"], f"{cfg['scene']}_priors",
                              "depths")
        os.makedirs(priors, exist_ok=True)
        for i, depth in enumerate(stream.depths):
            # every rank writes the same files, each whole by its rename
            tmp = os.path.join(priors, f".{i:05d}.{os.getpid()}.npy")
            np.save(tmp, depth)
            os.replace(tmp, os.path.join(priors, f"{i:05d}.npy"))
    else:
        cfg = base_cfg(H=H, W=W, buffer=2 * spec["n_frames"] + 16,
                       out=spec["out"])
    cfg["tracking"].update(spec.get("tracking", {}))
    cfg["tracking"]["mesh_devices"] = _mesh_devices()
    slam = SLAM(cfg, stream, device=spec.get("device", "cpu"))
    if spec.get("batch_invariant"):
        tn = slam.tracker_net
        for name in ("update", "agg"):
            setattr(tn, name, _contiguous_args(getattr(tn, name)))
    v, g = slam.video, slam.tracker.frontend.graph
    out = {}
    terminate = slam.terminate

    def snap_then_terminate():
        # the state at the end of tracking, before rank 0's filler writes
        # its scratch rows
        out.update(snapshot(v, g, v.counter), n_keyframes=v.counter,
                   timestamps=v.timestamp[:v.counter].cpu().numpy())
        terminate()

    slam.terminate = snap_then_terminate
    _sync(v.device)
    _counters()
    t0 = time.perf_counter()
    slam.run()
    _sync(v.device)
    seconds = time.perf_counter() - t0
    out.update(final_poses=v.poses[:v.counter].cpu().numpy().copy(),
               final_disps=v.disps[:v.counter].cpu().numpy().copy(),
               loop_closure_at=slam.tracker.frontend.last_loop_t,
               online_ba_at=slam.tracker.prev_ba_idx)
    return _report(out, seconds)


def _deterministic(fn, spec):
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn(spec)
    finally:
        torch.use_deterministic_algorithms(False)


def card_drill(spec):
    """The sharded phase of ``chip_smoke.py`` on one rank (the CPU tests
    batch their drills through it too). ``spec["timed"]`` and
    ``spec["checks"]`` map names to (kind, spec), kind one of "rounds",
    "dense_ba", "sweep", "step" and "slam" (the ``*_rank`` functions).
    Each timed one runs three times from its seeded state: cold (the first call),
    warm (timed), and under ``torch.use_deterministic_algorithms``
    (``index_add_`` on the card otherwise sums in atomic order, so two runs
    of one rank differ); each check runs deterministic only. The
    deterministic results are the ones held against other rank counts."""
    import os

    # cuBLAS needs this before its first handle to run deterministically
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    kinds = {"rounds": rounds_rank, "dense_ba": dense_ba_rank,
             "sweep": sweep_rank, "step": step_rank, "slam": slam_rank}
    out = {}
    for name, (kind, sub) in spec.get("timed", {}).items():
        fn = kinds[kind]
        cold = fn(sub)
        warm = fn(sub)
        out[name] = dict(cold_s=cold["seconds"], warm=warm,
                         det=_deterministic(fn, sub))
    for name, (kind, sub) in spec.get("checks", {}).items():
        out[name] = dict(det=_deterministic(kinds[kind], sub))
    return out
