"""Port parity: the tracking-only ``SLAM.run`` and what it adds to the
tracking slice (Sim(3) alignment, the trajectory filler, the evaluation
files), plus the oracle-flow convergence check of the geometry.

* ``umeyama_alignment`` / ``ate_rmse`` are numpy on both sides: equal to
  1e-10.
* ``PoseTrajectoryFiller._fill`` against the JAX package's on identical
  keyframe state and identical float32 weights. The port refreshes the
  scratch slots' lookup stores before correlating; the JAX filler does
  not, so its side writes them first through its own video's ``fmaps``
  and ``_update_corr_stores`` (the JAX package is not edited). 12
  recurrent motion-only updates then differ only in float32 order: poses
  read 2.6e-5 apart on the CPU, held to 2.5e-4. A second JAX run on a
  fresh video (zero store rows past the counter) pins that the refresh
  matters: it lands 8.9e-2 away, held to more than 1e-2.
* The whole ``SLAM.run`` at 64x96 is checked for structure (files,
  shapes, finite ATEs, the counter restored after the filler): random
  weights make whole runs chaotic, so their numbers are held against the
  JAX package by the unit checks here and by ``test_torch_tracker.py``.
* Oracle flow (ground-truth correspondences in place of the GRU) must
  drive the port's graph and BA to the true trajectory: ATE < 0.02.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.core.depth_video import DepthVideo as JVideo
from glorie_slam_tpu.geom import alignment as jalign
from glorie_slam_tpu.nets import droid_net as jdroid
from glorie_slam_tpu.nets.tracker_net import TrackerNet as JNet
from glorie_slam_tpu.tracking.trajectory_filler import \
    PoseTrajectoryFiller as JFiller
from glorie_slam_tpu_torch.core.depth_video import DepthVideo
from glorie_slam_tpu_torch.core.factor_graph import FactorGraph
from glorie_slam_tpu_torch.geom import alignment, lie, projective
from glorie_slam_tpu_torch.nets.import_flax import flax_params_to_state_dict
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.slam import SLAM
from glorie_slam_tpu_torch.tracking.trajectory_filler import \
    PoseTrajectoryFiller
from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                   base_cfg, bench_cfg,
                                                   mapping_cfg)
from synthetic import SyntheticStream as JStream, base_cfg as jbase_cfg

H, W = 64, 96


def test_umeyama_and_ate_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 20))
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    y = 1.7 * q @ x + rng.normal(size=(3, 1)) + 0.01 * rng.normal(
        size=(3, 20))
    for with_scale in (True, False):
        for a, b in zip(alignment.umeyama_alignment(x, y, with_scale),
                        jalign.umeyama_alignment(x, y, with_scale)):
            np.testing.assert_allclose(a, b, atol=1e-10)
    rmse, stats, aligned = alignment.ate_rmse(x.T, y.T)
    jrmse, jstats, jaligned = jalign.ate_rmse(x.T, y.T)
    assert abs(rmse - jrmse) < 1e-10 and stats.keys() == jstats.keys()
    np.testing.assert_allclose(aligned, jaligned, atol=1e-10)


# ---------------------------------------------------------------------------
# trajectory filler
# ---------------------------------------------------------------------------

KF_TIMES = (0, 2, 4, 6)
FILL_TIMES = [1, 2, 3, 5, 7]


def _bf16_state(update_apply):
    def apply(params, *args, **kw):
        out = update_apply(params, *args, **kw)
        return (out[0].astype(jnp.bfloat16),) + tuple(out[1:])
    return apply


@pytest.fixture(scope="module")
def filled():
    """(port poses, port counter after, JAX refreshed, JAX fresh)."""
    stream = JStream(n_frames=8, H=H, W=W, seed=5)
    jn = JNet(seed=1, dtype=jnp.float32)
    jn.update_apply = _bf16_state(jn.update_apply)
    pn = TrackerNet(flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jn.params)),
        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    state = [(rng.normal(size=(3, H // 8, W // 8, 128)) * 0.5).astype(
        np.float32) for _ in KF_TIMES]
    images = [stream.frames[t] for t in FILL_TIMES]

    def jax_video():
        v = JVideo(jbase_cfg(H=H, W=W, buffer=16))
        for t, (fm, nt, ip) in zip(KF_TIMES, state):
            v.append(t, jnp.asarray((stream.frames[t] * 255).astype(
                np.uint8)), jnp.asarray(stream.poses_w2c[t]),
                jnp.asarray(1.0 / stream.depths[t][3::8, 3::8]), None,
                stream.intrinsics / 8.0, jnp.asarray(fm), jnp.asarray(nt),
                jnp.asarray(ip))
        return v

    pv = DepthVideo(base_cfg(H=H, W=W, buffer=16), device="cpu")
    for t, (fm, nt, ip) in zip(KF_TIMES, state):
        pv.append(t, (stream.frames[t] * 255).astype(np.uint8),
                  np.array(stream.poses_w2c[t]),
                  1.0 / stream.depths[t][3::8, 3::8],
                  None, stream.intrinsics / 8.0, torch.as_tensor(fm),
                  torch.as_tensor(nt), torch.as_tensor(ip))
    port = PoseTrajectoryFiller(pn, pv)._fill(FILL_TIMES, images,
                                               stream.intrinsics)

    jv = jax_video()
    N, M = jv.counter, len(FILL_TIMES)
    feats = jn.features(jdroid.normalize_images(jnp.stack(images)))
    jv.fmaps = jv.fmaps.at[N:N + M].set(feats.astype(jnp.bfloat16))
    for ix in range(N, N + M):
        jv._update_corr_stores(ix)
    refreshed = JFiller(jn, jv)._fill(FILL_TIMES, images, stream.intrinsics)
    fresh = JFiller(jn, jax_video())._fill(FILL_TIMES, images,
                                           stream.intrinsics)
    return port, pv.counter, np.asarray(refreshed), np.asarray(fresh)


def test_filler_matches_jax_with_refreshed_stores(filled):
    port, counter, refreshed, _ = filled
    assert counter == len(KF_TIMES)
    assert port.shape == (len(FILL_TIMES), 7)
    np.testing.assert_allclose(port, refreshed, atol=2.5e-4)


def test_filler_store_refresh_changes_the_result(filled):
    """The JAX filler on a fresh video correlates its scratch frames
    against zero store rows: its poses differ from the port's and from the
    JAX filler's with refreshed rows by far more than their agreement."""
    port, _, refreshed, fresh = filled
    assert np.abs(fresh - port).max() > 1e-2
    assert np.abs(fresh - refreshed).max() > 1e-2


def test_filler_raises_near_capacity():
    """Twin of tests/test_guards.py's: the scratch slots must fit in the
    buffer, with an error that names tracking.buffer."""
    stream = SyntheticStream(n_frames=8, H=H, W=W, seed=5)
    video = DepthVideo(base_cfg(H=H, W=W, buffer=8), device="cpu")
    z = torch.zeros((H // 8, W // 8, 128))
    for t in range(6):
        video.append(t, (stream.frames[t] * 255).astype(np.uint8),
                     stream.poses_w2c[t], 1.0 / stream.depths[t][3::8, 3::8],
                     None, stream.intrinsics / 8.0, z, z, z)
    filler = PoseTrajectoryFiller(TrackerNet(device="cpu"), video)
    with pytest.raises(ValueError, match="tracking.buffer"):
        filler._fill([0.5, 1.5, 2.5, 3.5],
                     [stream.frames[t] for t in range(4)],
                     stream.intrinsics)
    assert video.counter == 6


# ---------------------------------------------------------------------------
# the whole tracking-only run
# ---------------------------------------------------------------------------

def test_slam_run_tracking_only(tmp_path):
    n_frames = 12
    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=3,
                             motion_scale=0.02, trajectory="circuit")
    cfg = bench_cfg(H=H, W=W, buffer=32, out=str(tmp_path))
    tc = cfg["tracking"]
    tc["warmup"] = 4
    tc["frontend"].update(window=5, max_factors=48)
    tc["backend"].update(final_ba=True, ba_freq=3, loop_window=5,
                         loop_nms=2)
    cfg["mono_prior"] = {"predict_online": False}
    priors = tmp_path / "synth_priors" / "depths"
    priors.mkdir(parents=True)
    for i, d in enumerate(stream.depths):
        np.save(priors / f"{i:05d}.npy", d)

    slam = SLAM(cfg, stream, device="cpu")
    slam.run()

    out = tmp_path / "test" / "synth"
    video = np.load(out / "video.npz")
    n_kf = video["poses"].shape[0]
    assert slam.video.counter == n_kf >= tc["warmup"]
    assert video["depths"].shape == (n_kf, H, W)
    assert np.isfinite(video["poses"]).all()
    ates = {}
    for label in ("kf_traj", "full_traj"):
        with open(out / "traj" / f"metrics_{label}.txt") as f:
            first = f.readline()
        assert first.startswith("ATE-RMSE [m]: ")
        ates[label] = float(first.split(":")[1])
    assert all(np.isfinite(v) for v in ates.values()), ates
    full = np.load(out / "traj" / "full_traj_w2c.npy")
    assert full.shape == (n_frames, 7) and np.isfinite(full).all()
    with open(out / "logs" / "phase_times.json") as f:
        phases = json.load(f)["phases"]
    for name in ("final_ba", "save_video", "eval_traj", "trajectory_filler",
                 "frontend"):
        assert phases[name]["calls"] >= 1, name
    assert slam.tracker.prev_ba_idx > 0


def test_slam_refuses_what_is_not_ported(tmp_path):
    """A mono prior other than the omnidata DPT is not ported: it raises.
    The mapper and the online prior, refused before they were ported, are
    now built (``test_torch_async_mapper``, ``test_torch_mapper`` and
    ``test_torch_mono_prior`` run them)."""
    stream = SyntheticStream(n_frames=2, H=H, W=W, seed=3)
    cfg = base_cfg(H=H, W=W, buffer=8, out=str(tmp_path))
    cfg.update(mapping_cfg())
    cfg["pointcloud"]["capacity"] = 8192
    cfg["only_tracking"] = False
    slam = SLAM(cfg, stream, device="cpu")
    assert slam.mapper is not None and slam.async_mapper is not None
    slam.async_mapper.join()
    cfg["only_tracking"] = True
    cfg["mono_prior"] = {"predict_online": True, "depth": "dpt_beit"}
    with pytest.raises(NotImplementedError, match="dpt_beit"):
        SLAM(cfg, stream, device="cpu")


# ---------------------------------------------------------------------------
# oracle flow (twin of tests/test_tracking_e2e.py's, which is slow there)
# ---------------------------------------------------------------------------

class OracleGraph(FactorGraph):
    """FactorGraph whose update takes ground-truth flow in place of the
    ConvGRU, isolating the graph and BA from the learned nets."""

    def __init__(self, video, stream, **kw):
        super().__init__(video, None, **kw)
        self.stream = stream

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False,
               motion_only=False, opt_type="pose_depth"):
        v = self.video
        ts = v.timestamp[:v.counter].numpy().astype(int)
        gt_poses = torch.as_tensor(self.stream.poses_w2c[ts])
        gt_disps = torch.as_tensor(1.0 / np.stack(
            [self.stream.depths[t][3::8, 3::8] for t in ts]))
        coords, valid = projective.projective_transform(
            gt_poses, gt_disps, v.intrinsics, self._idx(self.ii),
            self._idx(self.jj))
        self.target = coords
        self.weight = valid.expand_as(coords).contiguous()
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        eta = 0.2 * self.damping[self._idx(np.unique(self.ii))] + 1e-7
        v.ba(self.target, self.weight, eta, self.ii, self.jj, t0, None,
             iters=itrs, lm=1e-4, ep=0.1, motion_only=motion_only,
             opt_type=opt_type)
        self.age += 1


def test_oracle_tracking_converges():
    stream = SyntheticStream(n_frames=12, H=H, W=W, seed=3)
    video = DepthVideo(base_cfg(H=H, W=W, buffer=16), device="cpu")
    n = 10
    z = torch.zeros((H // 8, W // 8, 128))
    for t in range(n):
        video.append(t, (stream.frames[t] * 255).astype(np.uint8),
                     lie.identity() if t == 0 else None,
                     1.0 if t == 0 else None, None,
                     stream.intrinsics / 8.0, z, z, z)
    graph = OracleGraph(video, stream, max_factors=96)
    graph.add_neighborhood_factors(0, n, r=3)
    for _ in range(12):
        graph.update(1)
    est_c2w = lie.to_matrix(lie.inv(video.poses[:n])).numpy()
    gt_c2w = np.stack(stream.poses[:n])
    rmse, stats, _ = alignment.ate_rmse(est_c2w[:, :3, 3].astype(np.float64),
                                        gt_c2w[:, :3, 3].astype(np.float64))
    # the trajectory spans ~0.5; oracle flow must land far tighter
    assert rmse < 0.02, (rmse, stats)
