"""Port parity: one GRU + BA update of the factor graph, and the DSPO
rounds, against the JAX package on the same video state and edges.

The video is filled with the same random features and geometry on both
sides (mirrored from the JAX DepthVideo into the port's). ``update`` runs
the net in float32 (JAX ``dtype=jnp.float32``); the DSPO rounds run it in
bf16 on both sides, because the JAX package's fused rounds require its
default bf16 net. Float32 order differences stay near 1e-5; in bf16, GRU
activations near a rounding tie land one bf16 ulp apart, so after BA the
poses agree to 2e-3 and the disparities to 2% or 5e-3 absolute (about 1%
of the scene's mean disparity, ~0.4). Pixels on a multiview-validity
threshold may flip with such rounding; the depth_scale test bounds how
many and compares the frames whose masks agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from glorie_slam_tpu.core.depth_video import DepthVideo as JVideo
from glorie_slam_tpu.core.factor_graph import FactorGraph as JGraph
from glorie_slam_tpu.geom import lie as jlie
from glorie_slam_tpu.nets.tracker_net import TrackerNet as JNet
from glorie_slam_tpu.tracking import fused as jfused
from glorie_slam_tpu_torch.core.depth_video import DepthVideo
from glorie_slam_tpu_torch.core.factor_graph import FactorGraph
from glorie_slam_tpu_torch.nets.import_flax import flax_params_to_state_dict
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.tracking import fused
from glorie_slam_tpu_torch.utils.synthetic import bench_cfg
from synthetic import base_cfg
from torch_parity import n, random_poses, t

H, W, N = 48, 64, 8


def _cfgs():
    cfgs = []
    for cfg in (base_cfg(H=H, W=W, buffer=12), bench_cfg(H=H, W=W,
                                                         buffer=12)):
        tc = cfg["tracking"]
        tc["frontend"].update(window=6, max_factors=24)
        tc["backend"]["BA_type"] = "DSPO"
        tc["multiview_filter"] = {"thresh": 0.05, "visible_num": 1}
        cfgs.append(cfg)
    return cfgs


def _videos(jnet_dtype, port_dtype):
    rng = np.random.default_rng(0)
    jcfg, pcfg = _cfgs()
    jn = JNet(seed=2, dtype=jnet_dtype)
    params = jax.tree_util.tree_map(np.asarray, jn.params)
    pn = TrackerNet(flax_params_to_state_dict(params), dtype=port_dtype,
                    device="cpu")
    jv = JVideo(jcfg)
    h8, w8 = H // 8, W // 8
    poses = jlie.exp(jnp.asarray(np.cumsum(random_poses(rng, N, 0.02), 0)))
    intr8 = np.array([W * 0.8, W * 0.8, W / 2, H / 2], np.float32) / 8
    for i in range(N):
        f = rng.normal(size=(h8, w8, 128)).astype(np.float32)
        net = np.tanh(rng.normal(size=(h8, w8, 128))).astype(np.float32)
        inp = np.maximum(rng.normal(size=(h8, w8, 128)), 0).astype(
            np.float32)
        depth = (2.5 + 0.3 * np.sin(np.arange(W) / 9.0)[None, :]
                 + 0.2 * np.cos(np.arange(H) / 7.0)[:, None]
                 + 0.02 * rng.random((H, W))).astype(np.float32)
        jv.append(i, np.zeros((H, W, 3), np.uint8), poses[i],
                  1.0 / depth[3::8, 3::8] * (1 + 0.05 * rng.random()),
                  depth, intr8, jnp.asarray(f), jnp.asarray(net),
                  jnp.asarray(inp))
    pv = DepthVideo(pcfg, device="cpu")
    pv.counter = jv.counter
    for name in ("timestamp", "poses", "disps", "disps_up", "intrinsics",
                 "mono_disps", "depth_scale", "depth_shift", "fmaps",
                 "nets", "inps"):
        arr = getattr(jv, name)
        dt = torch.bfloat16 if arr.dtype == jnp.bfloat16 else torch.float32
        setattr(pv, name, t(n(arr).astype(np.float32)).to(dt))
    for i in range(N):
        pv._update_corr_stores(i)
    return jn, jv, pn, pv


def _edges():
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    m = (ii != jj) & (np.abs(ii - jj) <= 2)
    return ii[m], jj[m]


def _compare(jv, pv, pose_atol, disp_rtol):
    np.testing.assert_allclose(n(pv.poses[:N]), n(jv.poses[:N]),
                               atol=pose_atol)
    np.testing.assert_allclose(n(pv.disps[:N]), n(jv.disps[:N]),
                               rtol=disp_rtol, atol=5e-3)


def test_factor_graph_update_matches_jax():
    jn, jv, pn, pv = _videos(jnp.float32, torch.float32)
    ii, jj = _edges()
    jg = JGraph(jv, jn.update_apply, jn.params, max_factors=24,
                agg_apply=jn.agg_apply)
    pg = FactorGraph(pv, pn, max_factors=24)
    jg.add_factors(ii, jj)
    pg.add_factors(ii, jj)
    np.testing.assert_allclose(n(pg.target), n(jg.target[:len(ii)]),
                               atol=1e-4)
    jg.update(t0=1, itrs=2)
    pg.update(t0=1, itrs=2)
    assert np.abs(n(pv.poses[:N]) - n(jv.poses[:N])).max() < 1e-3
    np.testing.assert_allclose(n(pg.weight), n(jg.weight[:len(ii)]),
                               atol=2e-3)
    np.testing.assert_allclose(n(pv.disps_up[:N]), n(jv.disps_up[:N]),
                               rtol=1e-2, atol=1e-3)
    _compare(jv, pv, 1e-3, 1e-2)


def _rounds(rounds, alternate):
    jn, jv, pn, pv = _videos(jnp.bfloat16, torch.bfloat16)
    ii, jj = _edges()
    jg = JGraph(jv, jn.update_apply, jn.params, max_factors=24,
                agg_apply=jn.agg_apply)
    pg = FactorGraph(pv, pn, max_factors=24)
    jg.add_factors(ii, jj)
    pg.add_factors(ii, jj)
    # retire the oldest edges into the inactive pool on both sides
    old = ii < 2
    jg.rm_factors(old, store=True)
    pg.rm_factors(old, store=True)
    jd = jfused.graph_update_rounds(jg, rounds, use_inactive=True,
                                    alternate=alternate)
    pd = fused.graph_update_rounds(pg, rounds, use_inactive=True,
                                   alternate=alternate)
    return jv, pv, float(jd), pd


def test_dspo_rounds_pose_depth_match_jax():
    jv, pv, jd, pd = _rounds(4, alternate=False)
    _compare(jv, pv, 2e-3, 2e-2)
    np.testing.assert_allclose(pd, jd, rtol=2e-2)


def test_dspo_rounds_depth_scale_match_jax():
    """A pose_depth round, then a depth_scale round (1/8-res validity
    refresh through kernel B's module, mono scale/shift fit, DSPO solve).
    Pixels sitting on a validity threshold may flip with float rounding;
    frames whose masks agree must agree in disparity, scale and shift
    (the depth_scale solve is per frame once poses are fixed)."""
    jv, pv, jd, pd = _rounds(2, alternate=True)
    jm = n(jv.valid_depth_mask_small[:N])
    pm = n(pv.valid_depth_mask_small[:N])
    assert jm.sum() > 0.5 * jm.size
    assert np.mean(jm == pm) >= 0.97
    same = np.all(jm == pm, axis=(1, 2))
    assert same.sum() >= N - 2
    np.testing.assert_allclose(n(pv.poses[:N]), n(jv.poses[:N]), atol=2e-3)
    for name in ("disps", "depth_scale", "depth_shift"):
        a = n(getattr(pv, name)[:N])[same]
        b = n(getattr(jv, name)[:N])[same]
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=5e-3)
