"""Port parity: the mapper's building blocks against the JAX package, on
the CPU at 64x96 with a cloud capacity of 8192 and 5 samples per ray.

Tolerances, from float32 and the order of its sums:

* ``knn_search``: distances to 1e-5 relative (both sides round the same
  float32 formula the same way; on the CPU they are bitwise equal), indices
  exactly wherever the distance is below ``BIG``, ties included (both take
  the lowest index first); ``neighbor_count`` exactly.
* sampling (numpy on both sides, one RNG seed): exactly.
* geometry (``iproj_world``, ``projmap``, ``induced_flow``, ``act3``,
  ``from_matrix``): 1e-5.
* ``add_neural_points``: counts, anchor indices, frames and pixels exactly;
  positions, colours and depths to 1e-6; features (the JAX draws carried
  across) exactly.
* ``deform``: 1e-5 (its per-frame scale sums in another order).
* ``proj_depth_map``: exactly where the camera's inverse is exact in float32
  on both sides (a rotation by quarter turns, a dyadic translation); under
  a general rotation the two 4x4 inverses differ in the last bits, so a
  point on a pixel edge may land one pixel over: at most 0.5% of pixels
  differ. ``get_proxy_render_depth`` likewise.
* decoders: 2e-5 absolute on outputs of order 1.
* ``render_rays``: 2e-4 on depth, variance and colour; validity and counts
  exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.geom import lie as jlie, projective as jproj
from glorie_slam_tpu.mapping import sampling as jsampling
from glorie_slam_tpu.mapping.decoders import PointDecoders as JDecoders
from glorie_slam_tpu.mapping.point_cloud import NeuralPointCloud as JCloud
from glorie_slam_tpu.mapping.renderer import (RenderConfig as JRenderConfig,
                                              render_rays as jrender_rays)
from glorie_slam_tpu.ops import knn as jknn
from glorie_slam_tpu_torch.geom import lie, projective
from glorie_slam_tpu_torch.mapping import sampling
from glorie_slam_tpu_torch.mapping.decoders import PointDecoders
from glorie_slam_tpu_torch.mapping.point_cloud import (NeuralPointCloud,
                                                       rays_from_uv)
from glorie_slam_tpu_torch.mapping.renderer import RenderConfig, render_rays
from glorie_slam_tpu_torch.nets.import_flax import \
    decoder_params_to_state_dict
from glorie_slam_tpu_torch.ops import knn
from synthetic import SyntheticStream, base_cfg
from torch_parity import jax_feature_draws, n, oracle_videos, t

H, W = 64, 96


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,count,Q", [
    (8192, 500, 64),        # one tile
    (24576, 9000, 96),      # two tiles hold the points, the JAX scan reads 3
    (8192, 5, 16),          # fewer points than k
    (8192, 0, 8),           # empty cloud
])
def test_knn_search_matches_jax(cap, count, Q):
    rng = np.random.default_rng(cap + count)
    pts = np.zeros((cap, 3), np.float32)
    pts[:count] = 1.0 + 2.0 * rng.random((count, 3), dtype=np.float32)
    pts[count:] = 0.001                     # padding near the queries
    q = (1.0 + 2.0 * rng.random((Q, 3))).astype(np.float32)
    jD, jI = jknn.knn_search(jnp.asarray(q), jnp.asarray(pts),
                             jnp.asarray(count), k=8)
    D, I = knn.knn_search(t(q), t(pts), count, k=8)
    jD, jI = np.asarray(jD), np.asarray(jI)
    np.testing.assert_allclose(n(D), jD, rtol=1e-5, atol=0)
    real = jD < knn.BIG
    assert real.sum() == Q * min(count, 8)
    np.testing.assert_array_equal(n(I)[real], jI[real])
    for r in (0.1, 0.3):
        np.testing.assert_array_equal(
            n(knn.neighbor_count(D, r)),
            np.asarray(jknn.neighbor_count(jnp.asarray(jD), jnp.asarray(r))))
    rv = (0.05 + 0.3 * rng.random(Q)).astype(np.float32)
    np.testing.assert_array_equal(
        n(knn.neighbor_count(D, t(rv))),
        np.asarray(jknn.neighbor_count(jnp.asarray(jD), jnp.asarray(rv))))


def test_knn_search_breaks_ties_as_jax():
    """Anchors are sampled with replacement, so a cloud holds exact copies
    of a point, at exactly equal distances from every query: the port
    lists them lowest index first, as ``lax.top_k`` does, including a
    group of copies cut by the k-th place."""
    rng = np.random.default_rng(11)
    cap, count, Q = 16384, 9000, 128
    pts = np.full((cap, 3), 0.001, np.float32)
    base = 1.0 + 2.0 * rng.random((count // 3, 3), dtype=np.float32)
    # each point once, then again in shuffled order, then a third time,
    # so that copies sit in both tiles and far apart in index
    pts[:count] = np.concatenate([base, base[rng.permutation(len(base))],
                                  base[::-1]])
    q = base[rng.integers(0, len(base), Q)] + np.float32(1e-3) * rng.normal(
        size=(Q, 3)).astype(np.float32)
    jD, jI = jknn.knn_search(jnp.asarray(q), jnp.asarray(pts),
                             jnp.asarray(count), k=8)
    D, I = knn.knn_search(t(q), t(pts), count, k=8)
    jD, jI = np.asarray(jD), np.asarray(jI)
    assert (jD[:, 7] == jD[:, 6]).mean() > 0.3         # ties at the cut
    np.testing.assert_array_equal(n(D), jD)
    np.testing.assert_array_equal(n(I), jI)


# ---------------------------------------------------------------------------
# sampling and geometry
# ---------------------------------------------------------------------------

def test_sampling_matches_jax():
    rng = np.random.default_rng(3)
    color = rng.random((H, W, 3)).astype(np.float32)
    depth = (1.0 + rng.random((H, W))).astype(np.float32)
    mask = rng.random((H, W)) > 0.3
    pc = base_cfg()["pointcloud"]
    for a, b in zip(sampling.dynamic_radius_maps(color, {"pointcloud": pc}),
                    jsampling.dynamic_radius_maps(color, {"pointcloud": pc})):
        np.testing.assert_array_equal(a, b)
    for fn, jfn, args in (
            (sampling.sample_pixels, jsampling.sample_pixels, (mask,)),
            (sampling.sample_pixels, jsampling.sample_pixels, (None, 4)),
            (sampling.sample_pixels_with_grad,
             jsampling.sample_pixels_with_grad, (mask,))):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(2):          # the RNG streams stay in step
            for a, b in zip(fn(r1, 50, H, W, depth, color, *args),
                            jfn(r2, 50, H, W, depth, color, *args)):
                np.testing.assert_array_equal(a, b)


def test_geometry_for_the_mapper_matches_jax():
    rng = np.random.default_rng(4)
    N, h, w = 4, 6, 8
    xi = (rng.normal(size=(N, 6)) * 0.1).astype(np.float32)
    poses = np.asarray(jlie.exp(jnp.asarray(xi)))
    disps = (0.3 + rng.random((N, h, w))).astype(np.float32)
    intr = np.array([5.0, 5.0, 4.0, 3.0], np.float32)
    ii, jj = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 3])
    args = (poses, disps, intr)
    np.testing.assert_allclose(
        n(projective.iproj_world(*map(t, args))),
        np.asarray(jproj.iproj_world(*map(jnp.asarray, args))), atol=1e-5)
    for fn, jfn in ((projective.projmap, jproj.projmap),
                    (projective.induced_flow, jproj.induced_flow)):
        out = fn(*map(t, args), torch.as_tensor(ii), torch.as_tensor(jj))
        jout = jfn(*map(jnp.asarray, args), jnp.asarray(ii), jnp.asarray(jj))
        for a, b in zip(out, jout):
            np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4,
                                       rtol=1e-5)
    X = rng.normal(size=(N, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(lie.act3(t(poses), t(X))),
        np.asarray(jlie.act3(jnp.asarray(poses), jnp.asarray(X))), atol=1e-5)
    # from_matrix, every branch of Shepperd's method (w, x, y, z largest)
    mats = np.asarray(jlie.to_matrix(jnp.asarray(poses)))
    flips = [np.diag([1.0, -1, -1, 1]), np.diag([-1.0, 1, -1, 1]),
             np.diag([-1.0, -1, 1, 1])]
    mats = np.concatenate([mats] + [mats[:1] @ f for f in flips]).astype(
        np.float32)
    np.testing.assert_allclose(
        n(lie.from_matrix(t(mats))),
        np.asarray(jlie.from_matrix(jnp.asarray(mats))), atol=1e-6)


# ---------------------------------------------------------------------------
# the point cloud
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """Two frames of a synthetic stream in a JAX and a port video, a JAX
    and a port cloud over them, and the cloud's rays for two adds."""
    cfg = base_cfg(H=H, W=W, buffer=16)
    stream = SyntheticStream(n_frames=3, H=H, W=W, seed=5)
    jv, pv = oracle_videos(stream, cfg, 3)
    return cfg, stream, jv, pv


def _clouds(cfg):
    jc = JCloud(cfg, None, capacity=8192, seed=11)
    pc = NeuralPointCloud(cfg, capacity=8192, seed=11, device="cpu")
    pc._draw_features = jax_feature_draws(11, pc.c_dim)
    return jc, pc


def _frame_rays(stream, k, rng, n_px):
    """(i, j, depth, colour, c2w NeRF) of n_px pixels of frame k."""
    i = rng.integers(0, W, n_px).astype(np.int32)
    j = rng.integers(0, H, n_px).astype(np.int32)
    c2w = np.asarray(stream.poses[k], np.float32).copy()
    c2w[:3, 1:3] *= -1
    d = stream.depths[k][j, i].astype(np.float32)
    d[::7] = 0.0                                        # invalid depth
    return i, j, d, stream.frames[k][j, i].astype(np.float32), c2w


def _add_both(jc, pc, cfg, stream, k, rng, n_px, dyn=None, grad=False):
    i, j, d, c, c2w = _frame_rays(stream, k, rng, n_px)
    fx, fy, cx, cy = stream.intrinsics
    jo, jd = (np.asarray(x) for x in jsampling.rays_for_pixels(
        i, j, c2w, fx, fy, cx, cy))
    po, pd = rays_from_uv(t(i), t(j), t(c2w), fx, fy, cx, cy)
    np.testing.assert_allclose(n(pd), jd, atol=1e-6)
    ja = jc.add_neural_points(
        jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(d), jnp.asarray(c), k,
        i, j, is_pts_grad=grad,
        dynamic_radius=None if dyn is None else jnp.asarray(dyn[j, i]))
    pa = pc.add_neural_points(
        po, pd, t(d), t(c), k, i, j, is_pts_grad=grad,
        dynamic_radius=None if dyn is None else t(dyn[j, i]))
    return ja, pa


def _cloud_arrays(c):
    keys = ("cloud_pos", "geo_feats", "col_feats", "input_pos", "input_rgb",
            "input_depth", "input_video_idx", "input_i", "input_j")
    return {k: n(getattr(c, k)) if isinstance(getattr(c, k), torch.Tensor)
            else np.asarray(getattr(c, k)) for k in keys}


def _assert_clouds_equal(jc, pc, atol=1e-6):
    assert (pc.count, pc.count_in) == (jc.count, jc.count_in)
    a, b = _cloud_arrays(pc), _cloud_arrays(jc)
    for k in ("input_video_idx", "input_i", "input_j", "geo_feats",
              "col_feats"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("cloud_pos", "input_pos", "input_rgb", "input_depth"):
        np.testing.assert_allclose(a[k], b[k], atol=atol * (255 if k ==
                                   "input_rgb" else 1), err_msg=k)


def test_add_neural_points_matches_jax(scene):
    cfg, stream, _, _ = scene
    jc, pc = _clouds(cfg)
    rng = np.random.default_rng(0)
    ja, pa = _add_both(jc, pc, cfg, stream, 0, rng, 300)
    assert ja == pa > 0
    _assert_clouds_equal(jc, pc)
    # the second frame overlaps the first: the radius dedupe drops some,
    # under a per-pixel radius and then the colour-gradient radius
    dyn, _ = jsampling.dynamic_radius_maps(stream.frames[1], cfg)
    ja, pa = _add_both(jc, pc, cfg, stream, 1, rng, 300, dyn=dyn)
    assert ja == pa > 0
    ja, pa = _add_both(jc, pc, cfg, stream, 1, rng, 300, grad=True)
    assert ja == pa
    _assert_clouds_equal(jc, pc)
    assert pc.count_in < 3 * 300 * 6 / 7


def test_deform_matches_jax(scene):
    cfg, stream, _, _ = scene
    jc, pc = _clouds(cfg)
    rng = np.random.default_rng(1)
    for k in (0, 1, 2):
        _add_both(jc, pc, cfg, stream, k, rng, 200)
    depths = (np.stack(stream.depths) * (1.0 + 0.05 * rng.normal(
        size=(3, H, W)))).astype(np.float32)
    depths[rng.random(depths.shape) < 0.2] = 0.0       # invalid new depth
    poses = np.asarray(jlie.exp(jnp.asarray(
        (rng.normal(size=(3, 6)) * 0.05).astype(np.float32))))
    c2ws = np.array(jlie.to_matrix(jlie.inv(jnp.asarray(poses))))
    c2ws[:, :3, 1:3] *= -1
    dirty = np.array([True, False, True])
    # a third cloud takes the JAX cloud's arrays through load_arrays
    loaded = NeuralPointCloud(cfg, capacity=8192, seed=0, device="cpu")
    loaded.load_arrays({**{k: np.asarray(getattr(jc, k)) for k in (
        "cloud_pos", "geo_feats", "col_feats", "input_pos", "input_rgb",
        "input_depth", "input_video_idx", "input_i", "input_j", "full_pcl",
        "full_mask")}, "count": jc.count, "count_in": jc.count_in})
    _assert_clouds_equal(jc, loaded, atol=0)
    buf = cfg["tracking"]["buffer"]
    pad = np.zeros((buf - 3, H, W), np.float32)
    jc.deform(jnp.asarray(np.concatenate([depths, pad])),
              jnp.asarray(np.concatenate([c2ws, np.tile(np.eye(4), (
                  buf - 3, 1, 1))]).astype(np.float32)),
              jnp.asarray(np.concatenate([dirty, np.zeros(buf - 3, bool)])))
    for cloud in (pc, loaded):
        cloud.deform(t(depths), t(c2ws), torch.as_tensor(dirty))
        _assert_clouds_equal(jc, cloud, atol=1e-5)
    moved = n(pc.input_video_idx[:pc.count_in]) != 1
    assert moved.any() and (~moved).any()


def _camera(general):
    """A NeRF c2w: quarter-turn rotation and dyadic translation (its
    inverse is exact in float32), or a general rotation."""
    if general:
        R = np.asarray(jlie.quat_to_matrix(jnp.asarray(
            np.array([0.05, -0.08, 0.02, 0.99], np.float32)
            / np.linalg.norm([0.05, -0.08, 0.02, 0.99]))))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, [0.1, -0.05, 0.2]
    else:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.25, -0.125, 0.5]
    T[:3, 1:3] *= -1
    return T.astype(np.float32)


@pytest.mark.parametrize("general", [False, True])
def test_proj_depth_map_and_proxy_depth_match_jax(scene, general):
    cfg, stream, jv, pv = scene
    jc, pc = _clouds(cfg)
    _add_both(jc, pc, cfg, stream, 0, np.random.default_rng(2), 400)
    for k in (0, 1, 2):
        jc.video = jv
        jc.add_points(k)
        pc.add_points(pv, k)
    np.testing.assert_array_equal(n(pc.full_mask), np.asarray(jc.full_mask))
    np.testing.assert_allclose(n(pc.full_pcl.float()),
                               np.asarray(jc.full_pcl, np.float32),
                               rtol=8e-3)          # one bf16 ulp
    # the splat reads the bf16 cloud: carry the JAX one across exactly
    pc.full_pcl.copy_(torch.as_tensor(np.asarray(jc.full_pcl, np.float32)))
    c2w = _camera(general)
    limit = 0.005 * H * W if general else 0
    for kw in ({}, {"exclude_recent_from": 2}, {"neural_pcl": True}):
        a = n(pc.proj_depth_map(t(c2w), **kw))
        b = np.asarray(jc.proj_depth_map(jnp.asarray(c2w), **kw))
        assert (a > 0).sum() > 0.2 * H * W or kw
        assert (a != b).sum() <= limit, (kw, int((a != b).sum()))
    droid = np.zeros((H, W), np.float32)
    droid[10:30, 20:50] = 1.7
    mono = np.full((H, W), 2.5, np.float32)
    for use_mono in (False, True):
        a = n(pc.get_proxy_render_depth(t(c2w), t(droid), t(mono),
                                        use_mono_to_complete=use_mono))
        b = np.asarray(jc.get_proxy_render_depth(
            jnp.asarray(c2w), jnp.asarray(droid), jnp.asarray(mono),
            use_mono_to_complete=use_mono))
        assert (a != b).sum() <= limit
        assert np.all(a[10:30, 20:50] == 1.7)


# ---------------------------------------------------------------------------
# decoders and renderer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoders():
    jdec = JDecoders(min_nn_num=2)
    dummy = jnp.zeros((8, 3))
    params = jdec.init(jax.random.PRNGKey(0), dummy, jnp.ones((8, 8)),
                       jnp.zeros((8, 8), jnp.int32),
                       jnp.zeros((8,), jnp.int32), jnp.zeros((8, 32)),
                       jnp.zeros((8, 32)), dummy, jnp.asarray(0.01), dummy,
                       "color")
    params = jax.tree_util.tree_map(np.asarray, params)
    pdec = PointDecoders(min_nn_num=2)
    pdec.load_state_dict(decoder_params_to_state_dict(params))
    return jdec, params, pdec


def test_decoder_state_dict_names_match_flax_tree(decoders):
    _, params, pdec = decoders
    carried = decoder_params_to_state_dict(params)
    assert set(carried) == set(pdec.state_dict())
    fixed = {k for k, _ in pdec.named_buffers()}
    assert fixed == {"color_decoder.embedder.B",
                     "color_decoder.embedder_view.B"}


@pytest.mark.parametrize("stage", ["geometry", "color"])
def test_decoders_forward_matches_jax(decoders, stage):
    jdec, params, pdec = decoders
    rng = np.random.default_rng(6)
    N, P, k = 200, 600, 8
    cloud = rng.random((P, 3)).astype(np.float32)
    p = rng.random((N, 3)).astype(np.float32)
    I = rng.integers(0, P, (N, k))
    D = np.sort(((cloud[I] - p[:, None]) ** 2).sum(-1), axis=1).astype(
        np.float32)
    r2 = (0.02 + 0.2 * rng.random((N, 1))).astype(np.float32)
    nn = (D < r2).sum(-1).astype(np.int32)
    geo = (0.1 * rng.normal(size=(P, 32))).astype(np.float32)
    col = (0.1 * rng.normal(size=(P, 32))).astype(np.float32)
    views = rng.normal(size=(N, 3)).astype(np.float32)
    jraw, jhas = jdec.apply(params, *map(jnp.asarray, (
        p, D, I, nn, geo, col, cloud, r2, views)), stage)
    with torch.no_grad():
        raw, has = pdec(t(p), t(D), torch.as_tensor(I), torch.as_tensor(nn),
                        t(geo), t(col), t(cloud), t(r2), t(views), stage)
    np.testing.assert_array_equal(n(has), np.asarray(jhas))
    assert 0 < n(has).sum() < N
    np.testing.assert_allclose(n(raw), np.asarray(jraw), atol=2e-5)


@pytest.mark.parametrize("dynamic", [False, True])
def test_render_rays_matches_jax(scene, decoders, dynamic):
    cfg, stream, _, _ = scene
    jdec, params, pdec = decoders
    jc, pc = _clouds(cfg)
    rng = np.random.default_rng(8)
    for k in (0, 1):
        _add_both(jc, pc, cfg, stream, k, rng, 400)
    i, j, d, _, c2w = _frame_rays(stream, 2, rng, 96)
    d[:8] = 0.0                       # rays that sample near the cloud
    fx, fy, cx, cy = stream.intrinsics
    ro, rd = (np.asarray(x) for x in jsampling.rays_for_pixels(
        i, j, c2w, fx, fy, cx, cy))
    rq = None
    if dynamic:
        _, rmap = jsampling.dynamic_radius_maps(stream.frames[2], cfg)
        rq = (rmap / 3.0 * stream.depths[2])[j, i].astype(np.float32)
    rcfg = RenderConfig.from_cfg(cfg)
    assert tuple(rcfg) == tuple(JRenderConfig.from_cfg(cfg))
    jout = jrender_rays(
        JRenderConfig.from_cfg(cfg), jdec, params, jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(d), jc.cloud_pos, jnp.asarray(jc.count),
        jc.geo_feats, jc.col_feats,
        None if rq is None else jnp.asarray(rq), "color")
    with torch.no_grad():
        out = render_rays(rcfg, pdec, t(ro), t(rd), t(d), pc.cloud_pos,
                          pc.count, pc.geo_feats, pc.col_feats,
                          None if rq is None else t(rq), "color")
    depth, var, color, valid, counts = (n(x) for x in out)
    jdepth, jvar, jcolor, jvalid, jcounts = (np.asarray(x) for x in jout)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(counts, jcounts)
    assert valid.any() and counts.max() > 0
    np.testing.assert_allclose(depth, jdepth, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(var, jvar, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(color, jcolor, atol=2e-4)
