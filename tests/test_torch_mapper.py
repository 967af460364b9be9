"""Port parity: the mapper against the JAX package's, on the CPU at 64x96
(``tests/synthetic.base_cfg``: capacity 8192, 5 samples per ray, 96 rays,
window 3, dynamic radius and pixel warping on), over a video that holds the
true poses and depths of a synthetic stream (``torch_parity.oracle_videos``).

* One ``_map_train_step`` from one state (the JAX cloud's features and
  decoder weights carried across, a feature mask with zeros, the geometry
  decoder fixed): the three losses to 1e-5 relative; the masked gradients
  to 1e-3 relative plus 1e-3 of their largest entry and the rounding of
  their read-out (the JAX gradients are read as the difference its step
  makes with Adam replaced by a plain add, which rounds at the scale of the
  parameters); the parameters after Adam's first step to 2e-4 (the step
  is lr * g / (|g| + eps), which turns a gradient's rounding into a
  relative change of the same size), except where a gradient is so near
  zero that its sign is rounding: there within the learning rate; masked
  entries exactly unchanged.
* Two keyframes through ``Mapper.on_keyframe`` (synchronous), the JAX
  feature draws carried across: equal anchor counts, anchor positions to
  1e-5, and every sampled loss of the loss history to 2e-3 relative (ten
  Adam steps amplify float32 rounding).
* ``final_refine`` after them: the saved anchor cloud and point cloud to
  1e-5 (they depend on poses and depths, not on the training), and the PLY.
* ``render_keyframe_img`` from the JAX state carried across: proxy depth
  exactly, depth and colour to 2e-4 on all but 0.5% of the pixels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glorie_slam_tpu.mapping.mapper as jmapper_mod
from glorie_slam_tpu.mapping.mapper import Mapper as JMapper
from glorie_slam_tpu.utils.printer import Printer as JPrinter
from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
from glorie_slam_tpu_torch.mapping.mapper import Mapper
from glorie_slam_tpu_torch.nets.import_flax import \
    decoder_params_to_state_dict
from glorie_slam_tpu_torch.utils.printer import Printer
from synthetic import SyntheticStream, base_cfg
from torch_parity import SlamShim, jax_feature_draws, n, oracle_videos, t

H, W = 64, 96


def _mappers(tmp, n_frames=3):
    stream = SyntheticStream(n_frames=n_frames, H=H, W=W, seed=5)
    out = {}
    for side in ("jax", "port"):
        cfg = base_cfg(H=H, W=W, buffer=16, out=os.path.join(tmp, side))
        cfg["only_tracking"] = False
        out[side] = cfg
    jv, pv = oracle_videos(stream, out["jax"], n_frames)
    jm = JMapper(SlamShim(out["jax"], stream, jv, JPrinter(0, True)),
                 out["jax"])
    pm = Mapper(SlamShim(out["port"], stream, pv, Printer(0, True)),
                out["port"])
    pm.decoders.load_state_dict(decoder_params_to_state_dict(jm.dec_params))
    pm.npc._draw_features = jax_feature_draws(out["jax"]["setup_seed"],
                                              pm.npc.c_dim)
    return jm, pm, stream


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _step_inputs(jm, pm, stream):
    """Anchor frames 0 and 1 on both sides, then one 96-ray batch over
    frames 0-4 (16 padding rays; pixel warping needs 4 frames besides a
    ray's own) and the masks."""
    for m in (jm, pm):
        for k in (0, 1):
            m.dynamic_r_add, m.dynamic_r_query = (
                jmapper_mod.sampling.dynamic_radius_maps(stream.frames[k],
                                                         m.cfg))
            c2w, _, droid = m.get_c2w_and_depth(k, k, None)
            m.anchor_points(np.array(droid), stream.frames[k], c2w, k)
    assert pm.npc.count == jm.npc.count > 0
    np.testing.assert_array_equal(n(pm.npc.geo_feats),
                                  np.asarray(jm.npc.geo_feats))
    rng = np.random.default_rng(9)
    R, F, fx, fy, cx, cy = 96, 5, pm.fx, pm.fy, pm.cx, pm.cy
    slot = np.repeat(np.arange(F), 16).astype(np.int32)
    slot = np.concatenate([slot, np.full(R - len(slot), F, np.int32)])
    i = rng.integers(6, W - 6, R)
    j = rng.integers(6, H - 6, R)
    c2ws = np.stack([jm._c2w_nerf(k) for k in range(F)]).astype(np.float32)
    ro, rd, dep, col = (np.zeros((R, 3), np.float32) for _ in range(4))
    dep = np.zeros(R, np.float32)
    for r in range(F * 16):
        k = slot[r]
        o, d = jmapper_mod.rays_from_uv(jnp.float32(i[r]), jnp.float32(j[r]),
                                        jnp.asarray(c2ws[k]), fx, fy, cx, cy)
        ro[r], rd[r] = np.asarray(o), np.asarray(d)
        dep[r] = stream.depths[k][j[r], i[r]]
        col[r] = stream.frames[k][j[r], i[r]]
    dep[::11] = 0.0
    rq = (0.04 + 0.1 * rng.random(R)).astype(np.float32)
    inside = dep > 0
    feat_mask = (rng.random((jm.npc.cap, 1)) > 0.3).astype(np.float32)
    feat_mask[jm.npc.count:] = 0.0
    imgs = np.stack(stream.frames[:F]).astype(np.float32)
    return dict(ro=ro, rd=rd, dep=dep, col=col, rq=rq, inside=inside,
                slot=slot, c2ws=c2ws, imgs=imgs, feat_mask=feat_mask)


@pytest.mark.parametrize("stage", ["geometry", "color"])
def test_map_train_step_matches_jax(tmp_path, monkeypatch, stage):
    jm, pm, stream = _mappers(str(tmp_path), n_frames=5)
    x = _step_inputs(jm, pm, stream)
    lrs = (0.005, 0.03, 0.005)
    w = (1.0, 0.1, 1000.0)
    intr = (pm.fx, pm.fy, pm.cx, pm.cy)
    fixed = {"geo_decoder": True, "color_decoder": False}
    jdec_mask = {k: jax.tree_util.tree_map(
        lambda a: jnp.zeros_like(a) if fixed[k] else jnp.ones_like(a), v)
        for k, v in jm.dec_params.items()}
    tp = {"dec": jm.dec_params, "geo": jm.npc.geo_feats,
          "col": jm.npc.col_feats}
    jargs = (jnp.asarray(lrs), jm.npc.cloud_pos, jnp.asarray(jm.npc.count),
             *map(jnp.asarray, (x["ro"], x["rd"], x["dep"], x["col"],
                                x["rq"], x["inside"], x["slot"])),
             jnp.ones(5, bool), jnp.asarray(x["c2ws"]),
             jnp.asarray(x["imgs"]), jnp.asarray(x["feat_mask"]),
             jnp.asarray(x["feat_mask"]), jdec_mask, jnp.asarray(intr),
             jnp.asarray(w))
    kw = dict(stage=stage, pix_warp=True, Wi=W, Hi=H)
    new_tp, _, jmet = jmapper_mod._map_train_step(
        jm.decoders, jm.rcfg, tp, jmapper_mod._ADAM.init(tp), *jargs, **kw)
    # the JAX gradients: the same step with Adam replaced by a plain add
    monkeypatch.setattr(jmapper_mod, "_adam_groups",
                        lambda g, s, lr: (g, s))
    raw_step = jax.jit(jmapper_mod._map_train_step.__wrapped__,
                       static_argnames=("decoders", "rcfg", "stage",
                                        "pix_warp", "Wi", "Hi"))
    plus_g, _, _ = raw_step(jm.decoders, jm.rcfg, tp, None, *jargs, **kw)
    jgrads = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        plus_g, tp)

    geo, col = pm.npc.geo_feats, pm.npc.col_feats
    geo0, col0 = geo.clone(), col.clone()
    opt = mapper_mod.make_optimizer(pm.decoders, geo, col)
    met = mapper_mod._map_train_step(
        pm.decoders, pm.rcfg, opt, geo, col, lrs, pm.npc.cloud_pos,
        pm.npc.count, t(x["ro"]), t(x["rd"]), t(x["dep"]), t(x["col"]),
        t(x["rq"]), torch.as_tensor(x["inside"]),
        torch.as_tensor(x["slot"]).long(), torch.ones(5, dtype=torch.bool),
        t(x["c2ws"]), t(x["imgs"]), t(x["feat_mask"]),
        {k: 0.0 if v else 1.0 for k, v in fixed.items()}, intr, w, stage,
        True, W, H)
    for k in ("geo_loss", "color_loss", "warp_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(met["warp_loss"]) > 0

    def check(p, p0, jg, jnew, lr, name):
        """Masked gradient against the JAX one: to 1e-3 relative, past
        two float32 spacings of the parameter (the read-out's rounding) and
        1e-3 of the largest entry (sums that cancel). The parameter after
        Adam's first step (p - lr * g / (|g| + eps)) to 2e-4, except where
        the gradient is within 10x that tolerance of zero: there the two
        signs may differ and the step may land anywhere within lr."""
        g = n(p.grad)
        atol = 2 * np.spacing(np.abs(p0)) + 1e-3 * np.abs(jg).max()
        assert (np.abs(g - jg) <= atol + 1e-3 * np.abs(jg)).all(), name
        near0 = np.abs(jg) < 10 * atol
        np.testing.assert_allclose(n(p)[~near0], jnew[~near0], atol=2e-4,
                                   err_msg=name)
        assert (np.abs(n(p) - jnew)[near0] <= 2 * lr + 2e-4).all(), name
        assert (~near0).any() or (jg == 0).all(), name
        return g

    jdec_flat = decoder_params_to_state_dict(jgrads["dec"])
    jnew_dec = decoder_params_to_state_dict(new_tp["dec"])
    jold_dec = decoder_params_to_state_dict(jm.dec_params)
    for name, p in pm.decoders.named_parameters():
        g = check(p, n(jold_dec[name]), n(jdec_flat[name]),
                  n(jnew_dec[name]), lrs[0], name)
        if name.startswith("geo_decoder"):
            assert (g == 0).all(), name
    off = x["feat_mask"][:, 0] == 0
    for p, p0, key, lr in ((geo, geo0, "geo", lrs[1]),
                           (col, col0, "col", lrs[2])):
        g = check(p, n(p0), jgrads[key], np.asarray(new_tp[key]), lr, key)
        assert (g[off] == 0).all()
        np.testing.assert_array_equal(n(p)[off], n(p0)[off])
    assert np.abs(n(geo.grad)).max() > 0
    if stage == "color":
        assert np.abs(n(col.grad)).max() > 0
    mapper_mod.release(pm.decoders, geo, col)


# ---------------------------------------------------------------------------
# two keyframes and the final refine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    jm, pm, stream = _mappers(str(tmp_path_factory.mktemp("mapper")))
    anchors = []
    for k in (0, 2):
        info = {"is_keyframe": True, "video_idx": k, "timestamp": k,
                "end": False}
        jm.on_keyframe(info)
        pm.on_keyframe(info)
        anchors.append((jm.npc.count_in, pm.npc.count_in))
    return jm, pm, anchors


def test_two_keyframe_mapping_matches_jax(mapped):
    jm, pm, anchors = mapped
    assert all(a == b > 0 for a, b in anchors) and anchors[1][0] > anchors[0][0]
    np.testing.assert_allclose(n(pm.npc.input_pos[:pm.npc.count_in]),
                               np.asarray(jm.npc.input_pos[:jm.npc.count_in]),
                               atol=1e-5)
    assert [k["idx"] for k in pm.keyframe_dict] == [0, 2]
    assert len(pm.loss_history) == len(jm.loss_history) == 4
    for a, b in zip(pm.loss_history, jm.loss_history):
        assert {k: a[k] for k in ("idx", "iter", "stage", "refine")} == \
            {k: b[k] for k in ("idx", "iter", "stage", "refine")}
        np.testing.assert_allclose([a["geo"], a["color"]],
                                   [b["geo"], b["color"]], rtol=2e-3)


def test_final_refine_saves_the_jax_arrays(mapped):
    jm, pm, _ = mapped
    jm.final_refine(save_final_pcl=True)
    pm.final_refine(save_final_pcl=True)
    assert [h for h in pm.loss_history if h["refine"]]
    for name in ("final_point_cloud.npy", "npc_cloud.npy"):
        a = np.load(os.path.join(pm.output, name))
        b = np.load(os.path.join(jm.output, name))
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(a, b, atol=1e-5 * 255, rtol=1e-5)
    with open(os.path.join(pm.output, "final_point_cloud.ply")) as f:
        head = [next(f) for _ in range(3)]
    assert head[2] == f"element vertex {pm.npc.count_in}\n"


def test_render_keyframe_img_matches_jax(mapped):
    """A whole keyframe rendered at its proxy depth (``render_img``, ray
    batches of 3000 zero-padded as the JAX package pads them), from the JAX
    mapper's features and decoder weights carried across (training drift
    is the test above's business): proxy depth exactly; depth and colour
    to 2e-4 as ``render_rays`` (``test_torch_mapping.py``) on all but 0.5%
    of the pixels. ``far`` is a mean over each 3000-ray batch, summed in
    another order, so the near-cloud probes move by ulps and a probe at the
    query radius may flip, which moves its ray's samples."""
    jm, pm, _ = mapped
    pm.npc.geo_feats.copy_(t(np.asarray(jm.npc.geo_feats)))
    pm.npc.col_feats.copy_(t(np.asarray(jm.npc.col_feats)))
    pm.decoders.load_state_dict(decoder_params_to_state_dict(jm.dec_params))
    jd, jc, jp = jm.render_keyframe_img(2, 2, None)
    d, c, p = pm.render_keyframe_img(2, 2, None)
    np.testing.assert_array_equal(p, np.asarray(jp))
    jd, jc = np.asarray(jd), np.asarray(jc)
    off = ((np.abs(d - jd) > 2e-4 + 2e-4 * np.abs(jd))
           | (np.abs(c - jc) > 2e-4).any(-1))
    assert off.mean() <= 0.005, off.sum()
    assert np.isfinite(c).all() and c.std() > 1e-6
