"""Port parity: the omnidata DPT, its loaders, the mono-prior estimator and
the motion filter's online cadence against the JAX package, on the CPU.

* ``StdConv`` at strides 1 and 2, on odd and even sides (XLA "SAME"
  padding puts the odd row and column at the end): rel-L2 <= 1e-5.
* One omnidata-layout checkpoint, written by the test (random weights, a
  24x24 ``pos_embed``, random biases and norm parameters so that a swapped
  or dropped tensor shows), goes through the JAX ``convert_state`` and the
  port's ``load_omnidata_checkpoint``: every tensor maps on both sides; a
  small DPT (2 blocks, hooks (0, 1)) at 64x64 agrees in its three backbone
  outputs and its depth to rel-L2 <= 1e-4 (the bound of
  ``test_parity_dpt.py``; the JAX side at float32 matmul precision); the
  JAX params carried back through ``dpt_params_to_state_dict`` equal the
  port's loaded state dict exactly (``pos_embed``, resized by each loader,
  to 1e-6).
* At 64x96 (a non-square grid) the JAX model's own random init is carried
  into the port by ``dpt_params_to_state_dict``: depth to rel-L2 <= 1e-4.
* ``resize_pos_embed`` against the JAX importer's: 1e-6.
* ``mono_prior.resize`` against ``jax.image.resize`` (antialiased) for the
  two resizes of ``predict``: 1e-4 (float32 filter sums).
* ``MonoDepthEstimator.predict`` at ``infer_size=64`` with the small DPT
  from the same checkpoint: rel-L2 <= 1e-4, with most pixels inside (0, 1)
  so that the clamps do not hide the comparison; each package reads the
  other's ``.npy`` cache exactly.
* The cadence: the frames a recording predictor sees in both packages'
  motion filters over an 8-frame 64x96 stream, every frame admitted or
  only the first: equal lists.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glorie_slam_tpu.mapping.mono_prior as jmono_mod
from glorie_slam_tpu.core.depth_video import DepthVideo as JVideo
from glorie_slam_tpu.mapping import dpt as jdpt
from glorie_slam_tpu.mapping import import_dpt as jimport
from glorie_slam_tpu.nets.tracker_net import TrackerNet as JNet
from glorie_slam_tpu.tracking.motion_filter import MotionFilter as JFilter
from glorie_slam_tpu_torch.core.depth_video import DepthVideo
from glorie_slam_tpu_torch.mapping import dpt, mono_prior
from glorie_slam_tpu_torch.mapping.import_dpt import (
    load_omnidata_checkpoint, resize_pos_embed)
from glorie_slam_tpu_torch.nets.import_flax import dpt_params_to_state_dict
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.tracking.motion_filter import MotionFilter
from synthetic import SyntheticStream, base_cfg
from torch_parity import n, t

SMALL = dict(n_blocks=2, hooks=(0, 1))
F32 = "float32"


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def nhwc(x):
    return n(x).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("k,stride,side", [(7, 2, 16), (3, 2, 15),
                                           (3, 1, 15), (1, 2, 16)])
def test_std_conv_matches_jax(k, stride, side):
    rng = np.random.default_rng(k + stride)
    x = rng.normal(size=(1, side, side + 2, 5)).astype(np.float32)
    jm = jdpt.StdConv(8, k, stride)
    params = jm.init(jax.random.PRNGKey(k), jnp.asarray(x))
    with jax.default_matmul_precision(F32):
        ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    conv = dpt.StdConv(5, 8, k, stride)
    with torch.no_grad():
        conv.weight.copy_(t(np.transpose(
            np.asarray(params["params"]["kernel_raw"]), (3, 2, 0, 1))))
        out = nhwc(conv(t(x).permute(0, 3, 1, 2)))
    assert out.shape == ref.shape
    assert rel_l2(out, ref) <= 1e-5


def write_checkpoint(path, seed=3):
    """A checkpoint in the omnidata layout for the small DPT at 64x64:
    ``model.``-prefixed keys under ``state_dict``, ``pos_embed`` on the
    24x24 grid of the 384-pixel training size, every tensor random."""
    g = torch.Generator().manual_seed(seed)
    model = dpt.DPTDepthModel(**SMALL, size=64, seed=seed)
    state = {}
    for k, v in model.state_dict().items():
        if k.endswith("pos_embed"):
            v = 0.02 * torch.randn((1, 577, v.shape[-1]), generator=g)
        elif v.dim() == 1 or k.endswith("cls_token"):
            base = 1.0 if (v.dim() == 1 and "norm" in k
                           and k.endswith("weight")) else 0.0
            v = base + 0.1 * torch.randn(v.shape, generator=g)
        state["model." + k] = v.clone()
    # a head that keeps most depths inside (0, 1), where neither the ReLU
    # nor the clamps hide a disagreement
    state["model.scratch.output_conv.4.weight"] *= 0.05
    state["model.scratch.output_conv.4.bias"] = torch.tensor([0.3])
    torch.save({"state_dict": state}, path)
    return {k[6:]: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """The checkpoint through both loaders: (path, JAX model, JAX params,
    port model)."""
    path = str(tmp_path_factory.mktemp("dpt") / "omnidata_like.ckpt")
    state = write_checkpoint(path)
    jm = jdpt.DPTDepthModel(**SMALL)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params, report = jimport.convert_state(state, init)
    assert not report["unmapped"] and not report["mismatched"], report
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert report["loaded"] == len(state) == n_leaves
    pm = load_omnidata_checkpoint(path, dpt.DPTDepthModel(**SMALL, size=64))
    return path, jm, params, pm


def test_dpt_checkpoint_matches_jax(loaded):
    _, jm, params, pm = loaded
    x = np.random.default_rng(1).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32)
    with jax.default_matmul_precision(F32):
        jout = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
        j0, j1, jf = jax.jit(jdpt.ResNetStem().apply)(
            {"params": params["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        xt = t(x).permute(0, 3, 1, 2)
        taps = pm.taps(xt)
        _, _, feat = pm.pretrained.model.patch_embed.backbone(xt)
    for name, a, b in (("hook0", taps["hook0"], j0),
                       ("hook1", taps["hook1"], j1), ("stage2", feat, jf)):
        assert rel_l2(nhwc(a), b) <= 1e-4, name
    inside = ((jout > 0) & (jout < 1)).mean()
    assert inside > 0.5, inside
    assert rel_l2(n(taps["depth"]), jout) <= 1e-4


def test_dpt_params_carry_back_exactly(loaded):
    """Checkpoint -> JAX ``convert_state`` -> ``dpt_params_to_state_dict``
    gives the port loader's state dict, tensor for tensor; ``pos_embed``,
    which each loader resizes with its own interpolation, to 1e-6."""
    _, _, params, pm = loaded
    ref = pm.state_dict()
    carried = dpt_params_to_state_dict(params, ref.keys())
    assert carried.keys() == ref.keys()
    for k, v in ref.items():
        if k.endswith("pos_embed"):
            np.testing.assert_allclose(n(carried[k]), n(v), atol=1e-6)
        else:
            np.testing.assert_array_equal(n(carried[k]), n(v), err_msg=k)


def test_dpt_non_square_grid_matches_jax():
    H, W = 64, 96
    jm = jdpt.DPTDepthModel(**SMALL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, H, W, 3)))
    x = np.random.default_rng(2).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    with jax.default_matmul_precision(F32):
        jout = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    pm = dpt.DPTDepthModel(**SMALL, size=(H, W))
    pm.load_state_dict(dpt_params_to_state_dict(params,
                                                pm.state_dict().keys()))
    with torch.no_grad():
        out = n(pm(t(x).permute(0, 3, 1, 2)))
    assert out.shape == jout.shape == (1, H, W)
    assert rel_l2(out, jout) <= 1e-4


@pytest.mark.parametrize("side", [8, 32])
def test_pos_embed_resize_matches_jax(side):
    pos = np.random.default_rng(side).normal(
        0, 0.02, (1, 577, 16)).astype(np.float32)
    ref = jimport._resize_pos_embed(pos, side * side + 1, 16)
    out = n(resize_pos_embed(t(pos), (side, side)))
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("src,dst,mode", [
    ((40, 80, 3), (64, 64, 3), "bilinear"),
    ((64, 64), (40, 80), "bicubic"),
    ((37, 50, 3), (64, 64, 3), "bilinear"),
    ((64, 64), (37, 50), "bicubic"),
])
def test_resize_matches_jax_image_resize(src, dst, mode):
    x = np.random.default_rng(len(src)).uniform(0, 1, src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, mode))
    xt = t(x)
    if xt.dim() == 3:
        out = n(mono_prior.resize(xt.permute(2, 0, 1), dst[:2], mode)
                .permute(1, 2, 0))
    else:
        out = n(mono_prior.resize(xt, dst, mode))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _prior_cfg(out, ckpt):
    cfg = base_cfg(H=48, W=80, out=out)
    cfg["mono_prior"] = {"depth": "omnidata", "depth_pretrained": ckpt,
                         "predict_online": True}
    return cfg


def test_predict_and_cache_match_jax(loaded, tmp_path, monkeypatch):
    path = loaded[0]
    cfg = _prior_cfg(str(tmp_path), path)
    monkeypatch.setattr(jmono_mod, "DPTDepthModel",
                        functools.partial(jdpt.DPTDepthModel, **SMALL))
    monkeypatch.setattr(mono_prior, "DPTDepthModel",
                        functools.partial(dpt.DPTDepthModel, **SMALL))
    with jax.default_matmul_precision(F32):
        jest = jmono_mod.MonoDepthEstimator(cfg, infer_size=64)
        est = mono_prior.MonoDepthEstimator(cfg, infer_size=64, device="cpu")
        img = np.random.default_rng(4).uniform(0, 1, (48, 80, 3)).astype(
            np.float32)
        ref = jest.predict(img)
        out = n(est.predict(img))
        assert out.shape == ref.shape == (48, 80)
        assert ((ref > 0) & (ref < 1)).mean() > 0.5
        assert rel_l2(out, ref) <= 1e-4
        # each package reads the other's cache, bit for bit
        mine = n(est.predict_and_cache(3, img))
        np.testing.assert_array_equal(jest.predict_and_cache(3, img), mine)
        theirs = jest.predict_and_cache(5, img)
        got = est.predict_and_cache(5, img)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, theirs)
    assert sorted(os.listdir(est.out_dir)) == ["00003.npy", "00005.npy"]


@pytest.mark.parametrize("thresh,expected", [(0.0, list(range(8))),
                                             (1e9, [0, 3, 6])])
def test_online_cadence_matches_jax(thresh, expected):
    """Every third frame is predicted whether it is admitted or not; an
    admitted frame off the cadence is predicted at admission; an admitted
    frame on it reuses the cadence's prediction."""
    H, W = 64, 96
    stream = SyntheticStream(n_frames=8, H=H, W=W, seed=2)
    cfg = base_cfg(H=H, W=W, buffer=16)
    cfg["mono_prior"] = {"predict_online": True}
    cfg["mapping"]["every_frame"] = 3
    calls = {"jax": [], "port": []}

    def recorder(side):
        def predict(tstamp, image):
            calls[side].append(int(tstamp))
            return np.full((H, W), 2.0, np.float32)
        return predict

    jmf = JFilter(JNet(), JVideo(cfg), cfg, thresh=thresh,
                  mono_predictor=recorder("jax"))
    mf = MotionFilter(TrackerNet(device="cpu"), DepthVideo(cfg, device="cpu"),
                      thresh=thresh,
                      mono_predictor=recorder("port"), predict_every=3)
    for i in range(len(stream)):
        tstamp, image = stream[i][0], stream[i][1]
        jmf.track(tstamp, jnp.asarray(image), stream.intrinsics)
        mf.track(tstamp, image, stream.intrinsics)
    assert calls["jax"] == calls["port"] == expected

