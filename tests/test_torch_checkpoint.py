"""Checkpoints the port loads, against the JAX package's loaders, from
stand-in files written here (neither ``droid.pth`` nor ``middle_fine.pt``
is in the repository):

* ``droid.pth``: random JAX DroidNet weights in the reference layout
  (``params_to_torch_state``), the two heads widened to 3 output rows and
  every key prefixed with ``module.``, as the published file is. Both
  packages load it; the port's state_dict equals the carried JAX weights
  exactly, and the encoders' activations agree to 2e-3 (as in
  ``test_torch_nets.py``). ``SLAM`` with ``tracking.pretrained`` loads it.
* ``middle_fine.pt``: a ``{"model": ...}`` dict with the reference's
  ``coarse_decoder.`` geometry-decoder keys, a key of the wrong shape, and
  keys of other modules. Both importers merge the same entries (exactly);
  the ``Mapper`` with ``mapping.pretrained`` loads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from glorie_slam_tpu.mapping.import_pointslam import \
    load_pointslam_geo_decoder as jload_geo
from glorie_slam_tpu.nets.droid_net import DroidNet as JDroidNet
from glorie_slam_tpu.nets.import_torch import params_to_torch_state
from glorie_slam_tpu.nets.tracker_net import TrackerNet as JTrackerNet
from glorie_slam_tpu_torch.mapping.decoders import PointDecoders
from glorie_slam_tpu_torch.mapping.import_pointslam import \
    load_pointslam_geo_decoder
from glorie_slam_tpu_torch.mapping.mapper import Mapper
from glorie_slam_tpu_torch.nets.import_flax import (
    decoder_params_to_state_dict, flax_params_to_state_dict)
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.slam import SLAM
from glorie_slam_tpu_torch.utils.printer import Printer
from glorie_slam_tpu_torch.utils.synthetic import SyntheticStream, base_cfg
from synthetic import base_cfg as jbase_cfg
from torch_parity import SlamShim, n, oracle_videos, t

HEADS = ("update.weight.2", "update.delta.2")


def _droid_pth(path):
    jm = JDroidNet(dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(0)
    state = {k: np.array(v) for k, v in params_to_torch_state(params).items()}
    for head in HEADS:
        for part in ("weight", "bias"):
            v = state[f"{head}.{part}"]
            state[f"{head}.{part}"] = np.concatenate(
                [v, rng.normal(size=(1,) + v.shape[1:]).astype(np.float32)])
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in state.items()},
               path)
    return jm, params


def test_droid_checkpoint_loads_in_both_packages(tmp_path):
    path = str(tmp_path / "droid.pth")
    jm, params = _droid_pth(path)
    jnet = JTrackerNet.from_checkpoint(path, dtype=jnp.float32)
    tn = TrackerNet.from_checkpoint(path, dtype=torch.float32, device="cpu")
    want = flax_params_to_state_dict(params)
    got = tn.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(n(got[k]), n(want[k]), err_msg=k)
    assert got["update.weight.2.weight"].shape[0] == 2
    img = np.random.default_rng(1).normal(size=(2, 32, 48, 3)).astype(
        np.float32)
    jf = jnet.features(jnp.asarray(img))
    jnet_out, jinp = jnet.context(jnp.asarray(img))
    x = t(img).permute(0, 3, 1, 2)
    pf = tn.features(x).permute(0, 2, 3, 1)
    pnet, pinp = (y.permute(0, 2, 3, 1) for y in tn.context(x))
    for a, b in ((pf, jf), (pnet, jnet_out), (pinp, jinp)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=2e-3, rtol=1e-3)


def test_slam_loads_tracking_pretrained(tmp_path):
    path = str(tmp_path / "droid.pth")
    _, params = _droid_pth(path)
    cfg = base_cfg(H=64, W=96, buffer=16, out=str(tmp_path / "out"))
    cfg["tracking"]["pretrained"] = path
    slam = SLAM(cfg, SyntheticStream(n_frames=2, H=64, W=96),
                device="cpu")
    got = slam.tracker_net.model.state_dict()
    for k, v in flax_params_to_state_dict(params).items():
        np.testing.assert_array_equal(n(got[k]), n(v), err_msg=k)


def _middle_fine(path, geo_state):
    """A stand-in Point-SLAM checkpoint for the port's geometry decoder
    shapes: returns the entries that must be merged."""
    rng = np.random.default_rng(2)
    model, merged = {}, {}
    for name, v in geo_state.items():
        if not name.startswith("geo_decoder."):
            continue
        part = name[len("geo_decoder."):]
        layer, leaf = part.rsplit(".", 1)
        if layer == "embedder":
            key = "coarse_decoder.embedder._B"
        elif "_" in layer and layer.rsplit("_", 1)[1].isdigit():
            base, i = layer.rsplit("_", 1)
            key = f"coarse_decoder.{base}.{i}.{leaf}"
        else:
            key = f"coarse_decoder.{layer}.{leaf}"
        val = torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
            np.float32))
        if name == "geo_decoder.output_linear.weight":
            val = torch.zeros(2, v.shape[1])          # wrong shape: skipped
        else:
            merged[name] = val
        model[key] = val
    model["fine_decoder.pts_linears.0.weight"] = torch.zeros(32, 93)
    model["encoder.conv.weight"] = torch.zeros(4, 4)
    torch.save({"model": model}, path)
    return merged


def test_pointslam_geo_decoder_loads_in_both_packages(tmp_path):
    path = str(tmp_path / "middle_fine.pt")
    jcfg = jbase_cfg(H=64, W=96, buffer=16, out=str(tmp_path / "out"))
    from glorie_slam_tpu.mapping.decoders import PointDecoders as JDecoders
    jdec = JDecoders(min_nn_num=2)
    dummy = jnp.zeros((8, 3))
    jparams = jax.tree_util.tree_map(np.asarray, jdec.init(
        jax.random.PRNGKey(0), dummy, jnp.ones((8, 8)),
        jnp.zeros((8, 8), jnp.int32), jnp.zeros((8,), jnp.int32),
        jnp.zeros((8, 32)), jnp.zeros((8, 32)), dummy, jnp.asarray(0.01),
        dummy, "color"))["params"]
    start = decoder_params_to_state_dict(jparams)
    merged = _middle_fine(path, start)
    assert len(merged) == 22            # every geometry entry but one
    jout = decoder_params_to_state_dict(jload_geo(path, jparams))
    pout = load_pointslam_geo_decoder(path, start)
    assert set(pout) == set(jout) == set(PointDecoders().state_dict())
    for k in jout:
        np.testing.assert_array_equal(n(pout[k]), n(jout[k]), err_msg=k)
        want = merged.get(k, start[k])
        np.testing.assert_array_equal(n(pout[k]), n(want), err_msg=k)

    # the mapper loads it from mapping.pretrained
    jcfg["mapping"]["pretrained"] = path
    stream = SyntheticStream(n_frames=2, H=64, W=96)
    _, pv = oracle_videos(stream, jcfg, 1)
    mapper = Mapper(SlamShim(jcfg, stream, pv, Printer(0, True)), jcfg)
    got = mapper.decoders.state_dict()
    for k, v in merged.items():
        np.testing.assert_array_equal(n(got[k]), n(v), err_msg=k)
