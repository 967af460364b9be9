"""Port parity: DroidNet modules and the convex upsample against the JAX
package, through the weight carrier (random JAX weights -> state_dict).

Both sides compute in float32 (JAX side ``dtype=jnp.float32``). JAX's CPU
convolutions and PyTorch's accumulate in different orders over up to
3*3*448 terms, so activations agree to ~1e-4 relative; tolerances are
2e-3 absolute on O(1) activations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.nets.droid_net import DroidNet as JDroidNet
from glorie_slam_tpu.nets.import_torch import params_to_torch_state
from glorie_slam_tpu.ops import upsample as jup
from glorie_slam_tpu_torch.nets.droid_net import DroidNet
from glorie_slam_tpu_torch.nets.import_flax import flax_params_to_state_dict
from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
from glorie_slam_tpu_torch.ops import upsample
from torch_parity import n, t

ATOL = 2e-3


@pytest.fixture(scope="module")
def nets():
    jm = JDroidNet(dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tn = TrackerNet(flax_params_to_state_dict(params), dtype=torch.float32,
                    device="cpu")
    return jm, params, tn


def test_weight_carrier_names_match_reference_layout(nets):
    """Every port parameter is carried, under the reference (droid.pth)
    names that the JAX package's own importer produces."""
    _, params, tn = nets
    carried = flax_params_to_state_dict(params)
    ref_names = set(params_to_torch_state(params))
    assert set(carried) == ref_names == set(DroidNet().state_dict())
    for k, v in params_to_torch_state(params).items():
        np.testing.assert_array_equal(carried[k].numpy(), v)


def test_encoders_match_jax(nets):
    jm, params, tn = nets
    img = np.random.default_rng(0).normal(size=(2, 32, 48, 3)).astype(
        np.float32)
    jf = jm.apply(params, jnp.asarray(img), method=jm.features)
    jnet, jinp = jm.apply(params, jnp.asarray(img), method=jm.context)
    x = t(img).permute(0, 3, 1, 2)
    pf = tn.features(x).permute(0, 2, 3, 1)
    pnet, pinp = (y.permute(0, 2, 3, 1) for y in tn.context(x))
    for a, b in ((pf, jf), (pnet, jnet), (pinp, jinp)):
        np.testing.assert_allclose(n(a), n(b), atol=ATOL, rtol=1e-3)


def test_update_and_agg_match_jax(nets):
    jm, params, tn = nets
    rng = np.random.default_rng(1)
    E, h, w = 5, 6, 8
    net = np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, h, w, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(E, h, w, 196)).astype(np.float32)
    flow = rng.normal(size=(E, h, w, 4)).astype(np.float32)
    kk = np.array([0, 1, 1, 2, 0])
    jo = jm.apply(params, *map(jnp.asarray, (net, inp, corr, flow)),
                  jnp.asarray(kk), 3, None, method=jm.update_step)
    nchw = [t(a).permute(0, 3, 1, 2) for a in (net, inp, corr, flow)]
    po = tn.update(*nchw, kk=torch.as_tensor(kk), num_frames=3)
    np.testing.assert_allclose(n(po[0].permute(0, 2, 3, 1)), n(jo[0]),
                               atol=ATOL)
    np.testing.assert_allclose(n(po[1].permute(0, 2, 3, 1)), n(jo[1]),
                               atol=ATOL)
    np.testing.assert_allclose(n(po[2].permute(0, 2, 3, 1)), n(jo[2]),
                               atol=ATOL)
    np.testing.assert_allclose(n(po[3]), n(jo[3]), atol=1e-4)
    np.testing.assert_allclose(n(po[4]), np.moveaxis(n(jo[4]), -1, 1),
                               atol=ATOL)


def test_cvx_upsample_matches_jax():
    rng = np.random.default_rng(2)
    B, h, w = 3, 5, 7
    disp = rng.random((B, h, w)).astype(np.float32)
    mask = rng.normal(size=(B, 576, h, w)).astype(np.float32)
    ref = jup.upsample_disp(jnp.asarray(disp), jnp.asarray(mask))
    out = upsample.upsample_disp(t(disp), t(mask))
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5)


def test_entry_points_default_to_the_card():
    """Without a CUDA device the entry points raise unless the caller asks
    for the CPU."""
    from glorie_slam_tpu_torch.core.depth_video import DepthVideo
    from glorie_slam_tpu_torch.utils.synthetic import base_cfg

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TrackerNet(seed=0)
    with pytest.raises(RuntimeError):
        DepthVideo(base_cfg(H=16, W=16, buffer=2))
    assert DepthVideo(base_cfg(H=16, W=16, buffer=2),
                      device="cpu").device.type == "cpu"
