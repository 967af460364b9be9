"""Port parity: kernel A's module (ops/corr.py feature-store lookup).

The port's plain version of kernel A is held against the TPU kernel run
in interpret mode and against the JAX package's CPU path, on bf16 feature
stores. Both sides accumulate the 128-term dot products in float32 and
differ only in order; the port rounds its output to bf16 as the TPU
kernel does, so tolerances are one bf16 ulp of O(1) values (2e-2
absolute, 1e-2 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.ops import corr as jcorr, pallas_corr
from glorie_slam_tpu_torch.ops import corr, cuda_corr
from torch_parity import n, t

BF = torch.bfloat16


def _stores(rng, N, h0, w0, C=128):
    f = rng.normal(size=(N, h0, w0, C)).astype(np.float32)
    jpyr = jcorr.prep_feat_pyramid(jnp.asarray(f, jnp.bfloat16))
    ppyr = corr.prep_feat_pyramid(t(f).to(BF))
    return jpyr, ppyr


def test_feature_pyramid_stores_match_jax():
    rng = np.random.default_rng(0)
    jpyr, ppyr = _stores(rng, 3, 10, 14)
    npix = 10 * 14
    np.testing.assert_array_equal(n(ppyr[0]), n(jpyr[0][:, :npix]))
    for a, b in zip(ppyr[1:], jpyr[1:]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("h0,w0", [(16, 16), (10, 14)])
def test_lookup_plain_matches_pallas_interpret(h0, w0):
    """Plain kernel-A version == lookup_feats_pyramid_pallas (interpret),
    with NaN and out-of-plane centres in the coords."""
    rng = np.random.default_rng(1)
    N, E = 4, 3
    jpyr, ppyr = _stores(rng, N, h0, w0)
    npix = h0 * w0
    coords = np.stack([rng.uniform(-6, w0 + 6, (E, npix)),
                       rng.uniform(-6, h0 + 6, (E, npix))], -1)
    coords = coords.astype(np.float32)
    coords[0, :5] = np.nan
    iis = np.array([0, 3, 1], np.int32)
    jjs = np.array([2, 1, 1], np.int32)

    N_, npix_pad, C = jpyr[0].shape
    dims = ((h0, w0),) + tuple((p.shape[1], p.shape[2]) for p in jpyr[1:])
    stores = (jpyr[0],) + tuple(p.reshape(N_, -1, C) for p in jpyr[1:])
    cpad = np.concatenate(
        [coords, np.repeat(coords[:, -1:], npix_pad - npix, 1)], 1)
    ref = pallas_corr.lookup_feats_pyramid_pallas(
        jpyr[0], stores, jnp.asarray(iis), jnp.asarray(jjs),
        jnp.asarray(cpad), dims, interpret=True)[:, :npix]

    f2 = (ppyr[0].reshape(N, h0, w0, C),) + tuple(ppyr[1:])
    out = cuda_corr.lookup_pyramid_plain(
        ppyr[0], f2, torch.as_tensor(iis), torch.as_tensor(jjs), t(coords))
    assert out.dtype == BF and out.shape == (E, npix, 196)
    np.testing.assert_allclose(n(out), n(ref).astype(np.float32),
                               atol=2e-2, rtol=1e-2)


def test_lookup_pyramid_feats_matches_jax_cpu_path():
    """corr.lookup_pyramid_feats (CPU wrapper -> plain version) == the JAX
    package's CPU fallback, after the bf16 cast every consumer applies."""
    rng = np.random.default_rng(2)
    N, E, h0, w0 = 5, 4, 12, 16
    jpyr, ppyr = _stores(rng, N, h0, w0)
    coords = rng.uniform(-2, 14, (E, h0, w0, 2)).astype(np.float32)
    iis = np.array([0, 2, 3, 4])
    jjs = np.array([1, 3, 0, 4])
    ref = jcorr.lookup_pyramid_feats(jpyr, jnp.asarray(iis),
                                     jnp.asarray(jjs), jnp.asarray(coords))
    out = corr.lookup_pyramid_feats(ppyr, torch.as_tensor(iis),
                                    torch.as_tensor(jjs), t(coords))
    ref = n(ref.astype(jnp.bfloat16)).astype(np.float32)
    np.testing.assert_allclose(n(out), ref, atol=2e-2, rtol=1e-2)


def test_lookup_wrapper_rejects_unsupported_device():
    """A tensor on neither the CPU nor a CUDA device never reaches the
    plain version silently."""
    f1 = torch.zeros((1, 4, 128), dtype=BF, device="meta")
    with pytest.raises(ValueError):
        cuda_corr.lookup_pyramid(f1, (f1,) * 4, None, None, None)
