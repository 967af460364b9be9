"""Port parity: kernels C, D and E and the correlation-volume path.

Kernels C (``lookup_level``), D (``lookup_plane``) and E
(``lookup_plane_slots``) in their plain versions are held against the TPU
kernels run in interpret mode; the volume path of ``ops/corr.py``
(all-pairs volumes, pyramids, ``lookup_pyramid``, ``CorrBlock`` and
``alt_corr_chunk``) against the JAX package's CPU path, on the same numpy
inputs.

Tolerances: kernels C, D and E and their plain versions sum float32
products of the same bf16 (or float32) values, differing only in order:
1e-4 absolute and relative. Where both sides round a float32 sum to a bf16
store (the pixel-minor volume), a rounding can land one bf16 ulp apart:
1e-2 absolute and relative, as for kernel A.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glorie_slam_tpu.ops import corr as jcorr, pallas_corr
from glorie_slam_tpu_torch.ops import corr, cuda_corr
from torch_parity import n, t

BF = torch.bfloat16
TIGHT = dict(atol=1e-4, rtol=1e-4)
BF16_ULP = dict(atol=1e-2, rtol=1e-2)


def _coords(rng, E, npix, w, h, nan=True):
    c = np.stack([rng.uniform(-6, w + 6, (E, npix)),
                  rng.uniform(-6, h + 6, (E, npix))], -1).astype(np.float32)
    if nan:
        c[0, :5] = np.nan
    return c


# ---------------------------------------------------------------------------
# kernels C, D, E (plain versions) against the TPU kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_lookup_level_plain_matches_pallas_interpret(lvl):
    """Kernel C: one level's window from feature stores, coords in level
    units, float32 out; npix 8 x 16 = 128, a lane multiple for the TPU
    kernel, with NaN and out-of-plane centres."""
    rng = np.random.default_rng(20 + lvl)
    N, E, h0, w0 = 4, 3, 8, 16
    f = rng.normal(size=(N, h0, w0, 128)).astype(np.float32)
    jpyr = jcorr.prep_feat_pyramid(jnp.asarray(f, jnp.bfloat16))
    ppyr = corr.prep_feat_pyramid(t(f).to(BF))
    hl, wl = (h0, w0) if lvl == 0 else ppyr[lvl].shape[1:3]
    coords = _coords(rng, E, h0 * w0, wl, hl)
    iis = np.array([0, 3, 1], np.int32)
    jjs = np.array([2, 1, 1], np.int32)
    jf2 = jpyr[lvl].reshape(N, hl * wl, 128)
    ref = pallas_corr.lookup_feats_pallas(
        jpyr[0], jf2, jnp.asarray(iis), jnp.asarray(jjs),
        jnp.asarray(coords), hl, wl, interpret=True)
    out = cuda_corr.lookup_level_plain(
        ppyr[0], ppyr[lvl].reshape(N, hl * wl, 128), torch.as_tensor(iis),
        torch.as_tensor(jjs), t(coords), hl, wl)
    assert out.dtype == torch.float32 and out.shape == (E, h0 * w0, 49)
    np.testing.assert_allclose(n(out), n(ref), **TIGHT)


@pytest.mark.parametrize("hl,wl", [(8, 16), (16, 12)])
def test_lookup_plane_plain_matches_pallas_interpret(hl, wl):
    """Kernel D over bf16 pixel-minor planes; (16, 12) takes the TPU
    kernel's banded path (16 rows > its 12-row band)."""
    rng = np.random.default_rng(hl * wl)
    E, npix = 3, 128
    planes = rng.normal(size=(E, hl, wl, npix)).astype(np.float32)
    jplanes = jnp.asarray(planes, jnp.bfloat16)
    coords = _coords(rng, E, npix, wl, hl)
    ref = pallas_corr.lookup_pallas(jplanes, jnp.asarray(coords),
                                    interpret=True)
    out = cuda_corr.lookup_plane(t(n(jplanes).astype(np.float32)).to(BF),
                                 t(coords))
    assert out.dtype == torch.float32 and out.shape == (E, npix, 49)
    np.testing.assert_allclose(n(out), n(ref), **TIGHT)


def test_lookup_plane_slots_plain_matches_pallas_interpret():
    """Kernel E: edge e reads store row slots[e] (a shuffled subset)."""
    rng = np.random.default_rng(5)
    S, E, hl, wl, npix = 8, 5, 10, 12, 128
    store = jnp.asarray(rng.normal(size=(S, hl, wl, npix)), jnp.bfloat16)
    slots = rng.permutation(S)[:E].astype(np.int32)
    coords = _coords(rng, E, npix, wl, hl)
    ref = pallas_corr.lookup_pallas_slots(store, jnp.asarray(slots),
                                          jnp.asarray(coords),
                                          interpret=True)
    out = cuda_corr.lookup_plane_slots(
        t(n(store).astype(np.float32)).to(BF), torch.as_tensor(slots),
        t(coords))
    np.testing.assert_allclose(n(out), n(ref), **TIGHT)


# ---------------------------------------------------------------------------
# the volume path against the JAX package's CPU path
# ---------------------------------------------------------------------------

def _fmaps(rng, N=5, C=16, ht=12, wd=16):
    return rng.normal(size=(N, C, ht, wd)).astype(np.float32)


def test_all_pairs_and_pyramids_match_jax():
    rng = np.random.default_rng(6)
    f = _fmaps(rng)
    a, b = f[[0, 2, 3]], f[[1, 3, 0]]
    ref = jcorr.all_pairs_corr(jnp.asarray(a), jnp.asarray(b))
    out = corr.all_pairs_corr(t(a), t(b))
    np.testing.assert_allclose(n(out), n(ref), **TIGHT)
    for r, o in zip(jcorr.build_pyramid(ref), corr.build_pyramid(out)):
        assert r.shape == o.shape
        np.testing.assert_allclose(n(o), n(r), **TIGHT)
    ref_l = jcorr.all_pairs_corr_lanes(jnp.asarray(a), jnp.asarray(b))
    out_l = corr.all_pairs_corr_lanes(t(a), t(b))
    assert out_l.dtype == BF and out_l.shape == ref_l.shape
    for r, o in zip(jcorr.build_pyramid_lanes(ref_l),
                    corr.build_pyramid_lanes(out_l)):
        assert r.shape == o.shape
        np.testing.assert_allclose(n(o), n(r).astype(np.float32),
                                   **BF16_ULP)


def test_lookup_gather_matches_jax_and_separable():
    rng = np.random.default_rng(7)
    E, npix, hl, wl = 2, 20, 6, 9
    plane = rng.normal(size=(E, npix, hl, wl)).astype(np.float32)
    coords = _coords(rng, E, npix, wl, hl, nan=False)
    ref = jcorr.lookup_gather(jnp.asarray(plane), jnp.asarray(coords))
    out = corr.lookup_gather(t(plane), t(coords))
    np.testing.assert_allclose(n(out), n(ref), **TIGHT)
    np.testing.assert_allclose(
        n(corr.lookup_separable(t(plane), t(coords))), n(out), **TIGHT)


@pytest.mark.parametrize("with_slots", [False, True])
def test_lookup_pyramid_matches_jax(with_slots):
    rng = np.random.default_rng(8)
    f = _fmaps(rng)
    ht, wd = f.shape[2:]
    E = 4
    S = 6 if with_slots else E
    ii, jj = rng.integers(0, 5, S), rng.integers(0, 5, S)
    jpyr = jcorr.build_pyramid_lanes(jcorr.all_pairs_corr_lanes(
        jnp.asarray(f[ii]), jnp.asarray(f[jj])))
    ppyr = corr.build_pyramid_lanes(corr.all_pairs_corr_lanes(
        t(f[ii]), t(f[jj])))
    coords = rng.uniform(-2, 16, (E, ht, wd, 2)).astype(np.float32)
    slots = rng.permutation(S)[:E].astype(np.int32) if with_slots else None
    ref = jcorr.lookup_pyramid(
        tuple(jpyr), jnp.asarray(coords),
        slots=None if slots is None else jnp.asarray(slots))
    out = corr.lookup_pyramid(
        ppyr, t(coords), slots=None if slots is None
        else torch.as_tensor(slots))
    assert out.shape == ref.shape == (E, ht, wd, 196)
    np.testing.assert_allclose(n(out), n(ref), **BF16_ULP)


def test_corr_block_bookkeeping_and_lookups_match_jax():
    """A cat that grows the store, a mask removal, an index removal and a
    cat into freed rows give the same slots, capacity, free list and
    lookups on both sides."""
    rng = np.random.default_rng(9)
    f = _fmaps(rng, N=8)
    ht, wd = f.shape[2:]

    def blocks(ii, jj):
        return (jcorr.CorrBlock(jnp.asarray(f[ii]), jnp.asarray(f[jj])),
                corr.CorrBlock(t(f[ii]), t(f[jj])))

    jb, pb = blocks([0, 1, 2, 3, 4], [1, 2, 3, 4, 5])
    assert pb.capacity == jb.capacity == 8
    for step in range(4):
        if step == 0:
            jo, po = blocks([5, 6, 7, 0], [6, 7, 0, 2])  # 4 > 3 free: grow
            jb.cat(jo)
            pb.cat(po)
        elif step == 1:
            keep = np.array([1, 0, 1, 1, 0, 1, 1, 0, 1], bool)
            jb, pb = jb[keep], pb[keep]
        elif step == 2:
            jb, pb = jb[np.array([0, 2, 3, 5])], pb[np.array([0, 2, 3, 5])]
        else:
            jo, po = blocks([2, 4], [7, 6])
            jb.cat(jo)
            pb.cat(po)
        np.testing.assert_array_equal(pb.slots, jb.slots)
        assert pb.capacity == jb.capacity and pb._free == jb._free
        E = len(pb.slots)
        coords = rng.uniform(-2, 16, (E, ht, wd, 2)).astype(np.float32)
        np.testing.assert_allclose(n(pb(t(coords))),
                                   n(jb(jnp.asarray(coords))), **BF16_ULP)
    assert pb.capacity == 16


def test_alt_corr_chunk_matches_jax():
    """Two source tiles (npix 320 > 256): the port's last tile is short
    where the JAX package pads it."""
    rng = np.random.default_rng(10)
    f = _fmaps(rng, N=5, ht=16, wd=20)
    coords = rng.uniform(-2, 18, (3, 16, 20, 2)).astype(np.float32)
    ii, jj = np.array([0, 2, 4]), np.array([1, 3, 0])
    ref = jcorr.alt_corr_chunk(jnp.asarray(f), jnp.asarray(coords),
                               jnp.asarray(ii), jnp.asarray(jj))
    out = corr.alt_corr_chunk(t(f), t(coords), torch.as_tensor(ii),
                              torch.as_tensor(jj))
    assert out.shape == ref.shape == (3, 16, 20, 196)
    np.testing.assert_allclose(n(out), n(ref), **BF16_ULP)


def test_volume_paths_match_feature_path():
    """The identity the card's volume phase holds (tests/test_ops.py:261
    in the JAX package): CorrBlock (kernel E), lookup_pyramid without
    slots (D) and alt_corr_chunk (D) equal the feature-store lookup (A) on
    the same frames. bf16 volumes against bf16 pooled features: 5e-2."""
    rng = np.random.default_rng(11)
    N, C, ht, wd = 5, 128, 16, 16
    f = rng.normal(size=(N, C, ht, wd)).astype(np.float32)
    ii, jj = np.array([0, 2, 3]), np.array([1, 3, 0])
    coords = t(rng.uniform(1, 13, (3, ht, wd, 2)).astype(np.float32))
    fb = t(f).to(BF)
    pyr = corr.prep_feat_pyramid(fb.permute(0, 2, 3, 1).contiguous())
    feat = n(corr.lookup_pyramid_feats(pyr, torch.as_tensor(ii),
                                       torch.as_tensor(jj), coords))
    block = corr.CorrBlock(fb[ii], fb[jj])
    vol = corr.build_pyramid_lanes(corr.all_pairs_corr_lanes(fb[ii], fb[jj]))
    for other in (block(coords), corr.lookup_pyramid(vol, coords),
                  corr.alt_corr_chunk(fb, coords, ii, jj)):
        np.testing.assert_allclose(n(other), feat.astype(np.float32),
                                   atol=5e-2, rtol=5e-2)


def test_three_level_feature_lookup_matches_jax_and_four_levels():
    """lookup_pyramid_feats on a 3-level store (kernel C per level) equals
    the JAX package's CPU path and the first 147 channels of the 4-level
    lookup (kernel A, rounded to bf16)."""
    rng = np.random.default_rng(12)
    N, E, h0, w0 = 4, 3, 16, 16
    f = rng.normal(size=(N, h0, w0, 128)).astype(np.float32)
    iis, jjs = np.array([0, 2, 3]), np.array([1, 3, 0])
    coords = rng.uniform(-2, 18, (E, h0, w0, 2)).astype(np.float32)
    jpyr = jcorr.prep_feat_pyramid(jnp.asarray(f, jnp.bfloat16), 3)
    ppyr = corr.prep_feat_pyramid(t(f).to(BF), 3)
    ref = jcorr.lookup_pyramid_feats(jpyr, jnp.asarray(iis),
                                     jnp.asarray(jjs), jnp.asarray(coords))
    out = corr.lookup_pyramid_feats(ppyr, torch.as_tensor(iis),
                                    torch.as_tensor(jjs), t(coords))
    assert out.dtype == torch.float32 and out.shape == (E, h0, w0, 147)
    np.testing.assert_allclose(n(out), n(ref), **TIGHT)
    four = corr.lookup_pyramid_feats(corr.prep_feat_pyramid(t(f).to(BF)),
                                     torch.as_tensor(iis),
                                     torch.as_tensor(jjs), t(coords))
    np.testing.assert_allclose(n(four)[..., :147], n(out), atol=1e-2,
                               rtol=8e-3)


@pytest.mark.parametrize("bad", [3, -1])
def test_slot_lookups_reject_slots_outside_the_store(bad):
    """Kernel E reads ``slots[e]`` unchecked, so the wrapper checks the
    range for every caller: ``lookup_plane_slots``, ``lookup_pyramid`` and
    ``CorrBlock``."""
    rng = np.random.default_rng(11)
    store = t(rng.standard_normal((3, 2, 4, 8)))
    coords = t(rng.uniform(0, 4, (2, 8, 2)))
    slots = torch.tensor([0, bad], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside a store of 3 rows"):
        cuda_corr.lookup_plane_slots(store, slots, coords)
    with pytest.raises(ValueError, match="outside a store"):
        corr.lookup_pyramid([store], coords.reshape(2, 2, 4, 2), slots)
    f = t(rng.standard_normal((2, 8, 2, 4)))
    block = corr.CorrBlock(f, f)
    block.slots = np.array([0, block.capacity if bad > 0 else bad])
    with pytest.raises(ValueError, match="outside a store"):
        block(coords.reshape(2, 2, 4, 2))


def test_plane_wrappers_reject_unsupported_device():
    planes = torch.zeros((1, 2, 2, 4), dtype=BF, device="meta")
    coords = torch.zeros((1, 4, 2), device="meta")
    with pytest.raises(ValueError):
        cuda_corr.lookup_plane(planes, coords)
    with pytest.raises(ValueError):
        cuda_corr.lookup_plane_slots(
            planes, torch.zeros(1, dtype=torch.int32, device="meta"), coords)
    with pytest.raises(ValueError):
        cuda_corr.lookup_level(torch.zeros((1, 4, 128), dtype=BF,
                                           device="meta"),
                               torch.zeros((1, 4, 128), dtype=BF,
                                           device="meta"),
                               None, None, coords, 2, 2)
