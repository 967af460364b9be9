"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests skip without a CUDA device; on the card's machine, which
has no JAX, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel A and its plain version both accumulate in float32 and
round to bf16, so they differ by at most ~2 bf16 ulps; kernel B is exact
except on pixels whose |izd - 1/c| lies within float rounding of thr.
"""

import pytest
import torch

from glorie_slam_tpu_torch.ops import corr, cuda_corr, depth_filter

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card's machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("h0,w0,E", [(40, 80, 24), (6, 8, 5), (10, 14, 7)])
def test_lookup_pyramid_matches_plain(dev, h0, w0, E):
    g = torch.Generator().manual_seed(h0 * w0)
    N = 6
    fm = torch.randn((N, h0, w0, 128), generator=g).to(dev, torch.bfloat16)
    pyr = corr.prep_feat_pyramid(fm)
    f2 = (pyr[0].reshape(N, h0, w0, 128),) + tuple(pyr[1:])
    iis = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    jjs = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    coords = torch.rand((E, h0 * w0, 2), generator=g) * torch.tensor(
        [w0 + 12.0, h0 + 12.0]) - 6.0
    coords[0, :3] = float("nan")
    coords = coords.to(dev)
    before = cuda_corr.LOOKUP_PYRAMID.launches
    out = cuda_corr.lookup_pyramid(pyr[0], f2, iis, jjs, coords)
    assert cuda_corr.LOOKUP_PYRAMID.launches == before + 1
    ref = cuda_corr.lookup_pyramid_plain(pyr[0], f2, iis, jjs, coords)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=8e-3)


def test_depth_agree_matches_plain(dev):
    from glorie_slam_tpu_torch.geom import lie
    g = torch.Generator().manual_seed(0)
    N, ht, wd = 8, 48, 64
    poses = lie.exp(torch.cumsum(0.03 * torch.randn((N, 6), generator=g),
                                 0)).to(dev)
    disps = (0.5 + 0.4 * torch.rand((N, ht, wd), generator=g)).to(dev)
    intr = torch.tensor([51.2, 51.2, 31.5, 23.5], device=dev)
    inds = torch.arange(N, device=dev)
    jx, _, cu = depth_filter.pack_agreement_inputs(
        poses, disps, intr, inds, torch.full((N,), 0.05, device=dev))
    before = cuda_corr.DEPTH_AGREE.launches
    out = cuda_corr.depth_agree(disps, jx, cu)
    assert cuda_corr.DEPTH_AGREE.launches == before + 1
    ref = cuda_corr.depth_agree_plain(disps, jx, cu)
    assert (out != ref).float().mean().item() <= 1e-4


def test_wrappers_raise_on_bad_inputs(dev):
    f1 = torch.zeros((2, 12, 128), dtype=torch.float32, device=dev)
    lv = (f1.reshape(2, 3, 4, 128),) * 4
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cuda_corr.lookup_pyramid(f1, lv, idx, idx,
                                 torch.zeros((1, 12, 2), device=dev))
    d = torch.zeros((2, 4, 4), device=dev)
    with pytest.raises(ValueError):
        cuda_corr.depth_agree(d, torch.zeros((1, 6), dtype=torch.int32,
                                             device=dev),
                              torch.zeros((1, 24, 15), device=dev))
