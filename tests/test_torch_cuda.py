"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests skip without a CUDA device; on the card's machine, which
has no JAX, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel A and its plain version both accumulate in float32 and
round to bf16, so they differ by at most ~2 bf16 ulps; kernel B is exact
except on pixels whose |izd - 1/c| lies within float rounding of thr;
kernels C, D and E and their plain versions sum float32 products of the
same bf16 values in another order and do not round their float32 output:
1e-4 absolute and relative. Kernel F (the mapper's kNN) is exact against
its plain version: the same distances bit for bit, so the same neighbours
in the same order.
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


def _flow(g, kind, E, h0, w0):
    """Level-0 coords (E, h0*w0, 2) of one of kernel A's test cases:

    smooth: the pixel grid under a small global shift and a gentle
        depth-like warp (neighbouring windows overlap: small boxes);
    incoherent: uniform over the whole plane (each tile's box is the plane,
        and the chunk loop takes many stages);
    outliers: smooth, with NaN centres and centres 45-60 cells off the
        plane inside the first tile and a middle one."""
    yy, xx = torch.meshgrid(torch.arange(h0, dtype=torch.float32),
                            torch.arange(w0, dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([xx, yy], -1).reshape(1, h0 * w0, 2)
    if kind == "incoherent":
        return torch.rand((E, h0 * w0, 2), generator=g) * torch.tensor(
            [float(w0), float(h0)])
    scale = 1.0 + 0.05 * torch.rand((E, 1, 1), generator=g)
    shift = torch.tensor([1.5, -0.7]) + torch.randn((E, 1, 2), generator=g)
    c = (base - torch.tensor([w0 / 2, h0 / 2])) * scale + torch.tensor(
        [w0 / 2, h0 / 2]) + shift
    c = c + 0.3 * torch.sin(base[..., 1:] / 5.0) + 0.1 * torch.randn(
        (E, h0 * w0, 2), generator=g)
    if kind == "outliers":
        mid = (h0 // 2) * w0 + w0 // 2
        for p0 in (0, mid):
            c[:, p0] = float("nan")
            c[:, p0 + 1] += 60.0
            c[:, p0 + w0] -= 45.0
            c[:, p0 + w0 + 1, 0] = float("nan")
    return c


@pytest.mark.parametrize("h0,w0,E,kind", [
    (40, 80, 24, "uniform"), (6, 8, 5, "uniform"), (10, 14, 7, "uniform"),
    (40, 80, 16, "smooth"), (40, 80, 1, "smooth"), (13, 21, 4, "smooth"),
    (40, 80, 8, "incoherent"), (136, 8, 3, "incoherent"),
    (40, 80, 6, "outliers"), (6, 8, 3, "empty level 3")])
def test_lookup_pyramid_matches_plain(dev, h0, w0, E, kind):
    """uniform: centres spread over the plane and 6 cells beyond it, NaN
    in three; 13x21 has npix = 273, no multiple of a 64-pixel tile, and a
    ragged tile edge on both axes; E = 1 is the motion filter's call;
    136 rows take more than one pass of box rows; "empty level 3" gives
    the 6x8 grid's (0, 1) level 3, as the tracker's stores have it."""
    g = torch.Generator().manual_seed(h0 * w0)
    N = 6
    fm = torch.randn((N, h0, w0, 128), generator=g).to(dev, torch.bfloat16)
    pyr = corr.prep_feat_pyramid(fm)
    f2 = (pyr[0].reshape(N, h0, w0, 128),) + tuple(pyr[1:])
    if kind == "empty level 3":
        f2 = f2[:3] + (torch.empty((N, 0, 1, 128), dtype=torch.bfloat16,
                                   device=dev),)
    iis = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    jjs = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    if kind == "uniform":
        coords = torch.rand((E, h0 * w0, 2), generator=g) * torch.tensor(
            [w0 + 12.0, h0 + 12.0]) - 6.0
        coords[0, :3] = float("nan")
    else:
        coords = _flow(g, "smooth" if kind == "empty level 3" else kind, E,
                       h0, w0)
    coords = coords.to(dev)
    before = cuda_corr.LOOKUP_PYRAMID.launches
    out = cuda_corr.lookup_pyramid(pyr[0], f2, iis, jjs, coords)
    assert cuda_corr.LOOKUP_PYRAMID.launches == before + 1
    ref = cuda_corr.lookup_pyramid_plain(pyr[0], f2, iis, jjs, coords)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=8e-3)
    if kind == "empty level 3":
        assert not out[..., 147:].float().any()


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


def _coords(g, E, npix, w, h, dev):
    c = torch.rand((E, npix, 2), generator=g) * torch.tensor(
        [w + 12.0, h + 12.0]) - 6.0
    c[0, :3] = float("nan")
    return c.to(dev)


@pytest.mark.parametrize("h0,w0,lvl,kind", [
    (40, 80, 0, "uniform"), (40, 80, 3, "uniform"), (6, 8, 2, "uniform"),
    (40, 80, 0, "smooth"), (40, 80, 1, "outliers"), (13, 21, 0, "smooth"),
    (40, 80, 0, "incoherent"), (6, 8, 3, "empty")])
def test_lookup_level_matches_plain(dev, h0, w0, lvl, kind):
    """Kernel C on the cases of kernel A's test; 13x21 at level 0 and
    the (0, 1) level 3 of a 6x8 grid ("empty")."""
    g = torch.Generator().manual_seed(h0 + lvl)
    N, E = 6, 9
    fm = torch.randn((N, h0, w0, 128), generator=g).to(dev, torch.bfloat16)
    pyr = corr.prep_feat_pyramid(fm)
    if kind == "empty":
        hl, wl = 0, 1
        f2 = torch.empty((N, 0, 128), dtype=torch.bfloat16, device=dev)
    else:
        hl, wl = (h0, w0) if lvl == 0 else pyr[lvl].shape[1:3]
        f2 = pyr[lvl].reshape(N, hl * wl, 128).contiguous()
    iis = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    jjs = torch.randint(0, N, (E,), generator=g, dtype=torch.int32).to(dev)
    if kind == "uniform":
        coords = _coords(g, E, h0 * w0, wl, hl, dev)
    else:
        coords = (_flow(g, "smooth" if kind == "empty" else kind, E, h0, w0)
                  / 2.0 ** lvl).to(dev)
    before = cuda_corr.LOOKUP_LEVEL.launches
    out = cuda_corr.lookup_level(pyr[0], f2, iis, jjs, coords, hl, wl)
    assert cuda_corr.LOOKUP_LEVEL.launches == before + 1
    ref = cuda_corr.lookup_level_plain(pyr[0], f2, iis, jjs, coords, hl, wl)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    if kind == "empty":
        assert not out.any()


def _plane_coords(g, kind, E, hl, wl, npix, dev):
    """Coords (E, npix, 2) in the level units of (hl, wl) planes: uniform
    as ``_coords``, else ``_flow`` over the pixel grid of a level 0 that
    halves down to hl (13x21 for npix = 273), cut to the first npix
    pixels (npix = 256: an ``alt_corr_chunk`` tile of a 40x80 grid)."""
    if kind in ("uniform", "repeated"):
        return _coords(g, E, npix, wl, hl, dev)
    h0, w0 = (13, 21) if npix == 273 else (40, 80)
    return (_flow(g, kind, E, h0, w0)[:, :npix] * (hl / h0)).contiguous(
        ).to(dev)


@pytest.mark.parametrize("hl,wl,npix,E,kind", [
    (40, 80, 3200, 6, "uniform"), (5, 10, 3200, 6, "uniform"),
    (7, 3, 50, 6, "uniform"), (40, 80, 3200, 8, "smooth"),
    (5, 10, 3200, 8, "smooth"), (40, 80, 3200, 4, "incoherent"),
    (40, 80, 3200, 4, "outliers"), (13, 21, 273, 5, "smooth"),
    (40, 80, 256, 8, "smooth"), (40, 80, 3200, 1, "smooth"),
    (20, 40, 3200, 6, "repeated")])
@pytest.mark.parametrize("slots", [False, True])
def test_lookup_plane_matches_plain(dev, hl, wl, npix, E, kind, slots):
    """Kernels D and E on the cases of kernel A's test: smooth flow at
    levels 0 and 3, incoherent flow over the whole plane (many passes over
    a group's cells), NaN and far off-plane centres inside one 16-pixel
    group ("outliers"), npix = 273 (no multiple of 8: narrower sector
    pieces, a ragged last group), npix = 256 (an ``alt_corr_chunk``
    tile), E = 1, and "repeated": E reads rows of a store of 4E rows with
    repeats (D: the same lookup over E rows). E is also launched with
    ``checked=True`` (no range check on the card) and must give the same
    values."""
    g = torch.Generator().manual_seed(hl * wl + slots)
    S = (10 if kind == "uniform" else 4 * E) if slots else E
    store = torch.randn((S, hl, wl, npix), generator=g).to(
        dev, torch.bfloat16)
    coords = _plane_coords(g, kind, E, hl, wl, npix, dev)
    if slots:
        if kind == "repeated":
            sl = torch.randint(0, S, (E,), generator=g)
            sl[1::2] = sl[0]
        else:
            sl = torch.randperm(S, generator=g)[:E]
        sl = sl.to(dev, torch.int32)
        kernel = cuda_corr.LOOKUP_PLANE_SLOTS
        before = kernel.launches
        out = cuda_corr.lookup_plane_slots(store, sl, coords)
        again = cuda_corr.lookup_plane_slots(store, sl, coords, checked=True)
        assert kernel.launches == before + 2
        assert torch.equal(out, again)
        ref = cuda_corr.lookup_plane_slots_plain(store, sl, coords)
    else:
        kernel = cuda_corr.LOOKUP_PLANE
        before = kernel.launches
        out = cuda_corr.lookup_plane(store, coords)
        assert kernel.launches == before + 1
        ref = cuda_corr.lookup_plane_plain(store, coords)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_corr_block_lookup_makes_no_sync(dev):
    """CorrBlock checks its host slots on the host and copies them without
    blocking: its lookup runs under the sync debug mode "error", and
    gives what the wrapper with its checked device slots gives."""
    g = torch.Generator().manual_seed(7)
    E, h0, w0 = 6, 16, 24
    fmap = torch.randn((E, 128, h0, w0), generator=g).to(dev, torch.bfloat16)
    block = corr.CorrBlock(fmap, fmap.flip(0))[[4, 0, 2, 5]]
    coords = (_flow(g, "smooth", 4, h0, w0)).reshape(4, h0, w0, 2).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = block(coords)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    slots = torch.as_tensor(block.slots, dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        out, corr.lookup_pyramid(block.pyramid, coords, slots), atol=0,
        rtol=0)


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
    planes = torch.zeros((2, 3, 4, 12), device=dev)            # not bf16
    with pytest.raises(TypeError):
        cuda_corr.lookup_plane(planes, torch.zeros((2, 12, 2), device=dev))
    with pytest.raises(ValueError):
        cuda_corr.lookup_plane_slots(planes.to(torch.bfloat16), idx,
                                     torch.zeros((2, 12, 2), device=dev))
    # kernels A and C key cells as y * 65536 + x: planes of 16384 rows or
    # more are refused
    tall = torch.zeros((1, 16384, 128), dtype=torch.bfloat16, device=dev)
    small = torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16, device=dev)
    c_tall = torch.zeros((1, 16384, 2), device=dev)
    with pytest.raises(ValueError):
        cuda_corr.lookup_pyramid(tall, (tall.reshape(1, 16384, 1, 128),)
                                 + (small,) * 3, idx, idx, c_tall)
    with pytest.raises(ValueError):
        cuda_corr.lookup_level(tall, tall, idx, idx, c_tall, 16384, 1)


# ---------------------------------------------------------------------------
# the mapper on the card: kernel F (the kNN) against its plain version, and
# the card against the CPU
# ---------------------------------------------------------------------------

def _cloud(g, cap, count, Q, copies=0):
    """A padded cloud (cap, 3) of ``count`` points in [1, 3)^3, its last
    ``copies`` points exact copies of its first, and Q queries in the same
    box."""
    pts = torch.full((cap, 3), 0.001)
    pts[:count] = 1.0 + 2.0 * torch.rand((count, 3), generator=g)
    if copies:
        pts[count - copies:count] = pts[:copies]
    return pts, 1.0 + 2.0 * torch.rand((Q, 3), generator=g)


def _kernel_and_plain(dev, q, pts, count, k):
    """kernel F through ``knn_search`` and the plain version on the card,
    with the launches and point ranges of the kernel's call."""
    from glorie_slam_tpu_torch.device import resolve_device
    from glorie_slam_tpu_torch.ops import knn

    resolve_device("cuda")
    q, pts = q.to(dev), pts.to(dev)
    n_scan, _ = knn.scan_slots(pts.shape[0], count)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ranges, _ = knn.point_ranges(q.shape[0], min(count, n_scan), sms)
    before = knn.KNN.launches
    D, I = knn.knn_search(q, pts, count, k=k)
    launches = knn.KNN.launches - before
    Dp, Ip = knn.knn_plain(q, pts, count, k, n_scan)
    torch.cuda.synchronize()
    assert D.shape == Dp.shape == (q.shape[0], k) and I.dtype == torch.long
    return D, I, Dp, Ip, launches, ranges


@pytest.mark.parametrize("k", [4, 8, 9])
def test_knn_kernel_matches_plain(dev, k):
    """Enough queries to fill the card in one point range (one launch);
    20,000 points over three 8192-slot tiles, the last 2,000 copies of the
    first: distances bitwise (the kernel's FMA chain is the order cuBLAS
    sums the plain version's product in) and so indices equal everywhere,
    exact ties between copies included."""
    g = torch.Generator().manual_seed(k)
    pts, q = _cloud(g, 3 * 8192, 20000, 150_000, copies=2000)
    q[:5000] = pts[:5000] + 1e-3 * torch.randn((5000, 3), generator=g)
    D, I, Dp, Ip, launches, ranges = _kernel_and_plain(dev, q, pts, 20000, k)
    assert ranges == 1 and launches == 1
    assert torch.equal(D, Dp)
    assert torch.equal(I, Ip)
    tied = (torch.diff(Dp, dim=1) == 0).any(1)
    assert int(tied.sum()) > 100


@pytest.mark.parametrize("Q,count", [(3000, 20000), (257, 40000),
                                     (7000, 2 * 8192 + 5)])
def test_knn_kernel_split_matches_plain(dev, Q, count):
    """Too few queries to fill the card: the points go in ranges and the
    merge pass joins them (two launches); copies of a point fall in
    different ranges, and 2 * 8192 + 5 points end in a nearly empty
    tile."""
    g = torch.Generator().manual_seed(Q)
    cap = -(-count // 8192) * 8192
    pts, q = _cloud(g, cap, count, Q, copies=count // 4)
    q[:Q // 2] = pts[:Q // 2] + 1e-3 * torch.randn((Q // 2, 3), generator=g)
    D, I, Dp, Ip, launches, ranges = _kernel_and_plain(dev, q, pts, count, 8)
    assert ranges > 1 and launches == 2
    assert torch.equal(D, Dp)
    assert torch.equal(I, Ip)


@pytest.mark.parametrize("count,cap,Q", [
    (0, 8192, 500), (3, 8192, 500), (8, 8192, 500), (12, 16, 300),
    (5, 16, 200_000), (0, 16, 200_000)])
def test_knn_kernel_few_valid_points(dev, count, cap, Q):
    """n_valid = 0, below k and equal to k; a 16-slot capacity (one
    16-slot tile); one point range and several: the slots past the valid
    points read BIG at indices n_valid, n_valid + 1, ..., as the plain
    version pads."""
    g = torch.Generator().manual_seed(count + cap)
    pts, q = _cloud(g, cap, count, Q)
    D, I, Dp, Ip, launches, _ = _kernel_and_plain(dev, q, pts, count, 8)
    assert launches >= 1
    assert torch.equal(D, Dp)
    assert torch.equal(I, Ip)
    m = min(count, 8)
    assert bool((D[:, m:] == 1e12).all()) and bool((D[:, :m] < 1e12).all())
    pad = torch.arange(count, count + 8 - m, device=dev)
    assert torch.equal(I[:, m:], pad.expand(Q, -1))


def test_knn_kernel_empty_and_refused(dev):
    """Q = 0 launches nothing; k outside 1..MAX_K, or past the slots
    scanned, raises."""
    from glorie_slam_tpu_torch.device import resolve_device
    from glorie_slam_tpu_torch.ops import knn

    resolve_device("cuda")
    pts = torch.rand((8192, 3), device=dev)
    before = knn.KNN.launches
    D, I = knn.knn_search(torch.empty((0, 3), device=dev), pts, 100)
    assert D.shape == I.shape == (0, knn.NN_NUM) and I.dtype == torch.long
    assert knn.KNN.launches == before
    q = torch.rand((10, 3), device=dev)
    for k in (0, knn.MAX_K + 1):
        with pytest.raises(ValueError):
            knn.knn_search(q, pts, 100, k=k)
    with pytest.raises(ValueError):
        knn.knn_search(q, pts[:4], 4, k=8)


def test_knn_search_on_the_card_matches_cpu(dev):
    """float32 matmuls (TF32 off, as ``device.resolve_device`` sets it);
    distances to 1e-5 relative past 4e-6 absolute (cuBLAS may sum the
    3-term cross product in another order: a few ulps of |q|^2 ~ 10);
    indices exactly where the distances are not within that of a distinct
    neighbour's (the (k+1)-th included), exact ties between copies of a
    point included: both devices list copies lowest index first; and the
    search refuses to run with TF32 on."""
    from glorie_slam_tpu_torch.device import resolve_device
    from glorie_slam_tpu_torch.ops import knn

    resolve_device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = torch.Generator().manual_seed(0)
    cap, count = 3 * knn.TILE, 20000
    pts = torch.full((cap, 3), 0.001)
    pts[:count] = 1.0 + 2.0 * torch.rand((count, 3), generator=g)
    # copies of the first 2000 points, in the last tile that holds points
    pts[count - 2000:count] = pts[:2000]
    q = 1.0 + 2.0 * torch.rand((5000, 3), generator=g)
    # one neighbour more than compared, so that a tie at the k-th place
    # (the first left out) is seen
    D, I = knn.knn_search(q.to(dev), pts.to(dev), count, k=knn.NN_NUM + 1)
    Dc, Ic = knn.knn_search(q, pts, count, k=knn.NN_NUM + 1)
    D, I = D.cpu(), I.cpu()
    tol = 4e-6 + 1e-5 * Dc.abs()
    assert bool(((D - Dc).abs() <= tol).all())
    gap = torch.diff(Dc, dim=1).abs()
    near = (gap <= 2 * tol[:, 1:]) & (gap > 0)
    clear = torch.ones_like(Dc, dtype=torch.bool)
    clear[:, 1:] &= ~near
    clear[:, :-1] &= ~near
    clear = clear[:, :knn.NN_NUM]
    assert clear.float().mean() > 0.9
    tied = torch.zeros_like(clear)
    tied[:, 1:] = gap[:, :knn.NN_NUM - 1] == 0
    assert int((tied & clear).sum()) > 100
    assert bool((I[:, :knn.NN_NUM][clear] == Ic[:, :knn.NN_NUM][clear]).all())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            knn.knn_search(q.to(dev), pts.to(dev), count)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_mapping_step_on_the_card_matches_cpu(dev):
    """One train step (render -> losses -> gradients -> Adam) from one
    state on both devices, in both stages; the tolerances are
    ``chip_smoke.mapping_step_check``'s."""
    import chip_smoke

    res = chip_smoke.mapping_step_check()
    for stage in ("geometry", "color"):
        assert res[stage]["max_loss_rel"] <= 1e-5
        assert res[stage]["entries_off"] == 0
        assert res[stage]["knn_probes"]["neighbour_lists"] == 0
        assert res[stage]["losses_cpu"]["warp_loss"] > 0


def test_async_snapshot_on_the_card(dev):
    """The tracker on the card with the asynchronous mapper: the worker,
    on its own CUDA stream, reads what the tracker's thread read at each
    handshake, though tracking has moved on."""
    import time

    from glorie_slam_tpu_torch.core.depth_video import DepthVideo
    from glorie_slam_tpu_torch.mapping.async_worker import AsyncMapper
    from glorie_slam_tpu_torch.nets.tracker_net import TrackerNet
    from glorie_slam_tpu_torch.tracking.tracker import Tracker
    from glorie_slam_tpu_torch.utils.synthetic import (SyntheticStream,
                                                       base_cfg)

    def capture(view, ix):
        depth, mask, c2w = view.get_depth_and_pose(ix)
        return (view.counter, view.poses[:view.counter].cpu().numpy(),
                depth, mask, c2w)

    class Recorder:
        def __init__(self, video):
            self.live = self.video = video
            self.records, self.streams = [], []

        def on_keyframe(self, info):
            time.sleep(0.05)
            self.streams.append(torch.cuda.current_stream())
            self.records.append(capture(self.video, info["video_idx"])
                                + (self.live.counter,))

    stream = SyntheticStream(n_frames=14, H=64, W=96, seed=3)
    cfg = base_cfg(H=64, W=96, buffer=32)
    cfg["tracking"]["warmup"] = 6
    cfg["mapping"] = {"every_keyframe": 1}
    video = DepthVideo(cfg, device=dev)
    rec = Recorder(video)
    am = AsyncMapper(rec, video)
    expected = []

    def on_kf(info):
        if not info.get("end"):
            expected.append(capture(video, info["video_idx"]))
        am.on_keyframe(info)

    Tracker(TrackerNet(seed=0, device=dev), video, cfg,
            mono_predictor=lambda ts, img: stream.depths[int(ts)],
            on_keyframe=on_kf).run(stream)
    am.join()
    assert len(rec.records) == len(expected) >= 4
    assert all(s == am.stream for s in rec.streams)
    for got, want in zip(rec.records, expected):
        assert got[0] == want[0]
        for a, b in zip(got[1:5], want[1:]):
            assert (a == b).all()
    assert any(r[5] > r[0] for r in rec.records)


def test_dpt_on_the_card_matches_cpu(dev):
    """The DPT at the checkpoint's widths (768 dims, 12 blocks, 12 heads,
    256 features), here at 128x128, and ``MonoDepthEstimator.predict`` of a
    96x160 frame: the card against the CPU, every tap and the prior to
    ``chip_smoke.DPT_TOL`` rel-L2 (float32, TF32 off)."""
    import chip_smoke

    res = chip_smoke.mono_prior_check(size=128, H=96, W=160, iters=2)
    assert max(res["rel_l2_card_vs_cpu"].values()) <= chip_smoke.DPT_TOL
    assert res["predict_rel_l2"] <= chip_smoke.DPT_TOL
    assert res["gflop"] > 0 and res["bound_by"] == "operations"


def test_tsdf_and_lpips_on_the_card_match_cpu(dev):
    """TSDF integration of one synthetic frame and LPIPS, card against CPU
    (``chip_smoke.eval_modules_check``'s tolerances)."""
    import chip_smoke

    res = chip_smoke.eval_modules_check(H=120, W=160)
    assert max(res["voxels_off"].values()) <= 1e-4
    assert res["lpips_rel"] <= 1e-4 and res["observed"] > 0
