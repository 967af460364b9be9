"""The yardstick's arithmetic: trace reduction, statistics, the kernels'
byte and operation counts, and the models' operation counts."""

import math

import torch

from benchmark.yardstick import flops, peaks, roofline, stats, trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_busy_is_a_union_over_streams():
    ev = [_x("user_annotation", trace.STRETCH, 0, 100),
          # stream 7: [10, 40); stream 8: [30, 60) overlaps it -> [10, 60)
          _x("kernel", "a", 10, 30, tid=7, corr=1),
          _x("kernel", "b", 30, 30, tid=8, corr=2),
          _x("gpu_memcpy", "c", 80, 10, tid=7, corr=3),
          # a device-side mirror of an annotation is not activity
          _x("gpu_user_annotation", "x", 0, 100, tid=7),
          # device work outside the stretch is clipped away
          _x("kernel", "d", 95, 20, tid=7, corr=4)]
    r = trace.reduce(ev)
    assert math.isclose(r.window_s, 100e-6)
    assert math.isclose(r.busy_s, (50 + 10 + 5) * 1e-6)
    assert r.kernels == 3
    # longest first
    for (_, got), want in zip(r.idle_gaps, (20e-6, 10e-6, 5e-6)):
        assert math.isclose(got, want)
    assert len(r.idle_gaps) == 3


def test_span_device_time_follows_correlation():
    ev = [_x("user_annotation", trace.STRETCH, 0, 1000),
          _x("user_annotation", "net", 100, 100, tid=1),
          _x("user_annotation", "net", 300, 100, tid=1),
          _x("cuda_runtime", "cudaLaunchKernel", 110, 5, tid=1, corr=1),
          _x("cuda_runtime", "cudaLaunchKernel", 250, 5, tid=1, corr=2),
          _x("cuda_runtime", "cudaLaunchKernel", 350, 5, tid=1, corr=3),
          # launched on another thread inside the range's time: not its
          _x("cuda_runtime", "cudaLaunchKernel", 120, 5, tid=2, corr=4),
          _x("kernel", "k1", 400, 40, tid=7, corr=1),
          _x("kernel", "k2", 450, 7, tid=7, corr=2),
          _x("kernel", "k3", 460, 11, tid=8, corr=3),
          _x("kernel", "k4", 480, 13, tid=7, corr=4)]
    r = trace.reduce(ev)
    assert math.isclose(r.span_device_s["net"], 51e-6)
    assert r.device_ops[0][0] == "k1"
    assert math.isclose(r.device_ops[0][1], 40e-6)


def test_idle_gap_named_by_host_ranges():
    ev = [_x("user_annotation", trace.STRETCH, 0, 100),
          _x("user_annotation", "layer.frontend", 0, 100),
          _x("cpu_op", "aten::item", 50, 40),
          _x("kernel", "k", 0, 30, tid=7, corr=1)]
    r = trace.reduce(ev)
    assert r.idle_gaps[0][0] == "layer.frontend > aten::item"
    assert math.isclose(r.idle_gaps[0][1], 70e-6)


def test_p90_over_every_keyframe_and_rate_over_the_window():
    samples = [0.1] * 89 + [1.0] * 11
    # 11 slow keyframes in 100: the 90th percentile is in the slow tail,
    # where a median of chunk medians would never look
    assert stats.percentile(samples, 90) > 0.9
    chunks = [samples[i:i + 10] for i in range(0, 100, 10)]
    assert sorted(sorted(c)[5] for c in chunks)[5] == 0.1
    # the rate counts all keyframes over all of the window's seconds
    window = sum(samples) + 0.5          # host gaps between steps count
    assert math.isclose(stats.rate(len(samples), window), 100 / 20.4)
    assert stats.percentile([2.0], 90) == 2.0


def _edge_inputs(N=16, E=96, h0=40, w0=80, seed=0):
    """chip_smoke's kernel-phase inputs (its ``edge_inputs``)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    npix = h0 * w0
    torch.randn((N, h0, w0, 128), generator=g)
    iis = torch.randint(0, N, (E,), generator=g, dtype=torch.int32)
    jjs = torch.randint(0, N, (E,), generator=g, dtype=torch.int32)
    yy, xx = torch.meshgrid(torch.arange(h0), torch.arange(w0),
                            indexing="ij")
    base = torch.stack([xx, yy], -1).reshape(1, npix, 2).float()
    coords = base + 3.0 * torch.randn((E, npix, 2), generator=g)
    coords[:, ::97] = float("nan")
    coords[:, 5::53] += 60.0
    coords[:, 7::61] -= 45.0
    return iis, jjs, coords


def test_lookup_counts_at_kernel_phase_shapes():
    iis, jjs, coords = _edge_inputs()
    dims = [(40, 80), (20, 40), (10, 20), (5, 10)]
    nbytes, ops = roofline.lookup_pyramid(iis, jjs, coords, dims)
    # at most every row of every frame used, as chip_smoke counted them
    used = torch.unique(torch.cat([iis, jjs]).long()).numel()
    dst = torch.unique(jjs.long()).numel()
    rest = coords.numel() * 4 + 96 * 8 + 96 * 3200 * 196 * 2
    full = used * 3200 * 256 + dst * 256 * (800 + 200 + 50) + rest
    assert 0.95 * full <= nbytes <= full
    # rows and operations by brute force over a few edges
    c = torch.nan_to_num(coords[:3])
    src = set(iis[:3].tolist())
    rows = {(0, int(i), p) for i in src for p in range(3200)}
    cells = 0
    for lvl, (h, w) in enumerate(dims):
        x = torch.floor(c[..., 0] / 2 ** lvl).long()
        y = torch.floor(c[..., 1] / 2 ** lvl).long()
        for e in range(3):
            j = int(jjs[e])
            for dy in range(8):
                for dx in range(8):
                    gx, gy = x[e] - 3 + dx, y[e] - 3 + dy
                    ok = (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
                    cells += int(ok.sum())
                    for cell in (gy * w + gx)[ok].tolist():
                        rows.add((lvl, j, cell))
    b3, ops3 = roofline.lookup_pyramid(iis[:3], jjs[:3], coords[:3], dims)
    assert ops3 == 2 * 128 * cells
    assert b3 == (len(rows) * 256 + coords[:3].numel() * 4 + 3 * 8
                  + 3 * 3200 * 196 * 2)
    # the kernel phase's bound (PERF.md's table) was 0.0419 ms, set by bytes
    least = roofline.least_s(nbytes, ops, peaks.BF16_FLOPS)
    assert 0.95 * 0.0419e-3 <= least <= 0.04195e-3
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / peaks.BF16_FLOPS


def test_depth_agree_counts_at_kernel_phase_shapes():
    """chip_smoke's kernel-B inputs (its ``check_kernel_b``): 8 frames
    against 6 neighbours each at 320x640 on a smooth surface."""
    from glorie_slam_tpu_torch.geom import lie
    from glorie_slam_tpu_torch.ops import depth_filter

    N, M, ht, wd = 16, 8, 320, 640
    g = torch.Generator(device="cpu").manual_seed(1)
    poses = lie.exp(torch.cumsum(0.02 * torch.randn((N, 6), generator=g),
                                 0))
    yy, xx = torch.meshgrid(torch.arange(ht), torch.arange(wd),
                            indexing="ij")
    surf = 0.4 + 0.1 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0)
    disps = surf[None] * (1 + 0.02 * torch.randn((N, ht, wd), generator=g))
    intr = torch.tensor([0.8 * wd, 0.8 * wd, wd / 2 - 0.5, ht / 2 - 0.5])
    inds = torch.arange(3, 3 + M)
    thr = 0.01 / disps[inds].mean(dim=(1, 2))
    jx, _, cu = depth_filter.pack_agreement_inputs(poses, disps, intr, inds,
                                                   thr)
    nbytes, ops = roofline.depth_agree(jx, cu, ht, wd)
    npix = ht * wd
    u, v = cu.reshape(M, 6, 4, npix)[:, :, 0], cu.reshape(M, 6, 4,
                                                          npix)[:, :, 1]
    inb = ((u >= 0) & (v >= 0) & (torch.floor(u) < wd - 1)
           & (torch.floor(v) < ht - 1))
    assert ops == 8 * int(inb.sum())
    # nearly every projection lands inside: the count is close to reading
    # all of the packed inputs and every neighbour frame (PERF.md's table
    # gives kernel B's bound there as 0.0626 ms)
    full = 16 * npix * 4 + M * 24 * npix * 4 + M * 6 * 4 + M * 6 * npix * 4
    assert 0.9 * full <= nbytes <= full
    least = roofline.depth_agree_least_s(jx, cu, ht, wd)
    assert 0.9 * 0.0626e-3 <= least <= 0.0627e-3


def _hand_count(module, *inputs):
    """2 x multiply-adds of every Conv2d and Linear, from forward hooks on a
    real (CPU) forward."""
    total = [0]

    def conv(m, a, out):
        k = m.weight[0].numel()
        total[0] += 2 * k * out.numel()

    def lin(m, a, out):
        total[0] += 2 * m.in_features * out.numel()

    hooks = []
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(lin))
    with torch.no_grad():
        module(*inputs)
    for h in hooks:
        h.remove()
    return total[0]


def test_droid_flops_match_a_hand_count():
    from benchmark.reference.droid_net import DroidNet

    net = DroidNet()
    x = torch.randn(1, 3, 32, 48)
    assert flops.encoder("fnet", 1, 32, 48) == _hand_count(net.fnet, x)
    E, h, w = 3, 4, 6
    args = (torch.randn(E, 128, h, w), torch.randn(E, 128, h, w),
            torch.randn(E, 196, h, w), torch.randn(E, 4, h, w),
            torch.tensor([0, 1, 1]), 2)
    assert flops.update(E, h, w, 2, True, True) == _hand_count(
        net.update, *args)
    # per edge the update is linear in the edge count, GraphAgg's
    # per-frame part is not
    assert flops.update(6, h, w, 2, False, False) == \
        2 * flops.update(3, h, w, 2, False, False)


def test_decoder_flops_match_a_hand_count():
    from benchmark.reference.mapping import decoders_module
    from glorie_slam_tpu_torch.utils.synthetic import mapping_cfg

    cfg = mapping_cfg()
    dec = decoders_module(cfg, "cpu")
    for p in dec.parameters():
        torch.nn.init.normal_(p)
    n, k, cap = 40, 8, 64
    rays, samples = 4, 10
    args = (torch.randn(n, 3), torch.rand(n, k), torch.randint(0, cap,
                                                              (n, k)),
            torch.full((n,), k, dtype=torch.int32), torch.randn(cap, 32),
            torch.randn(cap, 32), torch.randn(cap, 3), torch.tensor(1.0),
            torch.randn(n, 3))
    hooks_total = []
    for stage in ("geometry", "color"):
        tot = [0]

        def lin(m, a, out):
            tot[0] += 2 * m.in_features * out.numel()
        hs = [m.register_forward_hook(lin) for m in dec.modules()
              if isinstance(m, torch.nn.Linear)]
        with torch.no_grad():
            dec(*args, stage=stage)
        for h in hs:
            h.remove()
        hooks_total.append(tot[0])
    # forward + backward: each product counted three times (forward, the
    # input's gradient, the weight's gradient), Fourier embeddings aside
    for stage, fwd in zip(("geometry", "color"), hooks_total):
        got = flops.decoder_step(cfg, rays, samples, cap, stage)
        assert 2.5 * fwd <= got <= 3.5 * fwd
