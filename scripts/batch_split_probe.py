#!/usr/bin/env python3
"""Which of the sharded tracker's per-edge and per-frame products round an
item's result differently with the size of its batch, on one card.

Edge-sharded ranks (``glorie_slam_tpu_torch/parallel/``) run the same
per-edge work on a part of the edges each, so a product whose rounding
depends on the batch size makes n ranks differ from one. On the frontend's
state at 320x640 (``tests/torch_drills.rounds_state``: 96 active edges, the
random-weight bf16 net) this runs each product on the whole batch and on
its rank parts (``mesh.frame_bounds`` at 2 and 4 ranks), and prints per
product whether the parts equal the whole bitwise and the largest
difference:

* ``ba._edge_blocks`` (the BA linearization: [Hii | Hij | vi] and
  [Hjj | vj] products, ``Ei``, ``C``), and the one-column gradient product
  that it replaced (``einsum("npki,npk->ni")``);
* the net's update (``TrackerNet.update`` with GraphAgg) on the
  channels-last views the tracker hands it and on contiguous NCHW inputs,
  with each layout's milliseconds for the whole batch (CUDA events);
* ``upsample.upsample_disp`` over 19 frames, and the batched einsum it
  replaced.

It also times (CUDA events, the whole batch) ``_edge_blocks`` against the
five einsums it replaced and ``upsample_disp`` against the einsum, so that
their cost on the one-rank path shows.

    python3 scripts/batch_split_probe.py [--device cpu --H 64 --W 96]

Prints one JSON line, then the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from glorie_slam_tpu_torch.geom import ba as ba_mod, projective  # noqa: E402
from glorie_slam_tpu_torch.ops import upsample  # noqa: E402
from glorie_slam_tpu_torch.parallel import mesh  # noqa: E402
import torch_drills as drills  # noqa: E402


def _parts(ii, world, buffer):
    return mesh.rank_edges(ii, mesh.frame_bounds(ii, world, buffer))


def _split(fn, full_args, parts, index):
    """(bitwise, largest difference) of fn over the parts against fn over
    the whole; ``index`` picks an item's rows of each argument."""
    whole = fn(*full_args)
    pieces = [fn(*index(p)) for p in parts if len(p)]
    order = np.concatenate([p for p in parts if len(p)])
    out = {}
    for k, w in whole.items():
        cat = torch.cat([q[k] for q in pieces])
        ref = w[torch.as_tensor(order, device=w.device)]
        out[k] = [bool(torch.equal(cat, ref)),
                  float((cat.float() - ref.float()).abs().max())]
    return out


def _ms(fn, device, iters=20):
    if device.type != "cuda":
        return None
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _old_upsample(disp, mask):
    B, ht, wd = disp.shape
    mask = torch.softmax(mask.reshape(B, 9, 8, 8, ht, wd), dim=1)
    patches = F.unfold(disp[:, None], 3, padding=1).reshape(B, 1, 9, ht, wd)
    up = torch.einsum("bnyxhw,bdnhw->bhywxd", mask, patches)
    return up.reshape(B, 8 * ht, 8 * wd)


def _old_edge_blocks(poses, disps, intrinsics, target, weight, ii, jj):
    """``ba._edge_blocks``' products as five einsums (its earlier form)."""
    E = target.shape[0]
    npix = disps.shape[-2] * disps.shape[-1]
    coords, valid, (Ji, Jj, Jz) = projective.projective_transform(
        poses, disps, intrinsics, ii.clamp(min=0), jj.clamp(min=0),
        jacobian=True)
    Ji = Ji.reshape(E, npix, 2, 6)
    Jj = Jj.reshape(E, npix, 2, 6)
    Jz = Jz.reshape(E, npix, 2)
    r = target.reshape(E, npix, 2) - coords.reshape(E, npix, 2)
    w = 0.001 * valid.reshape(E, npix, 1) * weight.reshape(E, npix, 2)
    w = w * (ii >= 0)[:, None, None].to(w.dtype)
    C = torch.sum(w * Jz * Jz, dim=-1)
    wz = torch.sum(w * r * Jz, dim=-1)
    wp = w * (ii != jj)[:, None, None].to(w.dtype)
    wJi = wp[..., None] * Ji
    wJj = wp[..., None] * Jj
    return (torch.einsum("npki,npkj->nij", wJi, Ji),
            torch.einsum("npki,npkj->nij", wJi, Jj),
            torch.einsum("npki,npkj->nij", wJj, Jj),
            torch.einsum("npki,npk->ni", wJi, r),
            torch.einsum("npki,npk->ni", wJj, r),
            torch.einsum("npki,npk->nip", wJi, Jz),
            torch.einsum("npki,npk->nip", wJj, Jz), C, wz)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--H", type=int, default=320)
    ap.add_argument("--W", type=int, default=640)
    args = ap.parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h8, w8 = args.H // 8, args.W // 8
    video, graph = drills.rounds_state(H=args.H, W=args.W, n=19, r=3,
                                       n_inactive=6, buffer=32, device=dev)
    E, buf = len(graph.ii), video.buffer
    ii = torch.as_tensor(graph.ii, device=dev)
    jj = torch.as_tensor(graph.jj, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    target = graph.target + torch.randn(graph.target.shape, device=dev,
                                        generator=g)
    weight = torch.rand(graph.target.shape, device=dev, generator=g)
    report = {"edges": E, "frames": int(video.counter)}

    def blocks(t, w, i, j):
        Hii, Hij, Hjj, vi, vj, Ei, Ej, C, wz = ba_mod._edge_blocks(
            video.poses, video.disps, video.intrinsics, t, w, i, j)
        # the one-column product _edge_blocks took the gradients with before
        n, npix = len(i), h8 * w8
        coords, valid, (Ji, _, _) = projective.projective_transform(
            video.poses, video.disps, video.intrinsics, i, j, jacobian=True)
        r = t.reshape(n, npix, 2) - coords.reshape(n, npix, 2)
        wv = 0.001 * valid.reshape(n, npix, 1) * w.reshape(n, npix, 2)
        wv = wv * (i != j)[:, None, None].to(wv.dtype)
        wJi = wv[..., None] * Ji.reshape(n, npix, 2, 6)
        return {"Hii": Hii, "Hij": Hij, "vi": vi, "Ei": Ei, "C": C,
                "one_column_einsum": torch.einsum("npki,npk->ni", wJi, r)}

    tn = graph.tn
    kx, kk = np.unique(graph.ii, return_inverse=True)

    def nhwc(c, scale):
        x = torch.randn(E, h8, w8, c, device=dev, generator=g) * scale
        return x.to(tn.dtype)

    feats = [nhwc(128, 0.5), nhwc(128, 0.5), nhwc(196, 1.0), nhwc(4, 3.0)]

    def update(layout):
        def run(*xs_kk):
            *xs, kk_t, m = xs_kk
            xs = [x.permute(0, 3, 1, 2) for x in xs]
            if layout == "contiguous":
                xs = [x.contiguous() for x in xs]
            with torch.no_grad():
                net, delta, w, eta, up = tn.update(*xs, kk_t, m)
            return {"net": net, "delta": delta, "weight": w}
        return run

    disp = torch.rand(19, h8, w8, device=dev, generator=g)
    umask = torch.randn(19, 576, h8, w8, device=dev, generator=g)
    report["upsample_new_vs_einsum"] = float(
        (upsample.upsample_disp(disp, umask)
         - _old_upsample(disp, umask)).abs().max())
    for world in (2, 4):
        parts = _parts(graph.ii, world, buf)
        r = {"edge_split": [len(p) for p in parts]}
        r["edge_blocks"] = _split(
            blocks, (target, weight, ii, jj), parts,
            lambda p: (target[p], weight[p], ii[p], jj[p]))
        kk_t = torch.as_tensor(kk, device=dev)

        def index(p):
            kx_l, kk_l = np.unique(graph.ii[p], return_inverse=True)
            return [x[p] for x in feats] + [
                torch.as_tensor(kk_l, device=dev), len(kx_l)]

        for layout in ("channels_last", "contiguous"):
            r["update_" + layout] = _split(
                update(layout), feats + [kk_t, len(kx)], parts, index)
        fparts = [np.arange(19)[s] for s in np.array_split(
            np.arange(19), world)]
        r["upsample"] = _split(
            lambda d, m: {"up": upsample.upsample_disp(d, m)},
            (disp, umask), fparts, lambda p: (disp[p], umask[p]))
        r["upsample_einsum"] = _split(
            lambda d, m: {"up": _old_upsample(d, m)},
            (disp, umask), fparts, lambda p: (disp[p], umask[p]))
        report[f"ranks_{world}"] = r
    kk_t = torch.as_tensor(kk, device=dev)
    for layout in ("channels_last", "contiguous"):
        fn = update(layout)
        report[f"update_ms_{layout}"] = _ms(
            lambda: fn(*feats, kk_t, len(kx)), dev)
    state = (video.poses, video.disps, video.intrinsics, target, weight, ii,
             jj)
    report["edge_blocks_ms"] = _ms(lambda: ba_mod._edge_blocks(*state), dev)
    report["edge_blocks_five_einsums_ms"] = _ms(
        lambda: _old_edge_blocks(*state), dev)
    report["upsample_ms"] = _ms(lambda: upsample.upsample_disp(disp, umask),
                                dev)
    report["upsample_einsum_ms"] = _ms(lambda: _old_upsample(disp, umask),
                                       dev)
    print(json.dumps(report), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
