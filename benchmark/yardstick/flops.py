"""Model operations counted from shapes, for the MFU metrics.

Each count runs the reference's frozen copy of a module on the meta device
under ``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products and convolutions (2 per multiply-add) from their shapes alone, so
the count is the same whatever kernels the program runs. Counts are cached
by shape.
"""

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.droid_net import DroidNet
from ..reference.dpt import DPTDepthModel
from ..reference.mapping import decoders_module


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@functools.lru_cache(maxsize=None)
def _droid():
    with torch.device("meta"):
        return DroidNet()


@functools.lru_cache(maxsize=None)
def encoder(which, B, H, W):
    """fnet / cnet over B images of H x W."""
    net = getattr(_droid(), which)
    x = torch.empty((B, 3, H, W), device="meta")
    return _count(lambda: net(x))


@functools.lru_cache(maxsize=None)
def update(E, h, w, num_frames, with_agg, with_upmask):
    """The update module over E edges of an h x w grid; with ``with_agg``
    GraphAgg over ``num_frames`` frames too."""
    mod = _droid().update

    def run():
        z = torch.empty((E, 128, h, w), device="meta")
        corr = torch.empty((E, 196, h, w), device="meta")
        flow = torch.empty((E, 4, h, w), device="meta")
        kk = torch.zeros(E, dtype=torch.long, device="meta")
        mod(z, z, corr, flow, kk if with_agg else None, num_frames,
            with_upmask=with_upmask)
    return _count(run)


@functools.lru_cache(maxsize=None)
def agg(E, h, w, num_frames):
    """GraphAgg alone (the upsample mask after the last round)."""
    mod = _droid().update.agg
    z = torch.empty((E, 128, h, w), device="meta")
    kk = torch.zeros(E, dtype=torch.long, device="meta")
    return _count(lambda: mod(z, kk, num_frames, with_upmask=True))


@functools.lru_cache(maxsize=None)
def dpt(size=512):
    """The DPT forward over one size x size image."""
    with torch.device("meta"):
        model = DPTDepthModel(size=size)
    x = torch.empty((1, 3, size, size), device="meta")
    return _count(lambda: model(x))


@functools.lru_cache(maxsize=None)
def _decoders(model_key):
    cfg = {"model": dict(model_key[0]), "pointcloud": dict(model_key[1])}
    return decoders_module(cfg, "meta")


def decoder_step(cfg, rays, samples, cap, stage):
    """The decoders' forward and backward in one train step: ``rays`` x
    ``samples`` points, ``nn_num`` neighbours each, over a cloud of
    ``cap`` points; the colour decoder runs in the colour stage only."""
    key = (tuple(sorted(cfg["model"].items())),
           tuple(sorted(cfg["pointcloud"].items())))
    return _decoder_step(key, rays, samples, cap, stage,
                         cfg["pointcloud"]["nn_num"], cfg["model"]["c_dim"])


@functools.lru_cache(maxsize=None)
def _decoder_step(key, rays, samples, cap, stage, k, c_dim):
    dec = _decoders(key)
    n = rays * samples

    def run():
        p = torch.empty((n, 3), device="meta")
        D = torch.empty((n, k), device="meta")
        I = torch.zeros((n, k), dtype=torch.long, device="meta")
        nn = torch.zeros(n, dtype=torch.int32, device="meta")
        geo = torch.empty((cap, c_dim), device="meta", requires_grad=True)
        col = torch.empty((cap, c_dim), device="meta", requires_grad=True)
        pos = torch.empty((cap, 3), device="meta")
        r2 = torch.empty((), device="meta")
        views = torch.empty((n, 3), device="meta")
        raw, _ = dec(p, D, I, nn, geo, col, pos, r2, views, stage)
        raw.sum().backward()
    return _count(run)
