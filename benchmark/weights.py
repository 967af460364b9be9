"""Seeded random weights, made on the device in one draw per model.

The benchmark makes the weights and hands the same tensors to the program
(``load_state_dict`` into its modules, which cast them to the type they
serve in) and to the plain reference. Shapes and names come from the
reference's frozen copies of the modules, built on the meta device; the
scales follow the port's own random initialisers:

* DROID net: every conv weight and bias uniform in +-1/sqrt(fan_in), the
  flow-revision head's last conv (``update.delta.2``) then scaled by
  ``DELTA_SCALE``. At full scale a random net's flow revisions throw the
  poses around, the graph's edge count wanders from run to run (a median
  of 42 of the 100 allowed in one run, the cap in the next) and with it
  the work; at 0.1 the frontend's graph fills to ``max_factors`` in every
  run and each solve still takes steps well above float32 rounding;
* omnidata DPT: ``pos_embed`` N(0, 0.02), biases and the class token zero,
  norm scales one, the rest lecun-normal truncated at two deviations;
* mapper decoders: Linear weights N(0, 1/fan_in), biases zero, each
  Fourier ``B`` scale * N(0, 1).
"""

import math

import torch

from .reference.decoders import GaussianFourier
from .reference.mapping import decoders_module
from .reference.droid_net import DroidNet
from .reference.dpt import DPTDepthModel

DROID, DPT, DECODERS = 1, 2, 3     # stream offsets mixed into the seed
DELTA_SCALE = 0.1


def _generator(seed, salt, device):
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + salt) % (1 << 63))


def _draw(shapes, gen, device, kind):
    """One draw for all ``shapes`` -> a list of views, uniform [-1, 1) or
    standard normal."""
    n = sum(math.prod(s) for s in shapes)
    if kind == "uniform":
        flat = torch.rand(n, generator=gen, device=device) * 2 - 1
    else:
        flat = torch.randn(n, generator=gen, device=device)
    out, at = [], 0
    for s in shapes:
        k = math.prod(s)
        out.append(flat[at:at + k].view(s))
        at += k
    return out


def droid(seed, device):
    with torch.device("meta"):
        net = DroidNet()
    names, shapes, bounds = [], [], []
    for mname, mod in net.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            b = 1.0 / math.sqrt(mod.weight[0].numel())
            for p in ("weight", "bias"):
                names.append(f"{mname}.{p}")
                shapes.append(tuple(getattr(mod, p).shape))
                bounds.append(b)
    draws = _draw(shapes, _generator(seed, DROID, device), device, "uniform")
    out = {n: d * b for n, d, b in zip(names, draws, bounds)}
    for n in ("update.delta.2.weight", "update.delta.2.bias"):
        out[n] = out[n] * DELTA_SCALE
    return out


def dpt(seed, device, size=512, **kw):
    """``kw``: other ``DPTDepthModel`` arguments (the CPU tests' small
    DPT)."""
    with torch.device("meta"):
        model = DPTDepthModel(size=size, **kw)
    params = dict(model.named_parameters())
    drawn = [n for n, p in params.items()
             if n.endswith("pos_embed")
             or not (n.endswith("cls_token") or n.endswith("bias")
                     or p.dim() == 1)]
    draws = dict(zip(drawn, _draw([tuple(params[n].shape) for n in drawn],
                                  _generator(seed, DPT, device), device,
                                  "normal")))
    out = {}
    for n, p in params.items():
        if n in draws and n.endswith("pos_embed"):
            out[n] = 0.02 * draws[n]
        elif n in draws:
            std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
            out[n] = std * draws[n].clamp(-2.0, 2.0)
        elif p.dim() == 1 and not n.endswith("bias"):
            out[n] = torch.ones(p.shape, device=device)
        else:
            out[n] = torch.zeros(p.shape, device=device)
    return out


def decoders(seed, cfg, device):
    """Parameters and buffers of the mapper's ``PointDecoders``."""
    dec = decoders_module(cfg, "meta")
    names, shapes, scales, zeros = [], [], [], {}
    for mname, mod in dec.named_modules():
        if isinstance(mod, torch.nn.Linear):
            names.append(f"{mname}.weight")
            shapes.append(tuple(mod.weight.shape))
            scales.append(1.0 / math.sqrt(mod.weight.shape[1]))
            zeros[f"{mname}.bias"] = tuple(mod.bias.shape)
        elif isinstance(mod, GaussianFourier):
            names.append(f"{mname}.B")
            shapes.append(tuple(mod.B.shape))
            scales.append(mod.scale)
    draws = _draw(shapes, _generator(seed, DECODERS, device), device,
                  "normal")
    out = {n: d * s for n, d, s in zip(names, draws, scales)}
    out.update({n: torch.zeros(s, device=device) for n, s in zeros.items()})
    return out
