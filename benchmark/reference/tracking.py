"""Plain reference of the tracking stages that the benchmark checks.

Each function recomputes one stage from the inputs that the program's call
received (captured during the window) in float32, or in the control's
precision (``precision.Precision``). The nets are the benchmark's frozen
copies (``droid_net.py``, ``dpt.py``) carrying the benchmark's own seeded
weights, the same ones it loaded into the program.
"""

import torch

from . import ba as ba_ref, lie, projective
from .droid_net import DroidNet
from .dpt import DPTDepthModel

RADIUS = 3
NEIGH_OFFSETS = (-1, -2, -3, 3, 4, 5)


def build(cls, weights, device, **kw):
    """A float32 module of ``cls`` holding ``weights`` (built on the meta
    device, so no default initialisation runs)."""
    with torch.device("meta"):
        m = cls(**kw)
    m = m.to_empty(device=device)
    m.load_state_dict({k: v.float() for k, v in weights.items()})
    return m.eval().requires_grad_(False)


def droid_net(weights, device):
    return build(DroidNet, weights, device)


def dpt_model(weights, device, size=512, **kw):
    return build(DPTDepthModel, weights, device, size=size, **kw)


# ---------------------------------------------------------------------------
# the DROID net
# ---------------------------------------------------------------------------

@torch.no_grad()
def encoder(net, which, images, prec):
    """fnet / cnet of ``images`` (B, 3, H, W) -> float32 output."""
    mod = getattr(net, which)
    with prec.low_convs(mod):
        return mod(prec.low(images))


@torch.no_grad()
def update(net, args, kwargs, prec):
    """The update module on a captured call's arguments -> its outputs, each
    float32 (None stays None)."""
    args = [prec.low(a) if torch.is_tensor(a) and a.is_floating_point()
            else a for a in args]
    kwargs = {k: (prec.low(v) if torch.is_tensor(v) and v.is_floating_point()
                  else v) for k, v in kwargs.items()}
    with prec.low_convs(net.update):
        out = net.update(*args, **kwargs)
    return [None if o is None else o.float() for o in out]


# ---------------------------------------------------------------------------
# kernel A's function: the 4-level 7x7 correlation lookup
# ---------------------------------------------------------------------------

def _hat_weights(pos, size):
    c = torch.arange(size, dtype=pos.dtype, device=pos.device)
    a = torch.arange(2 * RADIUS + 1, dtype=pos.dtype, device=pos.device)
    sample = pos[..., None] - RADIUS + a
    return torch.clamp(1.0 - (c[:, None] - sample[..., None, :]).abs(),
                       min=0.0)


def _level(f1, f2, iis, jjs, coords, hl, wl):
    E, npix, _ = coords.shape
    rd = 2 * RADIUS + 1
    outs = []
    for s in range(0, E, 8):
        a = f1[iis[s:s + 8].long()]
        b = f2[jjs[s:s + 8].long(), :hl * wl]
        vol = torch.bmm(a, b.transpose(1, 2)).reshape(len(a), npix, hl,
                                                       wl) / 16.0
        c = coords[s:s + 8]
        wx = _hat_weights(c[..., 0], wl)
        wy = _hat_weights(c[..., 1], hl)
        tmp = torch.einsum("ephw,ephb->epbw", vol, wy)
        outs.append(torch.einsum("epbw,epwa->epab", tmp, wx).reshape(
            len(a), npix, rd * rd))
    return torch.cat(outs) if outs else coords.new_zeros((0, npix, rd * rd))


@torch.no_grad()
def lookup_pyramid(f1, f2_levels, iis, jjs, coords, prec):
    """f1 (N, npix, 128) level-0 store, f2_levels 4 stores (N, h, w, 128),
    iis/jjs (E,), coords (E, npix, 2) level-0 [x, y] -> (E, npix, 196)."""
    c = torch.nan_to_num(coords.float())
    a = prec.low(f1)
    outs = []
    with prec.products():
        for lvl, f2 in enumerate(f2_levels):
            N, hl, wl, C = f2.shape
            b = a if lvl == 0 else prec.low(f2).reshape(N, hl * wl, C)
            outs.append(_level(a, b, iis, jjs, c / 2.0 ** lvl, hl, wl))
    return torch.cat(outs, -1)


# ---------------------------------------------------------------------------
# the BA solves
# ---------------------------------------------------------------------------

@torch.no_grad()
def dba(args, kwargs, prec):
    """``geom/ba.ba`` on a captured call -> (poses, disps). The control
    rounds the floating inputs to bf16 besides taking TF32 products: TF32
    alone moves these long pixel sums no more than float32's own summation
    order does."""
    args = [prec.plain(a) for a in args]
    with prec.products():
        return ba_ref.ba(*args, **kwargs)


@torch.no_grad()
def dspo(args, kwargs, prec):
    """``geom/ba.ba_scale_shift`` on a captured call -> (disps, scales,
    shifts)."""
    args = [prec.plain(a) for a in args]
    return ba_ref.ba_scale_shift(*args, **kwargs)


# ---------------------------------------------------------------------------
# the multiview depth filter with kernel B's 4-corner agreement
# ---------------------------------------------------------------------------

def _agree(dmaps, jxs, cu):
    N, ht, wd = dmaps.shape
    M, _, npix = cu.shape
    u, v, izd, thr = cu.reshape(M, 6, 4, npix).unbind(2)
    fu, fv = torch.floor(u), torch.floor(v)
    inb = (fu >= 0) & (fv >= 0) & (fu < wd - 1) & (fv < ht - 1)
    u0 = torch.where(inb, fu, torch.zeros_like(fu)).long()
    v0 = torch.where(inb, fv, torch.zeros_like(fv)).long()
    base = jxs.long()[:, :, None] * (ht * wd) + v0 * wd + u0
    flat = dmaps.reshape(-1)
    agree = torch.zeros_like(inb)
    for off in (0, 1, wd, wd + 1):
        agree = agree | ((izd - 1.0 / flat[base + off]).abs() < thr)
    return (inb & agree).float()


@torch.no_grad()
def depth_filter(poses, disps, intrinsics, inds, thresh, prec, chunk=None):
    """Agreement counts (M, ht, wd) of frames ``inds``."""
    poses, disps, intrinsics, thresh = (prec.plain(x) for x in
                                        (poses, disps, intrinsics, thresh))
    N, ht, wd = disps.shape
    if chunk is None:
        chunk = max(1, (1 << 22) // (ht * wd))
    offs = torch.tensor(NEIGH_OFFSETS, dtype=torch.long, device=disps.device)
    fx, fy, cx, cy = intrinsics.unbind(-1)
    counts = []
    for s in range(0, inds.shape[0], chunk):
        ix = inds[s:s + chunk].long()
        M = ix.shape[0]
        jx = ix[:, None] + offs[None, :]
        in_range = (jx >= 0) & (jx < N)
        jx = jx.clamp(0, N - 1)
        X0 = projective.iproj(disps[ix], intrinsics)
        Gij = lie.rel(poses[ix][:, None], poses[jx])
        Xj = lie.act(Gij[:, :, None, None], X0[:, None])
        z = Xj[..., 2]
        u = fx * Xj[..., 0] / z + cx
        v = fy * Xj[..., 1] / z + cy
        izd = 1.0 / (Xj[..., 3] / z)
        thr = thresh[s:s + chunk][:, None, None, None].expand(M, 6, ht, wd)
        cu = torch.stack([u, v, izd, thr], dim=2).reshape(M, 24, ht * wd)
        agree = _agree(disps, jx, cu) * in_range[:, :, None].float()
        counts.append(agree.sum(dim=1).reshape(-1, ht, wd))
    return torch.cat(counts)


# ---------------------------------------------------------------------------
# the mono prior: the omnidata DPT
# ---------------------------------------------------------------------------

@torch.no_grad()
def dpt_head(model, x, prec):
    """The DPT's head output before its last ReLU, (B, H, W), for the
    normalized input ``x`` (B, 3, S, S)."""
    with prec.products():
        return model.taps(x.float())["pre_relu"]
