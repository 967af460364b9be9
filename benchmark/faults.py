"""Faults planted in the program's timed path, to show that a run with
them comes out not correct (``tests/test_bench_faults.py``) and to read
them on the card at a cell's size (``calibrate.py --fault``).

One per kind of fault a cell can have: a step that returns its state
unchanged, half of the batch left out with the mean taken over the rest,
and an answer altered where it is produced; for the mapper also a colour
stage that trains without its colour loss. No cell spans chips, so no
exchange between chips can be left out.
"""

import torch


def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def ba_unchanged():
    """The DBA solve returns the poses and disparities it was given."""
    from glorie_slam_tpu_torch.geom import ba as ba_mod
    return _patch(ba_mod, "ba", lambda poses, disps, *a, **k: (poses, disps))


def lookup_half():
    """The correlation lookup computes half of the edges; the others get
    the mean of those."""
    from glorie_slam_tpu_torch.ops import cuda_corr
    inner = cuda_corr.lookup_pyramid

    def half(f1, f2, iis, jjs, coords):
        h = max(1, iis.shape[0] // 2)
        out = inner(f1, f2, iis[:h], jjs[:h], coords[:h])
        rest = out.float().mean(0, keepdim=True).to(out.dtype)
        return torch.cat([out, rest.expand(iis.shape[0] - h, -1, -1)])
    return _patch(cuda_corr, "lookup_pyramid", half)


def prior_altered():
    """The DPT's head output is off by 1% where it is produced."""
    from glorie_slam_tpu_torch.mapping import dpt
    inner = dpt.DPTDepthModel.__init__

    def init(self, *a, **k):
        inner(self, *a, **k)
        self.scratch.output_conv.register_forward_hook(
            lambda mod, args, out: out * 1.01)
    return _patch(dpt.DPTDepthModel, "__init__", init)


def step_frozen():
    """The mapper's optimizer steps leave the state unchanged."""
    from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
    inner = mapper_mod.make_optimizer

    def frozen(*a):
        opt = inner(*a)
        opt.step = lambda *x, **k: None
        return opt
    return _patch(mapper_mod, "make_optimizer", frozen)


def half_rays():
    """A train step leaves out the second half of its rays and weighs the
    rest twice (the mean over the rest)."""
    from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
    inner = mapper_mod._map_train_step

    def half(*args):
        args = list(args)
        inside = args[13].clone()
        inside[inside.shape[0] // 2:] = False
        args[13] = inside
        args[21] = tuple(2 * w for w in args[21])
        return inner(*args)
    return _patch(mapper_mod, "_map_train_step", half)


def loss_altered():
    """A train step reports its geometry loss 1% off."""
    from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
    inner = mapper_mod._map_train_step

    def altered(*args):
        out = inner(*args)
        out["geo_loss"] = out["geo_loss"] * 1.01
        return out
    return _patch(mapper_mod, "_map_train_step", altered)


def color_loss_dropped():
    """The colour stage's steps leave the colour loss out of what they
    backpropagate (the colour decoder then learns nothing)."""
    from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
    inner = mapper_mod._map_train_step

    def dropped(*args):
        args = list(args)
        if args[22] == "color":
            w_geo, _, w_warp = args[21]
            args[21] = (w_geo, 0.0, w_warp)
        return inner(*args)
    return _patch(mapper_mod, "_map_train_step", dropped)


TRACKING = ("ba_unchanged", "lookup_half", "prior_altered")
MAPPING = ("step_frozen", "half_rays", "loss_altered", "color_loss_dropped")


def install(name):
    """Plant fault ``name``; returns the function that removes it."""
    if name not in TRACKING + MAPPING:
        raise ValueError(f"no fault named {name!r}")
    return globals()[name]()
