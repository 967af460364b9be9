"""Wrappers around the program's calls, installed from outside the package.

They replace module attributes and instance attributes at run time and hook
the nets' modules (no file of the program is edited), and do three things:

* spans: a ``record_function`` range around each call into a layer, and in
  traced runs a synchronized host-clock span as well (``host_s``);
* records: in the profiled stretch, the shapes and indices of each call
  that a per-layer metric counts (``calls``);
* capture: at the sampled keyframe (``arm``), a copy of the inputs and the
  outputs of the first call of each checked stage, for the comparison with
  the plain reference once the window has closed.
"""

import time
from collections import defaultdict

import numpy as np
import torch


def copy(x):
    """Detached copies of the tensors and arrays in ``x`` (nested)."""
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, (list, tuple)):
        return type(x)(copy(v) for v in x)
    if isinstance(x, dict):
        return {k: copy(v) for k, v in x.items()}
    return x


def device_sync(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


class Probes:
    """Spans, stretch records and captures shared by the cells' probes."""

    def __init__(self, device, tracing):
        self.sync = device_sync(device)
        self.tracing = tracing
        self.stretch = False
        self.armed = False
        self.captured = {}
        self.host_s = defaultdict(float)
        self.host_n = defaultdict(int)
        self.calls = defaultdict(list)
        self._undo = []

    # -- installation ------------------------------------------------------
    def replace(self, obj, name, new):
        old = getattr(obj, name)
        had = name in vars(obj)
        setattr(obj, name, new)

        def undo():
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo.append(undo)
        return old

    def hook(self, module, pre=None, post=None):
        if pre is not None:
            self._undo.append(module.register_forward_pre_hook(
                pre, with_kwargs=True).remove)
        if post is not None:
            self._undo.append(module.register_forward_hook(
                post, with_kwargs=True).remove)

    def uninstall(self):
        while self._undo:
            self._undo.pop()()

    # -- spans ---------------------------------------------------------------
    def open(self, name, synced=False):
        """Enter a span; returns the token for ``close``."""
        t = None
        if synced and self.tracing:
            self.sync()
            t = time.perf_counter()
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        return name, rf, t

    def close(self, token):
        name, rf, t = token
        if t is not None:
            self.sync()
            self.host_s[name] += time.perf_counter() - t
            self.host_n[name] += 1
        rf.__exit__(None, None, None)

    def wrap(self, fn, name, synced=False, before=None, after=None):
        """``fn`` inside a span; ``before(args, kwargs)`` may return a state
        that ``after(state, args, kwargs, out)`` receives."""
        def wrapped(*args, **kwargs):
            state = before(args, kwargs) if before else None
            tok = self.open(name, synced)
            try:
                out = fn(*args, **kwargs)
            finally:
                self.close(tok)
            if after:
                after(state, args, kwargs, out)
            return out
        return wrapped

    def take(self, stage, cond=True):
        """True once per armed step for ``stage`` (when ``cond``)."""
        return self.armed and cond and stage not in self.captured


class TrackProbes(Probes):
    """The tracking cells' wrappers on one ``SLAM``."""

    def __init__(self, slam, device, tracing):
        super().__init__(device, tracing)
        from glorie_slam_tpu_torch.geom import ba as ba_mod
        from glorie_slam_tpu_torch.ops import cuda_corr
        from glorie_slam_tpu_torch.ops import depth_filter as df_mod

        tr = slam.tracker
        self.in_frontend = False
        self.net_depth = 0
        self.replace(tr, "frontend", _FrontendProxy(tr.frontend, self))
        ob = tr.online_ba
        self.replace(ob, "dense_ba", self.wrap(ob.dense_ba, "layer.online_ba",
                                               synced=True))
        mf = tr.motion_filter
        self.replace(mf, "mono_predictor", self.wrap(
            mf.mono_predictor, "layer.mono_prior", synced=True,
            after=self._after_dpt))
        dpt = slam.mono_estimator.model
        self.hook(dpt, pre=self._dpt_in)
        self.hook(dpt.scratch.output_conv, post=self._dpt_out)
        net = slam.tracker_net.model
        for name, mod in (("fnet", net.fnet), ("cnet", net.cnet),
                          ("update", net.update), ("agg", net.update.agg)):
            self.hook(mod, self._net_pre(name), self._net_post(name))
        self.replace(cuda_corr, "lookup_pyramid", self.wrap(
            cuda_corr.lookup_pyramid, "kernel.lookup_pyramid",
            before=self._before_lookup, after=self._after_lookup))
        self.replace(cuda_corr, "depth_agree", self.wrap(
            cuda_corr.depth_agree, "kernel.depth_agree",
            after=self._after_agree))
        for mod, attr, stage in ((ba_mod, "ba", "dba"),
                                 (ba_mod, "ba_scale_shift", "dspo"),
                                 (df_mod, "depth_filter", "depth_filter")):
            self.replace(mod, attr, self.wrap(
                getattr(mod, attr), f"solve.{stage}",
                before=self._before_stage(stage),
                after=self._after_stage(stage)))

    # the mono prior: the DPT's input and its head's output before the
    # last ReLU and the clamps (random weights saturate the clamped depth)
    def _after_dpt(self, _state, args, kwargs, out):
        if self.stretch:
            self.calls["dpt"].append(1)

    def _dpt_in(self, mod, args, kwargs):
        if self.take("dpt"):
            self.captured["dpt"] = {"x": copy(args[0])}

    def _dpt_out(self, mod, args, kwargs, out):
        cap = self.captured.get("dpt")
        if cap is not None and "out" not in cap:
            cap["out"] = copy(out[:, 0])

    # the DROID net: one span over nested calls (update holds agg)
    def _net_pre(self, name):
        def pre(mod, args, kwargs):
            self.net_depth += 1
            if self.net_depth == 1:
                self._net_tok = self.open("droid_net")
                if self.stretch:
                    self.calls["net"].append(_net_shape(name, args, kwargs))
            if name in ("fnet", "cnet") and self.take(name):
                self.captured[name] = {"args": copy(args)}
            elif name == "update" and self.take(name, self.in_frontend):
                self.captured[name] = {"args": copy(args),
                                       "kwargs": copy(kwargs)}
        return pre

    def _net_post(self, name):
        def post(mod, args, kwargs, out):
            cap = self.captured.get(name)
            if cap is not None and "out" not in cap:
                cap["out"] = copy(out)
            self.net_depth -= 1
            if self.net_depth == 0:
                self.close(self._net_tok)
        return post

    # kernel A's function
    def _before_lookup(self, args, kwargs):
        f1, f2, iis, jjs, coords = args
        if self.stretch:
            self.calls["lookup"].append(dict(
                iis=iis, jjs=jjs, coords=coords,
                dims=[tuple(lv.shape[1:3]) for lv in f2],
                shared=f2[0].data_ptr() == f1.data_ptr()))
        if self.take("lookup", self.in_frontend):
            return compact_lookup_inputs(f1, f2, iis, jjs, coords)
        return None

    def _after_lookup(self, state, args, kwargs, out):
        if state is not None:
            self.captured["lookup"] = {"args": state, "out": copy(out)}

    # kernel B's function
    def _after_agree(self, state, args, kwargs, out):
        if self.stretch:
            dmaps, jxs, cu = args
            self.calls["agree"].append(dict(
                jxs=jxs, cu=cu, ht=dmaps.shape[1], wd=dmaps.shape[2]))

    # the solves and the depth filter
    def _before_stage(self, stage):
        def before(args, kwargs):
            if self.take(stage, self.in_frontend):
                return {"args": copy(args), "kwargs": copy(kwargs)}
            return None
        return before

    def _after_stage(self, stage):
        def after(state, args, kwargs, out):
            if state is not None:
                state["out"] = copy(out)
                self.captured[stage] = state
        return after


class _FrontendProxy:
    """Stands in for ``Tracker.frontend``: its call runs inside a span with
    the frontend flag set; every attribute is the frontend's."""

    def __init__(self, inner, probes):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_probes", probes)

    def __call__(self):
        p = self._probes
        p.in_frontend = True
        tok = p.open("layer.frontend", synced=True)
        try:
            return self._inner()
        finally:
            p.close(tok)
            p.in_frontend = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)


def _net_shape(name, args, kwargs):
    """(part, batch, h, w, frames, with GraphAgg, with the upsample mask) of
    a net call, for the operation count."""
    x = args[0]
    if name in ("fnet", "cnet"):
        return (name, x.shape[0], x.shape[2], x.shape[3], 0, False, False)
    if name == "update":
        kk = args[4] if len(args) > 4 else kwargs.get("kk")
        frames = args[5] if len(args) > 5 else kwargs.get("num_frames", 0)
        up = kwargs.get("with_upmask", args[6] if len(args) > 6 else True)
        return ("update", x.shape[0], x.shape[2], x.shape[3], int(frames),
                kk is not None, bool(up and kk is not None))
    frames = args[2] if len(args) > 2 else kwargs.get("num_frames", 0)
    return ("agg", x.shape[0], x.shape[2], x.shape[3], int(frames), True,
            True)


def compact_lookup_inputs(f1, f2_levels, iis, jjs, coords):
    """Copies of only the frames a lookup reads, renumbered (level 0 of f2
    stays a view of f1's copy when it is one on the main path)."""
    used = torch.unique(torch.cat([iis.long(), jjs.long()]))
    remap = torch.full((f1.shape[0],), -1, dtype=torch.long,
                       device=f1.device)
    remap[used] = torch.arange(used.numel(), device=f1.device)
    f1c = f1[used].clone()
    f2c = [lv[used].clone() for lv in f2_levels]
    if f2_levels[0].data_ptr() == f1.data_ptr():
        f2c[0] = f1c.view(f2c[0].shape)
    return (f1c, f2c, remap[iis.long()].to(iis.dtype),
            remap[jjs.long()].to(jjs.dtype), coords.clone())


class MapProbes(Probes):
    """The mapper cell's wrappers: ``_map_train_step`` and ``knn_search``.
    ``control`` receives ``before_step()`` and ``after_step(n, stage)``
    from the step wrapper (the window's clock: it may ask for a step of the
    set-up to be skipped, and ends the window). Once ``armed``, the first
    ``capture`` steps of each of the mapper's two stages are captured for
    the reference, with the state before the first of them (decoders,
    features and the optimizer's moments)."""

    STAGES = ("geometry", "color")

    def __init__(self, device, tracing, control, capture=3):
        super().__init__(device, tracing)
        from glorie_slam_tpu_torch.mapping import mapper as mapper_mod
        from glorie_slam_tpu_torch.ops import knn as knn_mod

        self.control = control
        self.n_capture = capture
        self.in_step = False
        self.steps = 0
        self.skipped = 0
        self.inner_step = self.replace(mapper_mod, "_map_train_step",
                                       self._step)
        self.inner_knn = self.replace(knn_mod, "knn_search", self._knn)

    def _knn(self, *args, **kwargs):
        if not self.in_step:
            return self.inner_knn(*args, **kwargs)
        tok = self.open("map.knn")
        try:
            return self.inner_knn(*args, **kwargs)
        finally:
            self.close(tok)

    def done(self, stage):
        return "final" in self.captured.get(stage, {})

    def _step(self, *args, **kwargs):
        if self.control.before_step():
            self.skipped += 1
            z = torch.zeros((), device=args[8].device)
            return {"geo_loss": z, "color_loss": z, "warp_loss": z,
                    "n_mask": z}
        (decoders, rcfg, opt, geo, col) = args[:5]
        stage = args[22] if len(args) > 22 else kwargs["stage"]
        if (self.armed and stage in self.STAGES
                and stage not in self.captured):
            self.captured[stage] = {
                "state": train_state(decoders, opt, geo, col),
                "calls": [], "losses": []}
        cap = self.captured.get(stage)
        taking = self.armed and cap is not None and "final" not in cap
        if taking:
            cap["calls"].append(step_call(args, kwargs))
        if self.stretch:
            self.calls["step"].append(dict(
                rays=args[8].shape[0], samples=rcfg.N_surface,
                cap=geo.shape[0], stage=stage))
        self.in_step = True
        tok = self.open("map.step")
        try:
            out = self.inner_step(*args, **kwargs)
        finally:
            self.close(tok)
            self.in_step = False
        if taking:
            cap["losses"].append({k: float(v) for k, v in out.items()})
            n = len(cap["calls"])
            if n == 1:
                cap["grad1"] = first_gradients(decoders, opt, geo, col,
                                               cap["state"]["adam"])
            if n == self.n_capture:
                final = {f"decoders.{k}": copy(v) for k, v in
                         decoders.named_parameters()}
                final["geo"], final["col"] = copy(geo), copy(col)
                cap["final"] = final
                self.armed = not all(self.done(s) for s in self.STAGES)
        self.steps += 1
        self.control.after_step(self.steps, stage)
        return out


def _leaves(decoders, opt, geo, col):
    """(name, parameter) of the optimizer's leaves, in its groups' order:
    the decoders' weights, the geometry features, the colour features."""
    names = ([f"decoders.{k}" for k, _ in decoders.named_parameters()]
             + ["geo", "col"])
    params = [p for g in opt.param_groups for p in g["params"]]
    return list(zip(names, params))


def train_state(decoders, opt, geo, col):
    """Copies of what a train step starts from: decoder weights and
    buffers, features, and Adam's moments and step count (``adam`` None
    while the optimizer has made no step)."""
    state = {"decoders": {k: copy(v) for k, v in decoders.named_parameters()},
             "buffers": {k: copy(v) for k, v in decoders.named_buffers()},
             "geo": copy(geo), "col": copy(col), "adam": None}
    leaves = _leaves(decoders, opt, geo, col)
    if all("exp_avg" in opt.state[p] for _, p in leaves):
        state["adam"] = {
            "m": {k: copy(opt.state[p]["exp_avg"]) for k, p in leaves},
            "v": {k: copy(opt.state[p]["exp_avg_sq"]) for k, p in leaves},
            "t": int(opt.state[leaves[0][1]]["step"])}
    return state


def first_gradients(decoders, opt, geo, col, adam):
    """Each leaf's gradient as Adam received it in the step just made,
    from its first moment after and before: (m1 - b1 m0) / (1 - b1). An
    optimizer that made no step has no moments: then nothing reached it."""
    b1 = opt.defaults["betas"][0]
    out = {}
    for k, p in _leaves(decoders, opt, geo, col):
        st = opt.state[p]
        if "exp_avg" not in st:
            out[k] = torch.zeros_like(p)
            continue
        m1 = st["exp_avg"].detach()
        m0 = adam["m"][k] if adam is not None else torch.zeros_like(m1)
        out[k] = (m1 - b1 * m0) / (1 - b1)
    return out


STEP_ARGS = ("decoders", "rcfg", "opt", "geo", "col", "lrs", "cloud_pos",
             "count", "rays_o", "rays_d", "render_depth", "gt_color",
             "r_query", "inside_mask", "ray_frame_slot", "frame_valid",
             "c2ws", "img_colors", "feat_mask", "dec_mask", "intr",
             "w_losses", "stage", "pix_warp", "Wi", "Hi")


def step_call(args, kwargs):
    """The arguments of one ``_map_train_step`` call by name, copied
    (without the modules, the optimizer and the trained features)."""
    named = dict(zip(STEP_ARGS, args))
    named.update(kwargs)
    for k in ("decoders", "opt", "geo", "col"):
        named.pop(k)
    named["rcfg"] = tuple(named["rcfg"])
    return copy(named)
