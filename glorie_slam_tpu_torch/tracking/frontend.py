"""Frontend: local BA with DSPO alternation and keyframe culling.

Counterpart of ``glorie_slam_tpu/tracking/frontend.py``: initialization at
``warmup`` keyframes, then per keyframe: proximity edges (with rm-by-age
and eviction in one maintenance step), 8 DSPO rounds, the keyframe-distance
check (cull or keep), and either loop closure past the window or 4 more
rounds. Under an edge group the keyframe-distance decision is rank 0's.
"""

from ..core.factor_graph import FactorGraph
from ..parallel import mesh as mesh_mod
from .backend import Backend
from ..utils.phase_timer import span
from .fused import graph_update_rounds


class Frontend:
    def __init__(self, tracker_net, video, cfg):
        self.video = video
        self.tn = tracker_net
        self.t1 = 0
        self.is_initialized = False
        tcfg = cfg["tracking"]
        self.max_age = tcfg["max_age"]
        self.iters1 = 4 * 2
        self.iters2 = 2 * 2
        self.warmup = tcfg["warmup"]
        self.beta = tcfg["beta"]
        fcfg = tcfg["frontend"]
        self.frontend_nms = fcfg["nms"]
        self.keyframe_thresh = fcfg["keyframe_thresh"]
        self.frontend_window = fcfg["window"]
        self.frontend_thresh = fcfg["thresh"]
        self.frontend_radius = fcfg["radius"]
        self.frontend_max_factors = fcfg["max_factors"]
        self.enable_loop = fcfg["enable_loop"]
        self.loop_closing = Backend(tracker_net, video, cfg)
        self.graph = FactorGraph(video, tracker_net,
                                 max_factors=self.frontend_max_factors)
        self.last_loop_t = -1

    def _update(self):
        """Per-keyframe local BA."""
        self.t1 += 1
        g = self.graph
        age_mask = g.age > self.max_age if len(g.ii) > 0 else None
        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - self.frontend_window, 0),
            rad=self.frontend_radius, nms=self.frontend_nms,
            thresh=self.frontend_thresh, beta=self.beta, remove=True,
            pre_rm_mask=age_mask)
        d = graph_update_rounds(g, self.iters1, use_inactive=True)
        cur_t = self.video.counter
        if d is None:
            d = self.video.distance([self.t1 - 2], [self.t1 - 1],
                                    beta=self.beta, bidirectional=True)[0]
        if mesh_mod.from_rank0(self.video.group,
                               bool(d < self.keyframe_thresh)):
            g.rm_keyframe(self.t1 - 1)
            self.video.counter -= 1
            self.t1 -= 1
        else:
            ran_loop = False
            if self.enable_loop and cur_t > self.frontend_window:
                with span("tracker.loop_closure"):
                    _, n_edge = self.loop_closing.loop_ba(
                        t_start=0, t_end=cur_t, steps=self.iters2,
                        local_graph=g, enable_wq=True)
                ran_loop = n_edge > 0
                self.last_loop_t = cur_t
            if not ran_loop:
                graph_update_rounds(g, self.iters2, use_inactive=True)
        v = self.video
        if self.t1 < v.buffer:
            v.poses[self.t1] = v.poses[self.t1 - 1]
            v.disps[self.t1] = v.disps[self.t1 - 1].mean()
        v.set_dirty(int(g.ii.min()), self.t1)

    def _initialize(self):
        """Bootstrap on the first ``warmup`` keyframes."""
        self.t1 = self.video.counter
        g = self.graph
        g.add_neighborhood_factors(0, self.t1, r=3)
        graph_update_rounds(g, 8, t0=1, use_inactive=True, alternate=False)
        g.add_proximity_factors(0, 0, rad=2, nms=2,
                                thresh=self.frontend_thresh, remove=False)
        graph_update_rounds(g, 8, t0=1, use_inactive=True, alternate=False)
        v = self.video
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 4:self.t1].mean()
        self.is_initialized = True
        v.set_dirty(0, self.t1)
        g.rm_factors(g.ii < self.warmup - 4, store=True)

    def __call__(self):
        """Per-frame hook."""
        if not self.is_initialized and self.video.counter == self.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()
