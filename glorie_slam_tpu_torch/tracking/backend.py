"""Backend: global bundle adjustment and loop closure.

Counterpart of ``glorie_slam_tpu/tracking/backend.py``: dense global BA
over proximity edges with the chunked backend update
(``FactorGraph.update_lowmem``), and windowed loop closure seeded from the
frontend's local graph, optimized with the DSPO rounds.
"""

from ..core.factor_graph import FactorGraph
from .fused import graph_update_rounds


class Backend:
    def __init__(self, tracker_net, video, cfg):
        self.video = video
        self.tn = tracker_net
        self.beta = cfg["tracking"]["beta"]
        bcfg = cfg["tracking"]["backend"]
        self.backend_thresh = bcfg["thresh"]
        self.backend_radius = bcfg["radius"]
        self.backend_nms = bcfg["nms"]
        self.backend_normalize = bcfg["normalize"]
        self.backend_loop_window = bcfg["loop_window"]
        self.backend_loop_thresh = bcfg["loop_thresh"]
        self.backend_loop_radius = bcfg["loop_radius"]
        self.backend_loop_nms = bcfg["loop_nms"]

    def _ba(self, t_start, t_end, steps, graph, nms, radius, thresh,
            max_factors, t_start_loop=None, loop=False, enable_wq=True,
            fused=False):
        """Propose edges, then optimize (rounds when ``fused``, else the
        chunked backend update)."""
        if t_start_loop is None or not loop:
            t_start_loop = t_start
        edge_num = graph.add_backend_proximity_factors(
            t_start, t_end, nms, radius, thresh, max_factors, self.beta,
            t_start_loop, loop)
        if edge_num == 0:
            graph.clear_edges()
            return 0
        if fused:
            graph_update_rounds(graph, rounds=steps, t0=t_start_loop + 1,
                                t1=t_end, itrs=2, use_inactive=False,
                                alternate=enable_wq, lm=1e-5, ep=1e-2)
        else:
            graph.update_lowmem(t0=t_start_loop + 1, t1=t_end, itrs=2,
                                steps=steps, enable_wq=enable_wq)
        graph.clear_edges()
        return edge_num

    def dense_ba(self, steps=6, enable_wq=True):
        """Global BA over every keyframe."""
        t_start, t_end = 0, self.video.counter
        n = t_end - t_start
        max_factors = (self.backend_radius + 2) * 2 * n
        if self.backend_normalize:
            self.video.normalize()
        graph = FactorGraph(self.video, self.tn)
        n_edges = self._ba(t_start, t_end, steps, graph, self.backend_nms,
                           self.backend_radius, self.backend_thresh,
                           max_factors, enable_wq=enable_wq)
        self.video.set_dirty(t_start, t_end)
        return n, n_edges

    def loop_ba(self, t_start, t_end, steps=6, local_graph=None,
                enable_wq=True):
        """Windowed loop closure past the frontend window."""
        window = self.backend_loop_window
        max_factors = 8 * window
        t_start_loop = max(0, t_end - window)
        graph = FactorGraph(self.video, self.tn)
        if local_graph is not None:
            graph.ii = local_graph.ii.copy()
            graph.jj = local_graph.jj.copy()
            graph.age = local_graph.age.copy()
            graph.net = local_graph.net
            graph.inp = local_graph.inp
            graph.target = local_graph.target
            graph.weight = local_graph.weight
        left = max_factors - len(graph.ii)
        n_edges = self._ba(
            t_start, t_end, steps, graph, self.backend_loop_nms,
            self.backend_loop_radius, self.backend_loop_thresh, left,
            t_start_loop=t_start_loop, loop=True, enable_wq=enable_wq,
            fused=True)
        return t_end - t_start_loop, n_edges
