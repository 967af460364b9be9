"""PoseTrajectoryFiller: recover the poses of non-keyframes after tracking.

Counterpart of ``glorie_slam_tpu/tracking/trajectory_filler.py``: frames
go in batches of 16; each pose is seeded by geodesic interpolation between
the bracketing keyframes; the batch's features go into scratch slots past
the keyframes (disparity 1, net/inp from the earlier keyframe); two edges
per frame tie it to its bracketing keyframes, and 12 motion-only updates
refine the scratch poses. The video's counter is restored afterwards.

One deliberate difference from the JAX package: after writing the scratch
slots' features, the filler refreshes their lookup stores
(``DepthVideo._update_corr_stores``), so its edges correlate against the
scratch frames' own features, as the reference does. The JAX filler never
refreshes them and correlates against whatever those store rows held.
"""

import numpy as np
import torch

from ..core.factor_graph import FactorGraph
from ..geom import lie
from ..nets import droid_net

BATCH = 16
UPDATES = 12


class PoseTrajectoryFiller:
    def __init__(self, tracker_net, video, printer=None):
        self.tn = tracker_net
        self.video = video
        self.printer = printer

    def _fill(self, timestamps, images, intrinsics):
        """Fill one batch: timestamps (M,), images M x (H, W, 3) in [0, 1].
        Returns the batch's (M, 7) w2c poses as numpy."""
        v = self.video
        dev = v.device
        N = v.counter
        M = len(timestamps)
        if N + M > v.buffer:
            raise ValueError(
                f"trajectory filler needs {M} scratch slots past the "
                f"{N} keyframes but tracking.buffer={v.buffer}; raise "
                "tracking.buffer by at least "
                f"{N + M - v.buffer} to fill the full trajectory")
        tt = np.asarray(timestamps, np.float32)
        ts = v.timestamp[:N].cpu().numpy()

        # bracketing keyframes per query timestamp
        t0 = np.array([max(int((ts <= t).sum()) - 1, 0) for t in tt])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        dt = torch.as_tensor(ts[t1] - ts[t0] + 1e-3, device=dev)
        since = torch.as_tensor(tt - ts[t0], device=dev)
        t0_d = torch.as_tensor(t0, device=dev)
        P0 = v.poses[t0_d]
        P1 = v.poses[torch.as_tensor(t1, device=dev)]
        w = lie.log(lie.mul(P1, lie.inv(P0))) / dt[:, None] * since[:, None]
        Gs = lie.mul(lie.exp(w), P0)

        imgs = torch.as_tensor(np.stack(images), dtype=torch.float32,
                               device=dev)
        inputs = droid_net.normalize_images(imgs).permute(0, 3, 1, 2)
        fmaps = self.tn.features(inputs).permute(0, 2, 3, 1)

        v.counter = N + M
        idx = torch.arange(N, N + M, device=dev)
        v.timestamp[idx] = torch.as_tensor(tt, device=dev)
        v.poses[idx] = Gs
        v.disps[idx] = 1.0
        v.fmaps[idx] = fmaps.to(torch.bfloat16)
        for ix in range(N, N + M):
            v._update_corr_stores(ix)
        v.nets[idx] = v.nets[t0_d]
        v.inps[idx] = v.inps[t0_d]

        graph = FactorGraph(v, self.tn)
        new = np.arange(N, N + M)
        graph.add_factors(t0, new)
        graph.add_factors(t1, new)
        for _ in range(UPDATES):
            graph.update(N, N + M, motion_only=True)

        out = v.poses[N:N + M].cpu().numpy()
        v.counter = N
        return out

    def __call__(self, stream):
        """Fill every frame's pose; returns (len(stream), 7) w2c poses."""
        if self.printer is not None:
            self.printer.print("Filling full trajectory ...",
                               subsystem="info")
        intrinsic = stream.get_intrinsic()
        poses = []
        timestamps, images = [], []
        for i in range(len(stream)):
            timestamp, image = stream[i][0], stream[i][1]
            timestamps.append(timestamp)
            images.append(image)
            if len(timestamps) == BATCH:
                poses.append(self._fill(timestamps, images, intrinsic))
                timestamps, images = [], []
        if timestamps:
            poses.append(self._fill(timestamps, images, intrinsic))
        return np.concatenate(poses, 0)
