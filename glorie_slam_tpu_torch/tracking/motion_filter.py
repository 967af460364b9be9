"""Motion filter: keyframe admission by estimated flow magnitude.

Counterpart of ``glorie_slam_tpu/tracking/motion_filter.py``: every frame
is encoded (fnet); one ConvGRU iteration against the last keyframe's
features at zero flow estimates the mean flow; frames past ``thresh``
become keyframes (cnet context and the store writes only then). The
tracker calls ``prefetch`` with the next frame before the frontend runs,
so the next frame's encode and probe are queued while the card is still
busy with this frame (the one-frame lookahead of the JAX package).

With ``predict_every`` (``mapping.every_frame`` when the prior is predicted
online) the mono prior is also predicted (and cached) at every frame with
``tstamp % predict_every == 0``, admitted or not, so that the
full-trajectory render evaluation finds a prior for each frame it renders;
an admitted frame on that cadence reuses the prediction (JAX
``motion_filter.py:65-69,135-141``). Under an edge group every rank
encodes and probes the frame, and the admission is rank 0's.
"""

import numpy as np
import torch

from ..geom import lie, projective
from ..nets import droid_net
from ..ops import corr as corr_mod
from ..parallel import mesh as mesh_mod
from ..utils.phase_timer import span, sync

_BF = torch.bfloat16


class MotionFilter:
    def __init__(self, tracker_net, video, thresh=2.5, mono_predictor=None,
                 predict_every=None):
        """mono_predictor: callable(tstamp, image_hw3_01) -> (H, W) depth
        or None; predict_every: its cadence (None: admitted frames only)."""
        self.tn = tracker_net
        self.video = video
        self.thresh = thresh
        self.mono_predictor = mono_predictor
        self.predict_every = predict_every
        self.count = 0          # frames since the last admission
        self.fmap = None
        self.net = None
        self.inp = None
        self._pending = None

    def _image(self, image):
        with sync("frame_upload"):
            return torch.as_tensor(np.asarray(image), dtype=torch.float32,
                                   device=self.video.device)

    def _encode_and_flow(self, image):
        """fnet encode of ``image`` (H, W, 3) + one GRU step against the
        last keyframe -> (fmap (1,128,h,w), mean |delta| (0-dim tensor))."""
        inputs = droid_net.normalize_images(image[None]).permute(0, 3, 1, 2)
        fmap_new = self.tn.features(inputs)
        h, w = fmap_new.shape[2:]
        coords0 = projective.coords_grid(h, w, device=fmap_new.device)[None]
        pair = torch.cat([self.fmap, fmap_new]).permute(0, 2, 3, 1)
        feat_pyr = corr_mod.prep_feat_pyramid(pair.to(_BF).contiguous())
        zero = torch.zeros(1, dtype=torch.int32, device=fmap_new.device)
        corr = corr_mod.lookup_pyramid_feats(feat_pyr, zero, zero + 1,
                                             coords0)
        _, delta, _ = self.tn.update(
            self.net.to(_BF), self.inp.to(_BF),
            corr.permute(0, 3, 1, 2), None)
        return fmap_new, torch.linalg.norm(delta.float(), dim=1).mean()

    def prefetch(self, tstamp, image):
        """Queue the next frame's encode + flow probe (see module doc)."""
        if self.video.counter == 0 or self.fmap is None:
            return
        image = self._image(image)
        self._pending = (tstamp, self._encode_and_flow(image), image)

    def track(self, tstamp, image, intrinsics):
        """image (H, W, 3) float in [0, 1]; intrinsics full-res
        [fx, fy, cx, cy]. Returns True when the frame became a keyframe."""
        if self.video.counter == 0:
            image = self._image(image)
            inputs = droid_net.normalize_images(image[None]).permute(
                0, 3, 1, 2)
            gmap = self.tn.features(inputs)
            delta_norm = None
        elif self._pending is not None and self._pending[0] == tstamp:
            (gmap, delta_norm), image = self._pending[1], self._pending[2]
            self._pending = None
        else:
            self._pending = None
            image = self._image(image)
            gmap, delta_norm = self._encode_and_flow(image)

        mono = None
        if (self.mono_predictor is not None and self.predict_every
                and int(tstamp) % self.predict_every == 0):
            with span("tracker.mono_prior"):
                mono = self.mono_predictor(tstamp, image)
        if self.video.counter == 0:
            self._admit(tstamp, image, intrinsics, gmap, mono, first=True)
            return True
        with sync("admission"):
            delta = float(delta_norm)
        if mesh_mod.from_rank0(self.video.group, delta > self.thresh):
            self.count = 0
            self._admit(tstamp, image, intrinsics, gmap, mono)
            return True
        self.count += 1
        return False

    def _admit(self, tstamp, image, intrinsics, gmap, mono, first=False):
        if mono is None and self.mono_predictor is not None:
            with span("tracker.mono_prior"):
                mono = self.mono_predictor(tstamp, image)
        intr8 = np.asarray(intrinsics, np.float32) / self.video.down_scale
        v = self.video
        if first:
            inputs = droid_net.normalize_images(image[None]).permute(
                0, 3, 1, 2)
            net, inp = self.tn.context(inputs)
            v.append(tstamp, (image * 255.0).clamp(0, 255).to(torch.uint8),
                     lie.identity(), 1.0, mono, intr8,
                     gmap[0].permute(1, 2, 0), net[0].permute(1, 2, 0),
                     inp[0].permute(1, 2, 0))
        else:
            net, inp = v.append_admitted(tstamp, image, mono, gmap, self.tn,
                                         intrinsics=intr8)
        self.fmap, self.net, self.inp = gmap, net, inp
