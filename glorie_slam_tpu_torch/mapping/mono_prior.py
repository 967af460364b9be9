"""Mono-depth prior: the omnidata DPT run online, with an ``.npy`` cache.

Counterpart of ``glorie_slam_tpu/mapping/mono_prior.py`` (reference
src/mono_estimators.py:6-58): resize the frame to the inference size
(bilinear), normalize with (0.5, 0.5), run the DPT, clamp to [0, 1],
resize back to the frame size (bicubic) and clamp again. ``jax.image.resize``
antialiases when it shrinks, so both resizes are ``F.interpolate`` with
``antialias=True`` (the Keys cubic with a = -0.5 and the triangle filter
widened by the scale, weights renormalised at the borders, as JAX does).

Priors are cached at ``{data.output}/{scene}_priors/depths/{idx:05d}.npy``,
the layout the JAX package and the reference write, so a cache written by
either package is read by the other. The frame stays on the model's device;
the prior goes to the host once, for its ``.npy``.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.phase_timer import span, sync
from .dpt import DPTDepthModel


def resize(x, size, mode):
    """``jax.image.resize`` of (..., H, W) to ``size`` with its default
    antialiasing, for ``mode`` "bilinear" or "bicubic"."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((1, -1) + x.shape[-2:]), size=tuple(size),
                      mode=mode, align_corners=False, antialias=True)
    return y.reshape(lead + tuple(size))


class MonoDepthEstimator:
    def __init__(self, cfg, infer_size=512, device=None, write_cache=True):
        """cfg["mono_prior"]: ``depth`` ("omnidata"), ``depth_pretrained``
        (the checkpoint; random weights, seed 0, when it is absent);
        device: the card unless "cpu" is asked for; ``write_cache``: False
        reads the cache but never writes it (ranks other than 0)."""
        from ..device import resolve_device

        if cfg["mono_prior"]["depth"] != "omnidata":
            raise NotImplementedError(cfg["mono_prior"]["depth"])
        self.device = resolve_device(device)
        self.infer_size = infer_size
        self.write_cache = write_cache
        model = DPTDepthModel(size=infer_size)
        ckpt = cfg["mono_prior"].get("depth_pretrained")
        if ckpt and os.path.exists(ckpt):
            from .import_dpt import load_omnidata_checkpoint

            load_omnidata_checkpoint(ckpt, model)
        self.model = model.to(self.device).eval()
        self.out_dir = f"{cfg['data']['output']}/{cfg['scene']}_priors/depths"
        os.makedirs(self.out_dir, exist_ok=True)

    @torch.no_grad()
    def predict(self, image):
        """image (H, W, 3) in [0, 1] (numpy or tensor) -> depth (H, W), a
        float32 tensor on the model's device."""
        img = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        H, W = img.shape[:2]
        s = self.infer_size
        x = resize(img.permute(2, 0, 1), (s, s), "bilinear")
        x = (x - 0.5) / 0.5
        with span("mono_prior.dpt"):
            depth = self.model(x[None])[0].clamp(0.0, 1.0)
        # bicubic overshoots; the reference clamps again
        # (mono_estimators.py:48-50)
        return resize(depth, (H, W), "bicubic").clamp(0.0, 1.0)

    def predict_and_cache(self, tstamp, image):
        """The cached prior of frame ``tstamp`` (numpy) if there is one,
        else ``predict`` (a tensor on the device), saved to the cache."""
        path = f"{self.out_dir}/{int(tstamp):05d}.npy"
        if os.path.exists(path):
            return np.load(path)
        depth = self.predict(image)
        if self.write_cache:
            # written whole under a temporary name, then renamed: other
            # ranks of an edge group read the cache while rank 0 writes
            with span("mono_prior.cache_write"):
                tmp = f"{path}.{os.getpid()}.tmp.npy"
                with sync("prior_to_host"):
                    depth_np = depth.cpu().numpy()
                np.save(tmp, depth_np)
                os.replace(tmp, path)
        return depth
