"""TrackerNet: the DroidNet weights plus the calls the tracker makes.

Counterpart of ``glorie_slam_tpu/nets/tracker_net.py``. The net computes in
``dtype``: bf16 on the card by default, as the JAX package does; float32
where a caller asks for it (the CPU tests). Inputs are cast to ``dtype`` on
entry; outputs stay in ``dtype`` and the callers cast, as in the JAX
package. Random weights come from an explicit ``torch.Generator`` seeded by
``seed`` (no droid.pth is shipped); ``state_dict`` loads given weights,
for example from ``import_flax.flax_params_to_state_dict``, and
``from_checkpoint`` loads ``droid.pth``.
"""

import torch

from ..device import resolve_device
from ..utils.phase_timer import span
from .droid_net import DroidNet
from .import_torch import load_droid_checkpoint


class TrackerNet:
    def __init__(self, state_dict=None, dtype=None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if dtype is None:
            dtype = (torch.bfloat16 if self.device.type == "cuda"
                     else torch.float32)
        self.dtype = dtype
        model = DroidNet()
        if state_dict is None:
            _random_init(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device, dtype).eval()
        self.model.requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, path, dtype=None, device=None):
        """Load ``droid.pth`` (``import_torch.load_droid_checkpoint``)."""
        return cls(state_dict=load_droid_checkpoint(path), dtype=dtype,
                   device=device)

    def features(self, images):
        """images (B, 3, H, W) normalized -> fmaps (B, 128, H/8, W/8)."""
        with span("net.fnet"):
            return self.model.features(images.to(self.dtype))

    def context(self, images):
        """images (B, 3, H, W) -> (net (B,128,h,w) tanh, inp relu)."""
        with span("net.cnet"):
            return self.model.context(images.to(self.dtype))

    def update(self, net, inp, corr, flow=None, kk=None, num_frames=0,
               with_upmask=True):
        d = self.dtype
        with span("net.update"):
            return self.model.update(
                net.to(d), inp.to(d), corr.to(d),
                None if flow is None else flow.to(d), kk, num_frames,
                with_upmask=with_upmask)

    def agg(self, net, kk, num_frames):
        """GraphAgg alone on a hidden state -> (eta, upmask)."""
        with span("net.agg"):
            return self.model.update.agg(net.to(self.dtype), kk, num_frames,
                                         with_upmask=True)


def _random_init(model, gen):
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every conv weight and
    bias, drawn from ``gen`` in module order (the scale of PyTorch's default
    conv init, made reproducible)."""
    with torch.no_grad():
        for _, mod in model.named_modules():
            if isinstance(mod, torch.nn.Conv2d):
                bound = 1.0 / (mod.weight[0].numel() ** 0.5)
                mod.weight.uniform_(-bound, bound, generator=gen)
                mod.bias.uniform_(-bound, bound, generator=gen)
