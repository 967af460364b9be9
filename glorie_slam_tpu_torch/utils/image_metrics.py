"""Image quality metrics: PSNR, SSIM and MS-SSIM on the host, LPIPS on the
device.

Counterpart of ``glorie_slam_tpu/utils/image_metrics.py`` (which replaces
the reference's pytorch_msssim, torchmetrics LPIPS and eval_ssim.py).
PSNR, SSIM and MS-SSIM are host numpy in float64, as there (a copy, with
scipy's ``convolve1d`` in ``mode="reflect"``, which repeats the edge
sample). ``LPIPS`` is the AlexNet-feature distance as an ``nn.Module``.
"""

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def psnr(img_a, img_b, data_range=1.0):
    mse = np.mean((np.asarray(img_a, np.float64)
                   - np.asarray(img_b, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(img, k):
    """Separable 2D filtering of one channel, edges reflected."""
    from scipy.ndimage import convolve1d

    out = convolve1d(img, k, axis=0, mode="reflect")
    return convolve1d(out, k, axis=1, mode="reflect")


def _stats(a, b, k):
    mu_a, mu_b = _filter2d_sep(a, k), _filter2d_sep(b, k)
    s_aa = _filter2d_sep(a ** 2, k) - mu_a * mu_a
    s_bb = _filter2d_sep(b ** 2, k) - mu_b * mu_b
    s_ab = _filter2d_sep(a * b, k) - mu_a * mu_b
    return mu_a, mu_b, s_aa, s_bb, s_ab


def _as_hwc(img):
    a = np.asarray(img, np.float64)
    return a[..., None] if a.ndim == 2 else a


def ssim(img_a, img_b, data_range=1.0, win_size=11, sigma=1.5, full=False):
    """Gaussian-window SSIM (reference eval_ssim.py); images (H, W) or
    (H, W, C) in [0, data_range]."""
    a, b = _as_hwc(img_a), _as_hwc(img_b)
    k = _gaussian_window(win_size, sigma)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    maps = []
    for c in range(a.shape[-1]):
        mu_a, mu_b, s_aa, s_bb, s_ab = _stats(a[..., c], b[..., c], k)
        maps.append(((2 * mu_a * mu_b + C1) * (2 * s_ab + C2))
                    / ((mu_a * mu_a + mu_b * mu_b + C1) * (s_aa + s_bb + C2)))
    val = float(np.mean([m.mean() for m in maps]))
    return (val, np.stack(maps, -1)) if full else val


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2(img):
    H, W = img.shape[:2]
    img = img[: H - H % 2, : W - W % 2]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def ms_ssim(img_a, img_b, data_range=1.0, weights=_MSSSIM_WEIGHTS):
    """Multi-scale SSIM with pytorch_msssim's defaults (5 scales, its
    weights); fewer scales for small images."""
    a, b = _as_hwc(img_a), _as_hwc(img_b)
    k = _gaussian_window(11, 1.5)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    min_dim = min(a.shape[0], a.shape[1])
    max_levels = max(1, int(np.floor(np.log2(min_dim / 11))) + 1)
    levels = min(len(weights), max_levels)
    w = np.asarray(weights[:levels])
    w = w / w.sum()
    mcs = []
    for lvl in range(levels):
        cs_vals, ssim_vals = [], []
        for c in range(a.shape[-1]):
            mu_a, mu_b, s_aa, s_bb, s_ab = _stats(a[..., c], b[..., c], k)
            cs = (2 * s_ab + C2) / (s_aa + s_bb + C2)
            lum = (2 * mu_a * mu_b + C1) / (mu_a ** 2 + mu_b ** 2 + C1)
            cs_vals.append(cs.mean())
            ssim_vals.append((lum * cs).mean())
        if lvl < levels - 1:
            mcs.append(np.mean(cs_vals))
            a, b = _downsample2(a), _downsample2(b)
        else:
            final_ssim = np.mean(ssim_vals)
    vals = np.maximum(np.asarray(mcs + [final_ssim]), 1e-8)
    return float(np.prod(vals ** w))


# ---------------------------------------------------------------------------
# LPIPS(alex): scaling layer -> AlexNet features -> channel-unit-normalize
# -> squared difference -> non-negative 1x1 linear heads -> spatial mean ->
# sum over the 5 stages (torchmetrics LearnedPerceptualImagePatchSimilarity
# with net_type="alex", normalize=True, reference eval_render.py:27-28).
# With torchvision's alexnet.pth and the lpips package's alex.pth under
# $LPIPS_WEIGHTS (else weights/lpips at the repository root) the distance
# is LPIPS itself; without them the features are the JAX package's
# fixed-seed random convolutions with uniform heads ("untrained"), whose
# numbers are not comparable to published LPIPS.
# ---------------------------------------------------------------------------

_ALEX_CFG = (  # (out channels, kernel, stride, pad, max-pool before)
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)
_ALEX_IDX = (0, 3, 6, 8, 10)          # torchvision ``features.{i}``
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def lpips_random_params(seed=0):
    """The JAX package's fixed-seed convs (HWIO, He-normal) and uniform
    heads, drawn in its order."""
    rng = np.random.default_rng(seed)
    convs, lins = [], []
    cin = 3
    for cout, k, _s, _p, _mp in _ALEX_CFG:
        w = rng.normal(0, np.sqrt(2.0 / (cin * k * k)),
                       (k, k, cin, cout)).astype(np.float32)
        convs.append((w, np.zeros(cout, np.float32)))
        lins.append(np.full(cout, 1.0 / cout, np.float32))
        cin = cout
    return convs, lins


class LPIPS(nn.Module):
    """LPIPS(alex) distance between images (H, W, 3) in [0, 1].

    ``variant`` is "pretrained" (alexnet.pth and alex.pth loaded: the
    reference's metric) or "untrained" (the fixed-seed features); every
    metrics file that records an LPIPS value records it too."""

    def __init__(self):
        super().__init__()
        wdir = os.environ.get("LPIPS_WEIGHTS", os.path.join(
            os.path.dirname(__file__), "..", "..", "weights", "lpips"))
        alex_p = os.path.join(wdir, "alexnet.pth")
        lin_p = os.path.join(wdir, "alex.pth")
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, k, stride=s, padding=p)
            for cin, (cout, k, s, p, _mp) in zip(
                (3, 64, 192, 384, 256), _ALEX_CFG))
        for i, (cout, *_rest) in enumerate(_ALEX_CFG):
            self.register_buffer(f"lin{i}", torch.zeros(cout))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(3, 1, 1))
        if os.path.exists(alex_p) and os.path.exists(lin_p):
            astate = torch.load(alex_p, map_location="cpu", weights_only=True)
            lstate = torch.load(lin_p, map_location="cpu", weights_only=True)
            with torch.no_grad():
                for li, (conv, ci) in enumerate(zip(self.convs, _ALEX_IDX)):
                    conv.weight.copy_(astate[f"features.{ci}.weight"])
                    conv.bias.copy_(astate[f"features.{ci}.bias"])
                    getattr(self, f"lin{li}").copy_(
                        lstate[f"lin{li}.model.1.weight"].reshape(-1)
                        .clamp(min=0.0))
            self.variant = "pretrained"
        else:
            convs, lins = lpips_random_params()
            with torch.no_grad():
                for li, (conv, (w, b)) in enumerate(zip(self.convs, convs)):
                    conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
                    conv.bias.copy_(torch.from_numpy(b))
                    getattr(self, f"lin{li}").copy_(
                        torch.from_numpy(lins[li]))
            self.variant = "untrained"
        self.requires_grad_(False)

    def features(self, x):
        """x (B, 3, H, W) in [-1, 1] -> the 5 ReLU feature maps."""
        x = (x - self.shift) / self.scale
        feats = []
        for conv, (*_rest, mp) in zip(self.convs, _ALEX_CFG):
            if mp:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(conv(x))
            feats.append(x)
        return feats

    @torch.no_grad()
    def forward(self, img_a, img_b):
        """Images (H, W, 3) in [0, 1], numpy or tensors -> a 0-dim
        tensor on the module's device."""
        dev = self.shift.device

        def prep(img):
            x = torch.as_tensor(img, dtype=torch.float32, device=dev)
            return x.permute(2, 0, 1)[None] * 2.0 - 1.0

        total = torch.zeros((), device=dev)
        for li, (xa, xb) in enumerate(zip(self.features(prep(img_a)),
                                          self.features(prep(img_b)))):
            na = xa / torch.sqrt(torch.sum(xa ** 2, 1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb ** 2, 1, keepdim=True) + 1e-10)
            lw = getattr(self, f"lin{li}").view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((na - nb) ** 2 * lw, 1))
        return total
