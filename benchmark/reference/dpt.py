"""Frozen copy of ``glorie_slam_tpu_torch/mapping/dpt.py``
for the benchmark's plain reference (imports nothing of the program).
The original's notes follow.

The omnidata DPT depth model (ViT-B/16 hybrid, ResNetV2-50 stem) as
``nn.Module``s.

Counterpart of ``glorie_slam_tpu/mapping/dpt.py`` (reference
src/mono_priors/omnidata/modules/midas/{dpt_depth,vit,blocks}.py):

* ResNetV2-50 stages 1-3 (weight-standardized convs with XLA "SAME"
  padding, GroupNorm 32 / 1e-5, non-pre-activation bottlenecks), hooks at
  1/4 (256 channels) and 1/8 (512 channels);
* ViT-B/16 over the 1/16 grid (768 dims, 12 blocks, 12 heads, class
  token, LayerNorm eps 1e-6, exact GELU), hooks on the raw outputs of
  blocks ``hooks`` (9 and 12);
* the "project" readout, the four RefineNet fusion blocks (256 features,
  bilinear ``align_corners=True`` upsampling) and the depth head.

Module and parameter names are the omnidata checkpoint's
(``pretrained.model.patch_embed.backbone.stages.1.blocks.0.conv1.weight``,
``scratch.refinenet1.resConfUnit2.conv1.weight``, ...), so the checkpoint
loads with ``load_state_dict`` (``import_dpt.load_omnidata_checkpoint``).
Where MiDaS holds a parameterless module between two that carry weights
(``act_postprocess*`` and ``scratch.output_conv``), an ``nn.Identity``
keeps the index.

Random weights follow the JAX package's initializers: lecun-normal kernels
(truncated at two standard deviations), zero biases, unit norm scales, a
zero class token and ``pos_embed`` N(0, 0.02) sized to the inference grid.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pad(x, k, s, value=0.0):
    """XLA "SAME" padding for a k x k window at stride s: the odd row and
    column go at the end (the 7x7/2 stem at 512 pads (2, 3))."""
    ih, iw = x.shape[-2:]
    ph = max((math.ceil(ih / s) - 1) * s + k - ih, 0)
    pw = max((math.ceil(iw / s) - 1) * s + k - iw, 0)
    return F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2],
                 value=value)


class StdConv(nn.Conv2d):
    """Weight-standardized conv without bias (timm StdConv2dSame, eps
    1e-8): the kernel is standardized per output channel over (in, kh, kw)
    with the biased variance."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=False)

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mean) / torch.sqrt(var + 1e-8)
        x = same_pad(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, w, None, self.stride)


class GNReLU(nn.GroupNorm):
    """timm GroupNormAct(32, eps=1e-5), with or without the ReLU."""

    def __init__(self, channels, act=True):
        super().__init__(32, channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class Downsample(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride)
        self.norm = GNReLU(cout, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm ResNetV2 non-pre-activation bottleneck: conv1-norm1-conv2
    (stride)-norm2-conv3-norm3, ReLU(y + shortcut)."""

    def __init__(self, cin, mid, cout, stride=1):
        super().__init__()
        self.downsample = (Downsample(cin, cout, stride)
                           if stride > 1 or cin != cout else None)
        self.conv1 = StdConv(cin, mid, 1)
        self.norm1 = GNReLU(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GNReLU(mid)
        self.conv3 = StdConv(mid, cout, 1)
        self.norm3 = GNReLU(cout, act=False)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.norm3(self.conv3(y))
        return F.relu(shortcut + y)


class Stage(nn.Module):
    def __init__(self, cin, mid, cout, depth, stride):
        super().__init__()
        self.blocks = nn.ModuleList(
            Bottleneck(cin if i == 0 else cout, mid, cout,
                       stride if i == 0 else 1) for i in range(depth))

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv(3, 64, 7, 2)
        self.norm = GNReLU(64)

    def forward(self, x):
        x = self.norm(self.conv(x))
        # 3x3/2 max-pool, "SAME": pads (0, 1) at 256 with -inf
        return F.max_pool2d(same_pad(x, 3, 2, -math.inf), 3, 2)


class ResNetStem(nn.Module):
    """ResNetV2-50 stages 1-3 (layers 3, 4, 9) through 1/16 -> (hook at 1/4,
    hook at 1/8, features at 1/16), NCHW."""

    def __init__(self):
        super().__init__()
        self.stem = Stem()
        self.stages = nn.ModuleList([Stage(64, 64, 256, 3, 1),
                                     Stage(256, 128, 512, 4, 2),
                                     Stage(512, 256, 1024, 9, 2)])

    def forward(self, x):
        x = self.stem(x)
        hooks = []
        for s in self.stages:
            x = s(x)
            hooks.append(x)
        return hooks[0], hooks[1], x


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        att = torch.softmax((q @ k.transpose(-2, -1))
                            * (D // self.heads) ** -0.5, dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, dim, ratio=4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class HybridEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.backbone = ResNetStem()
        self.proj = nn.Conv2d(1024, dim, 1)


class ViTHybrid(nn.Module):
    def __init__(self, dim, heads, n_blocks, grid):
        super().__init__()
        self.patch_embed = HybridEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1] + 1,
                                                  dim))
        self.blocks = nn.ModuleList(Block(dim, heads)
                                    for _ in range(n_blocks))
        # feeds only the unused global output: kept so the checkpoint maps
        self.norm = nn.LayerNorm(dim, eps=1e-6)


class ProjectReadout(nn.Module):
    """cat(grid tokens, class token) -> Linear -> GELU (vit.py:36-47)."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, t):
        cls, grid = t[:, :1], t[:, 1:]
        return self.project(torch.cat([grid, cls.expand_as(grid)], -1))


class Pretrained(nn.Module):
    def __init__(self, dim, heads, n_blocks, grid):
        super().__init__()
        self.model = ViTHybrid(dim, heads, n_blocks, grid)
        # MiDaS: readout, Transpose, Unflatten, 1x1 conv (, 3x3/2 conv)
        self.act_postprocess3 = nn.Sequential(
            ProjectReadout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, 768, 1))
        self.act_postprocess4 = nn.Sequential(
            ProjectReadout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, 768, 1),
            nn.Conv2d(768, 768, 3, stride=2, padding=1))


class ResidualConvUnit(nn.Module):
    """blocks.py ResidualConvUnit_custom (no batch norm, ReLU)."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def upsample2_ac(x):
    """2x bilinear upsampling with ``align_corners=True`` (blocks.py:335,
    dpt_depth.py:93)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class Upsample2(nn.Module):
    def forward(self, x):
        return upsample2_ac(x)


class FeatureFusion(nn.Module):
    """RefineNet fusion block (FeatureFusionBlock_custom: no deconv, no
    batch norm, no expand, align_corners=True)."""

    def __init__(self, features):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        # refinenet4 gets no skip: the JAX package adds 0 * resConfUnit1(x)
        # there so that the unit's checkpoint weights map; it is skipped here
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = upsample2_ac(self.resConfUnit2(x))
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, features):
        super().__init__()
        f = features
        self.layer1_rn = nn.Conv2d(256, f, 3, padding=1, bias=False)
        self.layer2_rn = nn.Conv2d(512, f, 3, padding=1, bias=False)
        self.layer3_rn = nn.Conv2d(768, f, 3, padding=1, bias=False)
        self.layer4_rn = nn.Conv2d(768, f, 3, padding=1, bias=False)
        self.refinenet1 = FeatureFusion(f)
        self.refinenet2 = FeatureFusion(f)
        self.refinenet3 = FeatureFusion(f)
        self.refinenet4 = FeatureFusion(f)
        # dpt_depth.py:91-98; the last ReLU is applied in ``taps``
        self.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), Upsample2(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1))


def _grid(size):
    h, w = (size, size) if isinstance(size, int) else size
    if h % 16 or w % 16:
        raise ValueError(f"DPT input sides must be multiples of 16: {size}")
    return h // 16, w // 16


def _lecun_normal_(w, gen):
    """flax ``lecun_normal``: N(0, 1/fan_in) truncated at 2 sigma (the
    standard deviation corrected for the truncation)."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class DPTDepthModel(nn.Module):
    """The hybrid DPT (reference dpt_depth.py:26-107) at inference size
    ``size`` (an int for a square, or (H, W), multiples of 16)."""

    def __init__(self, dim=768, heads=12, n_blocks=12, hooks=(8, 11),
                 features=256, size=512, seed=0):
        super().__init__()
        self.dim, self.hooks, self.grid = dim, tuple(hooks), _grid(size)
        self.pretrained = Pretrained(dim, heads, n_blocks, self.grid)
        self.scratch = Scratch(features)

    def _init(self, seed):
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("pos_embed"):
                with torch.no_grad():
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            elif name.endswith("cls_token") or name.endswith("bias"):
                nn.init.zeros_(p)
            elif p.dim() == 1:                      # norm scales
                nn.init.ones_(p)
            else:
                _lecun_normal_(p, gen)

    def taps(self, x):
        """x (B, 3, H, W), normalized to [-1, 1] -> the intermediate maps
        (NCHW, tokens (B, N, D)): ``hook0``/``hook1`` (backbone, 1/4 and
        1/8), ``t_hook0``/``t_hook1`` (transformer hooks), ``refinenet1``
        and ``pre_relu`` (the head's output before its last ReLU, (B, H,
        W)), and ``depth`` = ReLU(pre_relu)."""
        B, _, H, W = x.shape
        h16, w16 = H // 16, W // 16
        if (h16, w16) != self.grid:
            raise ValueError(f"DPT built for a {self.grid} grid, got "
                             f"{(h16, w16)}")
        vit, pre, s = self.pretrained.model, self.pretrained, self.scratch
        hook0, hook1, feat = vit.patch_embed.backbone(x)
        tokens = vit.patch_embed.proj(feat).flatten(2).transpose(1, 2)
        tokens = torch.cat([vit.cls_token.expand(B, -1, -1), tokens], 1)
        tokens = tokens + vit.pos_embed
        t_hooks = []
        for i, blk in enumerate(vit.blocks):
            tokens = blk(tokens)
            if i in self.hooks:
                t_hooks.append(tokens)
        if len(vit.blocks) - 1 not in self.hooks:
            t_hooks.append(tokens)
        t_hooks = t_hooks[:2]

        def reassemble(t, post):
            g = post[0](t).transpose(1, 2).reshape(B, self.dim, h16, w16)
            return post[3](g)

        l3 = reassemble(t_hooks[0], pre.act_postprocess3)       # 1/16
        l4 = pre.act_postprocess4[4](
            reassemble(t_hooks[1], pre.act_postprocess4))       # 1/32
        p4 = s.refinenet4(s.layer4_rn(l4))
        p3 = s.refinenet3(p4, s.layer3_rn(l3))
        p2 = s.refinenet2(p3, s.layer2_rn(hook1))
        p1 = s.refinenet1(p2, s.layer1_rn(hook0))
        pre_relu = s.output_conv(p1)[:, 0]
        return {"hook0": hook0, "hook1": hook1, "t_hook0": t_hooks[0],
                "t_hook1": t_hooks[1], "refinenet1": p1,
                "pre_relu": pre_relu, "depth": F.relu(pre_relu)}

    def forward(self, x):
        """x (B, 3, H, W) normalized -> depth (B, H, W) >= 0."""
        return self.taps(x)["depth"]
