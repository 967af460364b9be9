"""DROID tracker networks as ``nn.Module``s (NCHW).

Counterpart of ``glorie_slam_tpu/nets/droid_net.py``. The modules keep the
reference checkpoint's (droid.pth) structure and state-dict names:
``fnet``/``cnet`` BasicEncoders, and ``update`` with ``corr_encoder``,
``flow_encoder``, ``delta``/``weight`` heads, ``gru`` (convz/convr/convq
with their ``_glo`` twins and ``w``) and ``agg``. The delta/weight heads
have 2 output channels: the reference's head slice (slam.py:75-78) is the
checkpoint loader's job.

Callers pass NCHW tensors that may be channels-last in memory (the video's
feature stores are NHWC; ``x.permute(0, 3, 1, 2)`` of such a store is an
NCHW view with channels-last strides, which cuDNN takes as it is).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

DIM = 32
CORR_PLANES = 4 * (2 * 3 + 1) ** 2

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def normalize_images(images):
    """images (..., H, W, 3) in [0, 1] -> ImageNet-normalized."""
    mean = images.new_tensor(IMAGE_MEAN)
    std = images.new_tensor(IMAGE_STD)
    return (images - mean) / std


def _norm(x, norm_fn):
    if norm_fn == "instance":
        return F.instance_norm(x, eps=1e-5)
    return x


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride,
                               padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_planes, planes, 1, stride=stride))
            if stride > 1 else None)

    def forward(self, x):
        y = F.relu(_norm(self.conv1(x), self.norm_fn))
        y = F.relu(_norm(self.conv2(y), self.norm_fn))
        if self.downsample is not None:
            x = _norm(self.downsample(x), self.norm_fn)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """1/8-resolution CNN encoder: (B, 3, H, W) -> (B, out_dim, H/8, W/8)."""

    def __init__(self, out_dim, norm_fn="instance"):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(3, DIM, 7, stride=2, padding=3)
        layers = []
        in_planes = DIM
        for dim, stride in ((DIM, 1), (2 * DIM, 2), (4 * DIM, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(in_planes, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(4 * DIM, out_dim, 1)

    def forward(self, x):
        x = F.relu(_norm(self.conv1(x), self.norm_fn))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class ConvGRU(nn.Module):
    def __init__(self, h_planes=128, i_planes=320):
        super().__init__()
        self.w = nn.Conv2d(h_planes, h_planes, 1)
        self.convz = nn.Conv2d(h_planes + i_planes, h_planes, 3, padding=1)
        self.convr = nn.Conv2d(h_planes + i_planes, h_planes, 3, padding=1)
        self.convq = nn.Conv2d(h_planes + i_planes, h_planes, 3, padding=1)
        self.convz_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convr_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convq_glo = nn.Conv2d(h_planes, h_planes, 1)

    def forward(self, net, inp):
        net_inp = torch.cat([net, inp], dim=1)
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    """Per-keyframe aggregation: BA damping (0.01 softplus) + upsample mask."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 128, 3, padding=1)
        self.eta = nn.Sequential(nn.Conv2d(128, 1, 3, padding=1))
        self.upmask = nn.Sequential(nn.Conv2d(128, 8 * 8 * 9, 1))

    def forward(self, net, kk, num_frames, with_upmask=True):
        """net (E,128,h,w); kk (E,) frame slot of each edge ->
        (eta (M,h,w), upmask (M,576,h,w) or None), M = num_frames."""
        E, c, h, w = net.shape
        x = F.relu(self.conv1(net))
        summed = torch.zeros((num_frames, c * h * w), dtype=torch.float32,
                             device=x.device)
        summed.index_add_(0, kk, x.reshape(E, -1).float())
        counts = torch.zeros(num_frames, dtype=torch.float32,
                             device=x.device)
        counts.index_add_(0, kk, torch.ones(E, device=x.device))
        mean = (summed / counts.clamp(min=1.0)[:, None]).to(x.dtype)
        y = F.relu(self.conv2(mean.reshape(num_frames, c, h, w)))
        eta = F.softplus(self.eta(y))[:, 0]
        upmask = self.upmask(y) if with_upmask else None
        return 0.01 * eta, upmask


class UpdateModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(CORR_PLANES, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.flow_encoder = nn.Sequential(
            nn.Conv2d(4, 128, 7, padding=3), nn.ReLU(),
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU())
        self.weight = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1), nn.Sigmoid())
        self.delta = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1))
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, kk=None, num_frames=0,
                with_upmask=True):
        """net/inp (E,128,h,w), corr (E,196,h,w), flow (E,4,h,w) ->
        (net, delta (E,2,h,w), weight (E,2,h,w)) and, when ``kk`` is
        given, (eta (M,h,w), upmask (M,576,h,w))."""
        if flow is None:
            flow = net.new_zeros((net.shape[0], 4) + net.shape[2:])
        corr = self.corr_encoder(corr)
        flow = self.flow_encoder(flow)
        net = self.gru(net, torch.cat([inp, corr, flow], dim=1))
        delta = self.delta(net)
        weight = self.weight(net)
        if kk is not None:
            eta, upmask = self.agg(net, kk, num_frames, with_upmask)
            return net, delta, weight, eta, upmask
        return net, delta, weight


class DroidNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(128, "instance")
        self.cnet = BasicEncoder(256, "none")
        self.update = UpdateModule()

    def features(self, images):
        return self.fnet(images)

    def context(self, images):
        """-> (net0 = tanh, inp = relu) halves of the context features."""
        net, inp = self.cnet(images).split(128, dim=1)
        return torch.tanh(net), F.relu(inp)
