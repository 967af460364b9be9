"""Neural-point feature decoders (Point-SLAM style) as ``nn.Module``s.

Counterpart of ``glorie_slam_tpu/mapping/decoders.py`` (reference
src/modules/conv_onet/models/decoder.py:8-501):

- ``GaussianFourier``: Fourier positional embedding; its ``B`` is a
  parameter where the reference trains it (geometry, relative position) and
  a buffer where it is fixed (colour, view direction), so a fixed ``B`` is
  carried with the weights but never reaches the optimiser;
- ``MLPGeometry``: hidden 32, 5 blocks, skip at 2, occupancy head;
- ``MLPColNeighbor`` (F_theta) and ``MLPColor``: hidden 128, Softplus
  (beta 100), relative-position-encoded neighbour features, Fourier view
  direction, sigmoid RGB head;
- ``PointDecoders``: both over a kNN computed once by the caller.

Module and parameter names follow the JAX package's flax tree
(``geo_decoder.pts_linears_0.weight`` for ``params["geo_decoder"]
["pts_linears_0"]["kernel"]``, transposed), so
``nets/import_flax.decoder_params_to_state_dict`` carries its weights
across. Random weights come from an explicit
``torch.Generator``: Linear weights N(0, 1/fan_in) (flax's lecun normal
without the truncation), zero biases, ``B`` scale * N(0, 1).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

SOFTPLUS_BETA = 100.0


def softplus100(x):
    """torch.nn.Softplus(beta=100) (decoder.py:124), as the JAX package
    writes it: softplus(100 x) / 100."""
    return F.softplus(SOFTPLUS_BETA * x) / SOFTPLUS_BETA


class GaussianFourier(nn.Module):
    """decoder.py:8-37: sin (and cos with ``concat``) of 2 pi x B."""

    def __init__(self, in_dim, mapping_size, scale, learnable=False,
                 concat=True):
        super().__init__()
        self.scale = scale
        self.concat = concat
        B = torch.zeros(in_dim, mapping_size)
        if learnable:
            self.B = nn.Parameter(B)
        else:
            self.register_buffer("B", B)

    @property
    def out_dim(self):
        return self.B.shape[1] * (2 if self.concat else 1)

    def forward(self, x):
        proj = (2 * math.pi * x) @ self.B
        if self.concat:
            return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        return torch.sin(proj)


def neighbor_weights(D, radius_sq, weighting):
    """Normalised interpolation weights (N, k): inverse distance (or
    exp(-20 d)), zero past the radius."""
    if weighting == "distance":
        w = 1.0 / (D + 1e-10)
    else:
        w = torch.exp(-20.0 * torch.sqrt(D.clamp(min=0.0)))
    w = torch.where(D > radius_sq, torch.zeros_like(w), w)
    return w / w.sum(dim=1, keepdim=True).clamp(min=1e-10)


def _masked(c, has, rand_feat):
    fill = torch.zeros_like(c) if rand_feat is None else rand_feat
    return torch.where(has[:, None], c, fill)


def interpolate_features(D, I, neighbor_num, feats, radius_sq, min_nn_num,
                         weighting="distance", rand_feat=None):
    """Distance-weighted kNN interpolation of ``feats`` (P_cap, c) at the
    queries of D/I (N, k) (decoder.py:130-173) -> (c (N, c),
    has_neighbors (N,))."""
    w = neighbor_weights(D, radius_sq, weighting)
    c = torch.sum(w[..., None] * feats[I], dim=1)
    has = neighbor_num > (min_nn_num - 1)
    return _masked(c, has, rand_feat), has


def _linears(module, prefix, dims_in, dim_out):
    for i, d in enumerate(dims_in):
        setattr(module, f"{prefix}_{i}", nn.Linear(d, dim_out))


class MLPGeometry(nn.Module):
    """decoder.py:62-225: ReLU trunk over the Fourier embedding of the
    sample, plus the interpolated feature at every block, skip at 2."""

    def __init__(self, c_dim=32, hidden=32, n_blocks=5, skips=(2,)):
        super().__init__()
        self.n_blocks, self.skips = n_blocks, tuple(skips)
        self.embedder = GaussianFourier(3, 93, 25.0, learnable=True,
                                        concat=False)
        e = self.embedder.out_dim
        dims = [e] + [hidden + (e if i - 1 in self.skips else 0)
                      for i in range(1, n_blocks)]
        _linears(self, "pts_linears", dims, hidden)
        _linears(self, "fc_c", [c_dim] * n_blocks, hidden)
        self.output_linear = nn.Linear(hidden, 1)

    def forward(self, p, c):
        """p (N, 3), c (N, c_dim) -> occupancy logits (N,)."""
        emb = self.embedder(p)
        h = emb
        for i in range(self.n_blocks):
            h = torch.relu(getattr(self, f"pts_linears_{i}")(h))
            h = h + getattr(self, f"fc_c_{i}")(c)
            if i in self.skips:
                h = torch.cat([emb, h], dim=-1)
        return self.output_linear(h)[..., 0]


class MLPColNeighbor(nn.Module):
    """F_theta (decoder.py:228-243)."""

    def __init__(self, in_dim, c_dim=32, hidden=128):
        super().__init__()
        self.linear1 = nn.Linear(in_dim, hidden)
        self.linear2 = nn.Linear(hidden, c_dim)

    def forward(self, x):
        return self.linear2(softplus100(self.linear1(x)))


class MLPColor(nn.Module):
    """decoder.py:264-433: Softplus trunk over the Fourier embeddings of
    the sample (and view direction), sigmoid RGB."""

    def __init__(self, c_dim=32, hidden=128, n_blocks=5, skips=(2,),
                 use_view_direction=True, encode_viewd=True,
                 encode_rel_pos=True):
        super().__init__()
        self.n_blocks, self.skips = n_blocks, tuple(skips)
        self.use_view_direction = use_view_direction
        self.encode_viewd = encode_viewd
        self.encode_rel_pos = encode_rel_pos
        self.embedder = GaussianFourier(3, 20, 32.0)
        e = self.embedder.out_dim
        if use_view_direction:
            if encode_viewd:
                self.embedder_view = GaussianFourier(3, 20, 32.0)
                e += self.embedder_view.out_dim
            else:
                e += 3
        if encode_rel_pos:
            self.embedder_rel_pos = GaussianFourier(3, 10, 32.0,
                                                    learnable=True)
            self.mlp_col_neighbor = MLPColNeighbor(
                self.embedder_rel_pos.out_dim + c_dim, c_dim, hidden)
        dims = [e] + [hidden + (e if i - 1 in self.skips else 0)
                      for i in range(1, n_blocks)]
        _linears(self, "fc_c", [c_dim] * n_blocks, hidden)
        _linears(self, "pts_linears", dims, hidden)
        self.output_linear = nn.Linear(hidden, 3)

    def neighbor_features(self, D, I, neighbor_num, col_feats, cloud_pos, p,
                          radius_sq, min_nn_num, weighting="distance",
                          rand_feat=None):
        """Relative-position-encoded interpolation (decoder.py:340-389)."""
        feats = col_feats[I]
        if self.encode_rel_pos:
            rel = cloud_pos[I] - p[:, None, :]                 # (N, k, 3)
            feats = self.mlp_col_neighbor(torch.cat(
                [self.embedder_rel_pos(rel), feats], dim=-1))
        w = neighbor_weights(D, radius_sq, weighting)
        c = torch.sum(w[..., None] * feats, dim=1)
        return _masked(c, neighbor_num > (min_nn_num - 1), rand_feat)

    def forward(self, p, c, views_d=None):
        emb = self.embedder(p)
        if self.use_view_direction and views_d is not None:
            views_d = views_d / torch.linalg.norm(
                views_d, dim=-1, keepdim=True).clamp(min=1e-8)
            emb_v = (self.embedder_view(views_d) if self.encode_viewd
                     else views_d)
            emb = torch.cat([emb, emb_v], dim=-1)
        h = emb
        for i in range(self.n_blocks):
            h = softplus100(getattr(self, f"pts_linears_{i}")(h))
            h = h + getattr(self, f"fc_c_{i}")(c)
            if i in self.skips:
                h = torch.cat([emb, h], dim=-1)
        return torch.sigmoid(self.output_linear(h))


class PointDecoders(nn.Module):
    """POINT wrapper (decoder.py:436-501): the geometry and colour decoders
    over one precomputed kNN."""

    def __init__(self, c_dim=32, hidden_color=128, use_view_direction=True,
                 encode_viewd=True, encode_rel_pos=True,
                 weighting="distance", min_nn_num=2, seed=None):
        super().__init__()
        self.weighting = weighting
        self.min_nn_num = min_nn_num
        self.geo_decoder = MLPGeometry(c_dim, 32)
        self.color_decoder = MLPColor(
            c_dim, hidden_color, use_view_direction=use_view_direction,
            encode_viewd=encode_viewd, encode_rel_pos=encode_rel_pos)
        if seed is not None:
            random_init(self, torch.Generator().manual_seed(seed))

    @classmethod
    def from_cfg(cls, cfg, seed=None):
        m, pc = cfg["model"], cfg["pointcloud"]
        return cls(c_dim=m["c_dim"],
                   use_view_direction=m["use_view_direction"],
                   encode_viewd=m["encode_viewd"],
                   encode_rel_pos=m["encode_rel_pos_in_col"],
                   weighting=pc["nn_weighting"], min_nn_num=pc["min_nn_num"],
                   seed=seed)

    def forward(self, p, D, I, neighbor_num, geo_feats, col_feats, cloud_pos,
                radius_sq, views_d=None, stage="color", rand_geo=None,
                rand_col=None):
        """-> (raw (N, 4) [rgb, occupancy], has_neighbors (N,))."""
        c_geo, has = interpolate_features(
            D, I, neighbor_num, geo_feats, radius_sq, self.min_nn_num,
            self.weighting, rand_geo)
        occ = self.geo_decoder(p, c_geo)
        if stage == "geometry":
            rgb = torch.zeros(p.shape[:-1] + (3,), dtype=occ.dtype,
                              device=occ.device)
        else:
            c_col = self.color_decoder.neighbor_features(
                D, I, neighbor_num, col_feats, cloud_pos, p, radius_sq,
                self.min_nn_num, self.weighting, rand_col)
            rgb = self.color_decoder(p, c_col, views_d)
        return torch.cat([rgb, occ[..., None]], dim=-1), has


def random_init(module, gen):
    """Seeded weights for every Linear and Fourier ``B`` of ``module``,
    drawn on the CPU in module order."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 / math.sqrt(fan_in))
                mod.bias.zero_()
            elif isinstance(mod, GaussianFourier):
                mod.B.copy_(mod.scale * torch.randn(mod.B.shape,
                                                    generator=gen))

