"""The snowflake point upsampler (counterpart of ``nn/snowflake.py``):
``SkipTransformer`` (kNN-16 vector attention with a relative-position MLP),
the point-splitting stages ``SPDpp`` (the flagship's), ``SPD`` and
``SPDCrossAttn``, the ``SnowflakeDecoder`` that chains them, and
PointNet++'s kNN set abstraction and feature propagation.

The parameters carry the reference checkpoint's names and shapes: kernel-1
``Conv1d``/``Conv2d`` weights (out, in, 1[, 1]) applied point-major,
``MLP_CONV``'s ``mlp.{0,2}``, BatchNorm with its running statistics, the
point split's ``ConvTranspose1d`` weight (in, out, up). Every module takes
one sample, points first: (N, C). The BatchNorm is evaluated as the JAX
package evaluates it, (x - mean) * rsqrt(var + eps) * scale + bias, and the
neighbours come from the port's ``ops/knn.knn`` (ties by index).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from guassianhand_tpu_torch.nn.mlp import LN_EPS
from guassianhand_tpu_torch.ops.fps import fps_subsample
from guassianhand_tpu_torch.ops.knn import knn


class PointConv(nn.Conv1d):
    """A kernel-1 ``Conv1d`` applied to points-first features:
    (..., in) -> (..., out)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, 1, bias=bias)

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1), self.bias)


class PointConv2d(nn.Conv2d):
    """A kernel-1 ``Conv2d`` applied to points-first features."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1), self.bias)


class FrozenBatchNorm(nn.BatchNorm1d):
    """BatchNorm in inference mode with its running statistics, over the
    last axis."""

    def forward(self, x):
        return ((x - self.running_mean) * torch.rsqrt(self.running_var
                                                      + self.eps)
                * self.weight + self.bias)


class MLPConv(nn.Module):
    """The reference's ``MLP_CONV``: kernel-1 convolutions at ``mlp.{0, 2,
    ...}`` with a ReLU between them (none after the last)."""

    def __init__(self, cin: int, channels: Sequence[int]):
        super().__init__()
        layers = []
        for i, c in enumerate(channels):
            if i:
                layers.append(nn.ReLU())
            layers.append(PointConv(cin, c))
            cin = c
        self.mlp = nn.Sequential(*layers)

    def forward(self, x):
        return self.mlp(x)


class MLPRes(nn.Module):
    """conv_2(relu(conv_1(x))) + conv_shortcut(x)."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.conv_1 = PointConv(cin, hidden)
        self.conv_2 = PointConv(hidden, out)
        self.conv_shortcut = PointConv(cin, out)

    def forward(self, x):
        return self.conv_2(F.relu(self.conv_1(x))) + self.conv_shortcut(x)


class ConvBNConv(nn.Sequential):
    """Conv2d(k=1), BatchNorm, ReLU, Conv2d(k=1) at indices 0, 1, 2, 3."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__(PointConv2d(cin, hidden), FrozenBatchNorm(hidden),
                         nn.ReLU(), PointConv2d(hidden, out))


class SkipTransformer(nn.Module):
    """kNN local vector attention. pos (N, 3), key and query (N, C) ->
    (N, C)."""

    def __init__(self, in_channel: int = 128, dim: int = 64, n_knn: int = 16,
                 pos_hidden: int = 64, attn_hidden_multiplier: int = 4):
        super().__init__()
        self.n_knn = n_knn
        self.mlp_v = MLPRes(in_channel * 2, in_channel, in_channel)
        self.conv_key = PointConv(in_channel, dim)
        self.conv_query = PointConv(in_channel, dim)
        self.conv_value = PointConv(in_channel, dim)
        self.pos_mlp = ConvBNConv(3, pos_hidden, dim)
        self.attn_mlp = ConvBNConv(dim, dim * attn_hidden_multiplier, dim)
        self.conv_end = PointConv(dim, in_channel)

    def forward(self, pos, key, query):
        value = self.mlp_v(torch.cat([key, query], dim=-1))
        k = self.conv_key(key)
        q = self.conv_query(query)
        v = self.conv_value(value)
        _, idx = knn(pos, pos, self.n_knn)            # (N, K), self first
        qk_rel = q[:, None, :] - k[idx]
        pos_emb = self.pos_mlp(pos[:, None, :] - pos[idx])
        attn = torch.softmax(self.attn_mlp(qk_rel + pos_emb), dim=1)
        agg = torch.sum(attn * (v[:, None, :] + pos_emb), dim=1)
        return self.conv_end(agg) + value


class PointSplit(nn.ConvTranspose1d):
    """ConvTranspose1d(in, out, k=up, stride=up, no bias) on points-first
    features: each point emits ``up`` children, child j = x @ W[:, :, j]."""

    def __init__(self, cin: int, cout: int, up_factor: int):
        super().__init__(cin, cout, up_factor, stride=up_factor, bias=False)

    def forward(self, x):
        y = torch.einsum("ni,iok->nko", x, self.weight)
        return y.reshape(x.shape[0] * self.weight.shape[2], -1)


class _SPDBase(nn.Module):
    """The stages' shared tail: skip transformer, point split, displacement."""

    def __init__(self, up_factor: int, i: int, radius: float, bounding: bool,
                 ps_dim: int = 32):
        super().__init__()
        self.up_factor, self.i = up_factor, i
        self.radius, self.bounding = radius, bounding
        self.skip_transformer = SkipTransformer(in_channel=128, dim=64)
        self.mlp_ps = MLPConv(128, [64, ps_dim])
        self.ps = PointSplit(ps_dim, 128, up_factor)
        self.mlp_delta_feature = MLPRes(256, 128, 128)
        self.mlp_delta = MLPConv(128, [64, 3])

    def split(self, points, q, k_prev):
        h = self.skip_transformer(points, q if k_prev is None else k_prev, q)
        feat_child = self.ps(self.mlp_ps(h))                   # (N*up, 128)
        h_up = torch.repeat_interleave(h, self.up_factor, dim=0)
        k_curr = self.mlp_delta_feature(torch.cat([feat_child, h_up], dim=-1))
        delta = self.mlp_delta(F.relu(k_curr))
        if self.bounding:
            delta = torch.tanh(delta) / (self.radius ** self.i)
        return (torch.repeat_interleave(points, self.up_factor, dim=0) + delta,
                k_curr)


class SPDpp(_SPDBase):
    """SPD_pp: N -> N * up_factor. points (N, 3); feat_cond (N, dim_feat)
    per-point condition; k_prev (N, 128), the previous stage's displacement
    feature, or None. Returns (points (N * up, 3), k_curr)."""

    def __init__(self, dim_feat: int = 128, up_factor: int = 2, i: int = 0,
                 radius: float = 1.0, bounding: bool = True,
                 global_feat: bool = True):
        super().__init__(up_factor, i, radius, bounding,
                         ps_dim=32 if global_feat else 64)
        self.global_feat = global_feat
        self.mlp_1 = MLPConv(3, [64, 128])
        self.mlp_2 = MLPConv(256 + dim_feat if global_feat else 128,
                             [256, 128])

    def forward(self, points, feat_cond=None, k_prev=None):
        feat_1 = self.mlp_1(points)
        if self.global_feat:
            gmax = feat_1.max(dim=0, keepdim=True).values.expand_as(feat_1)
            feat_1 = torch.cat([feat_1, gmax, feat_cond], dim=-1)
        return self.split(points, self.mlp_2(feat_1), k_prev)


class SPD(_SPDBase):
    """SPD: like SPDpp, conditioned on one global feature vector
    (dim_feat,) instead of per-point features."""

    def __init__(self, dim_feat: int = 512, up_factor: int = 2, i: int = 0,
                 radius: float = 1.0, bounding: bool = True):
        super().__init__(up_factor, i, radius, bounding)
        self.mlp_1 = MLPConv(3, [64, 128])
        self.mlp_2 = MLPConv(256 + dim_feat, [256, 128])

    def forward(self, points, feat_global, k_prev=None):
        feat_1 = self.mlp_1(points)
        gmax = feat_1.max(dim=0, keepdim=True).values.expand_as(feat_1)
        gcond = feat_global[None, :].expand(points.shape[0], -1)
        feat_1 = torch.cat([feat_1, gmax, gcond], dim=-1)
        return self.split(points, self.mlp_2(feat_1), k_prev)


class ResidualCrossAttn(nn.Module):
    """Pre-norm residual cross-attention from points to condition tokens,
    then a GELU (erf) feed-forward."""

    def __init__(self, dim: int = 128, heads: int = 4,
                 cond_dim: Optional[int] = None):
        super().__init__()
        cond_dim = cond_dim or dim
        self.dim, self.heads = dim, heads
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(cond_dim, dim)
        self.to_v = nn.Linear(cond_dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff1 = nn.Linear(dim, dim * 4)
        self.ff2 = nn.Linear(dim * 4, dim)

    def forward(self, x, cond):
        hd = self.dim // self.heads
        h = self.norm(x)
        q = self.to_q(h).reshape(-1, self.heads, hd)
        k = self.to_k(cond).reshape(-1, self.heads, hd)
        v = self.to_v(cond).reshape(-1, self.heads, hd)
        a = torch.softmax(torch.einsum("qhd,khd->hqk", q, k) / (hd ** 0.5),
                          dim=-1)
        o = torch.einsum("hqk,khd->qhd", a, v).reshape(-1, self.dim)
        x = x + self.to_out(o)
        ff = self.ff1(self.norm2(x))
        return x + self.ff2(F.gelu(ff, approximate="none"))


class SPDCrossAttn(_SPDBase):
    """SPD_crossattn: the condition enters through a cross-attention block
    over the condition tokens (M, dim_feat) instead of a concatenation."""

    def __init__(self, dim_feat: int = 128, up_factor: int = 2, i: int = 0,
                 radius: float = 1.0, bounding: bool = True):
        super().__init__(up_factor, i, radius, bounding)
        self.mlp_1 = MLPConv(3, [64, 128])
        self.cross_attn = ResidualCrossAttn(128, cond_dim=dim_feat)
        self.mlp_2 = MLPConv(128, [256, 128])

    def forward(self, points, cond_tokens, k_prev=None):
        feat_1 = self.cross_attn(self.mlp_1(points), cond_tokens)
        return self.split(points, self.mlp_2(feat_1), k_prev)


class SnowflakeDecoder(nn.Module):
    """``mlp_feat_cond`` compresses the condition rows, then one stage a
    factor of ``up_factors`` upsamples. points (N, 3); feat_cond
    (M, input_channels). Returns (points, [points at every level])."""

    def __init__(self, up_factors: Sequence[int] = (2, 4),
                 input_channels: int = 512, dim_feat: int = 128,
                 radius: float = 1.0, bounding: bool = True,
                 spd_type: str = "SPD_PP"):
        super().__init__()
        self.spd_type = spd_type
        self.mlp_feat_cond = MLPConv(input_channels, [dim_feat * 2, dim_feat])
        stage = {"SPD_PP": SPDpp, "SPD_crossattn": SPDCrossAttn}.get(
            spd_type, SPD)
        self.uppers = nn.ModuleList(
            stage(dim_feat=dim_feat, up_factor=f, i=i, radius=radius,
                  bounding=bounding) for i, f in enumerate(up_factors))

    def forward(self, points, feat_cond):
        cond = self.mlp_feat_cond(feat_cond)
        k_prev = None
        levels = [points]
        for upper in self.uppers:
            if self.spd_type == "SPD_PP":
                # the condition rows resampled to the point count by nearest
                # index
                n, m = points.shape[0], cond.shape[0]
                cond_i = cond if m == n else cond[
                    torch.arange(n, device=cond.device) * m // n]
                points, k_prev = upper(points, cond_i, k_prev)
            elif self.spd_type == "SPD_crossattn":
                points, k_prev = upper(points, cond, k_prev)
            else:
                points, k_prev = upper(points, cond.mean(dim=0), k_prev)
            levels.append(points)
        return points, levels


def _conv_bn_relu(cin: int, channels: Sequence[int], module: nn.Module,
                  last_bare: bool) -> None:
    """conv{i} (kernel-1 Conv2d) and bn{i} on ``module``, the last layer
    without a norm where ``last_bare``."""
    for i, out in enumerate(channels):
        setattr(module, f"conv{i}", PointConv2d(cin, out))
        if not (last_bare and i == len(channels) - 1):
            setattr(module, f"bn{i}", FrozenBatchNorm(out))
        cin = out


class PointNetSAModuleKNN(nn.Module):
    """PointNet++ set abstraction with kNN groups. xyz (N, 3), feats
    (N, in_channel) or None -> (new_xyz (npoint, 3), (npoint, mlp[-1])):
    FPS centres, each centre's nsample nearest points (itself included)
    re-centred on it, kernel-1 conv + BatchNorm + ReLU with the last conv
    bare, max over the group. ``group_all``: one group of every point,
    centred at the origin."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 mlp: Sequence[int], group_all: bool = False,
                 use_xyz: bool = True):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        self.group_all, self.use_xyz = group_all, use_xyz
        self.n_layers = len(mlp)
        cin = 3 if not in_channel else in_channel + 3 * use_xyz
        _conv_bn_relu(cin, mlp, self, last_bare=True)

    def forward(self, xyz, feats=None):
        if self.group_all:
            new_xyz = torch.zeros((1, 3), dtype=xyz.dtype, device=xyz.device)
            grouped_xyz, grouped_feats = xyz[None], (
                None if feats is None else feats[None])
        else:
            new_xyz = fps_subsample(xyz, self.npoint)
            _, idx = knn(new_xyz, xyz, self.nsample)
            grouped_xyz = xyz[idx] - new_xyz[:, None, :]
            grouped_feats = None if feats is None else feats[idx]
        x = grouped_xyz
        if grouped_feats is not None:
            x = (torch.cat([grouped_xyz, grouped_feats], dim=-1)
                 if self.use_xyz else grouped_feats)
        for i in range(self.n_layers - 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = getattr(self, f"conv{self.n_layers - 1}")(x)
        return new_xyz, x.max(dim=1).values


class PointNetFPModule(nn.Module):
    """PointNet++ feature propagation: the coarse features feats2 at xyz2
    (M, C2) interpolated onto xyz1 (N, 3) by inverse-distance weights over
    the 3 nearest (distances clamped at 1e-10), the skip features feats1
    concatenated where ``use_points1``, then kernel-1 conv + BatchNorm +
    ReLU layers."""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 use_points1: bool = False):
        super().__init__()
        self.use_points1 = use_points1
        self.n_layers = len(mlp)
        _conv_bn_relu(in_channel, mlp, self, last_bare=False)

    def forward(self, xyz1, xyz2, feats1, feats2):
        d2, idx = knn(xyz1, xyz2, 3)
        recip = 1.0 / torch.clamp(torch.sqrt(d2), min=1e-10)
        w = recip / torch.sum(recip, dim=1, keepdim=True)
        x = torch.sum(feats2[idx] * w[..., None], dim=1)
        if self.use_points1:
            x = torch.cat([x, feats1], dim=-1)
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x
