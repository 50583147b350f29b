"""Per-Gaussian decode heads and the interaction attention (a frozen copy
of the program's ``nn/heads.py``), under the reference's module names.

- ``GSLayer``: linear heads ``out_layers.{0..4}`` for xyz, scaling,
  rotation, opacity and shs, with the reference activations and init (zero
  weights; scaling bias -5 -> trunc_exp; rotation bias (1, 0, 0, 0) ->
  normalize; opacity bias inverse_sigmoid(0.1) -> sigmoid; xyz a
  sigmoid-bounded offset of +-1.2/32*0.5; rgb sigmoid with ``use_rgb``).
- ``VertValid`` / ``VertPosRefinement``: ``ff`` (MLPBlock) and ``fc``.
- ``AdditionalFeaturesFC``: ``ff1`` (MLPBlock).
- ``IdentityCodeInfer``: a 33-d identity code in (-1, 1) from point tokens,
  ``fc`` -> ``layer_norm`` -> flatten -> ``fc_out`` -> sigmoid * 2 - 1.
- ``SelfAttn``: exact masked attention over the interacting points, 4
  heads of f // 4; rows outside the mask pass through unchanged. With
  ``cap`` only the first max(128, cap) interacting rows attend (among
  themselves) and the rest pass through too; their count is the overflow.

``compute_dtype`` on ``AdditionalFeaturesFC`` and ``SelfAttn`` is the JAX
package's flax ``dtype``: their Dense layers (q, k, v, the output
projection and the MLPResBlock) compute in it with float32 parameters; the
LayerNorm before them takes none, and the attention keeps float32
statistics (``ops/blockwise_attention.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from benchmark.reference.core.gaussians import Gaussians
from benchmark.reference.nn.mlp import LN_EPS, Linear, MLPBlock, MLPResBlock
from benchmark.reference.ops.blockwise_attention import blockwise_attention


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1.0 - x))


def trunc_exp(x: torch.Tensor, cap: float = 15.0) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -cap, cap))


class GSLayer(nn.Module):
    def __init__(self, in_channels: int, sh_degree: int = 3,
                 use_rgb: bool = True, init_scaling: float = -5.0,
                 init_density: float = 0.1):
        super().__init__()
        self.use_rgb = use_rgb
        self.sh_k = 1 if use_rgb else (sh_degree + 1) ** 2
        self.init_scaling = init_scaling
        self.init_density = init_density
        self.out_layers = nn.ModuleList([
            nn.Linear(in_channels, 3), nn.Linear(in_channels, 3),
            nn.Linear(in_channels, 4), nn.Linear(in_channels, 1),
            nn.Linear(in_channels, 3 * self.sh_k)])

    def reset_parameters(self) -> None:
        """The reference init of every head but the rgb one, which keeps
        the default init."""
        xyz, scaling, rotation, opacity, shs = self.out_layers
        biases = [torch.zeros(3), torch.full((3,), self.init_scaling),
                  torch.tensor([1.0, 0.0, 0.0, 0.0]),
                  torch.full((1,), inverse_sigmoid(self.init_density))]
        heads = [xyz, scaling, rotation, opacity]
        if not self.use_rgb:
            heads.append(shs)
            biases.append(torch.zeros(3 * self.sh_k))
        with torch.no_grad():
            for head, bias in zip(heads, biases):
                head.weight.zero_()
                head.bias.copy_(bias)

    def forward(self, x: torch.Tensor, pts: torch.Tensor) -> Gaussians:
        """x (N, C) features, pts (N, 3) query points."""
        xyz_l, scaling_l, rotation_l, opacity_l, shs_l = self.out_layers
        max_step = 1.2 / 32.0
        xyz = (torch.sigmoid(xyz_l(x)) - 0.5) * max_step + pts
        scaling = trunc_exp(scaling_l(x))
        rotation = rotation_l(x)
        rotation = rotation / torch.clamp(
            torch.linalg.norm(rotation, dim=-1, keepdim=True), min=1e-12)
        opacity = torch.sigmoid(opacity_l(x))
        shs = shs_l(x)
        if self.use_rgb:
            shs = torch.sigmoid(shs)
        shs = shs.reshape(x.shape[0], self.sh_k, 3)
        return Gaussians(xyz=xyz, opacity=opacity, rotation=rotation,
                         scaling=scaling, shs=shs)


class VertValid(nn.Module):
    """Per-point validity score in (0, 1)."""

    def __init__(self, dim_in: int):
        super().__init__()
        self.ff = MLPBlock(dim_in, dim_in // 4)
        self.fc = nn.Linear(dim_in // 4, 1)

    def forward(self, feats, pts):
        return torch.sigmoid(self.fc(self.ff(torch.cat([feats, pts], -1))))


class VertPosRefinement(nn.Module):
    """Bounded position refinement, tanh * radius around the detached
    input point."""

    def __init__(self, dim_in: int, radius: float = 0.001):
        super().__init__()
        self.radius = radius
        self.ff = MLPBlock(dim_in, dim_in // 4)
        self.fc = nn.Linear(dim_in // 4, 3)

    def forward(self, feats, pts):
        h = self.ff(torch.cat([feats, pts], -1))
        return pts.detach() + torch.tanh(self.fc(h)) * self.radius


class AdditionalFeaturesFC(nn.Module):
    def __init__(self, dim_in: int, out_dim: int = 51,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ff1 = MLPBlock(dim_in, out_dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.ff1(x)


class IdentityCodeInfer(nn.Module):
    """The identity-code inference head: (B, n_token, dim_in) tokens ->
    (B, code_dim) in (-1, 1). Float32, as the JAX head (no compute
    dtype). Built with zero weights, so that it infers the code 0 until it
    is seeded (``init_default_``), loaded or trained: a model whose JAX
    tree has no head is then the same model wherever it is loaded."""

    def __init__(self, dim_in: int, code_dim: int = 33, n_token: int = 256):
        super().__init__()
        self.n_token = n_token
        self.fc = nn.Linear(dim_in, code_dim)
        self.layer_norm = nn.LayerNorm(code_dim, eps=LN_EPS)
        self.fc_out = nn.Linear(n_token * code_dim, code_dim)
        for lin in (self.fc, self.fc_out):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, n, _ = tokens.shape
        if n != self.n_token:
            raise ValueError(f"{n} tokens, the head takes {self.n_token}")
        h = self.layer_norm(self.fc(tokens))
        return torch.sigmoid(self.fc_out(h.reshape(b, -1))) * 2.0 - 1.0


class SelfAttn(nn.Module):
    """Interaction self-attention (eval mode: no dropout). ``cap``: the
    static budget of interacting rows (``OneShotConfig.interaction_cap``),
    None for all of them."""

    def __init__(self, dim: int = 131, n_heads: int = 4,
                 cap: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = dim // n_heads
        dt = compute_dtype
        self.n_heads = n_heads
        self.d = d
        self.cap = cap
        self.layer_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.w_qs = Linear(dim, n_heads * d, compute_dtype=dt)
        self.w_ks = Linear(dim, n_heads * d, compute_dtype=dt)
        self.w_vs = Linear(dim, n_heads * d, compute_dtype=dt)
        self.fc = Linear(n_heads * d, dim, compute_dtype=dt)
        self.ff = MLPResBlock(dim, dim, compute_dtype=dt)

    def _capped(self, q, k, v, mask):
        """The first max(128, cap) interacting rows of each sample, in their
        order, attend among themselves; returns (o, the kept mask,
        overflow: the interacting rows past the budget)."""
        b, n = mask.shape
        c = max(128, self.cap)
        # interacting rows first, order kept (a stable sort)
        idx = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :c]
        rows = torch.arange(b, device=mask.device)[:, None]
        ms = mask[rows, idx]
        os_ = torch.stack([blockwise_attention(q[i, idx[i]], k[i, idx[i]],
                                               v[i, idx[i]], ms[i])
                           for i in range(b)])
        o = q.new_zeros(q.shape, dtype=os_.dtype).index_put((rows, idx), os_)
        kept = torch.zeros_like(mask).index_put((rows, idx), ms)
        overflow = (mask.sum() - kept.sum()).to(torch.float32)
        return o, kept, overflow

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_overflow: bool = False):
        """x (B, N, F); mask optional (B, N) bool (True = interacting).
        With ``return_overflow`` also the count of interacting rows that
        the cap left out (0 without a cap)."""
        b, n, f = x.shape
        h = self.layer_norm(x)
        shape = (b, n, self.n_heads, self.d)
        q = self.w_qs(h).reshape(shape)
        k = self.w_ks(h).reshape(shape)
        v = self.w_vs(h).reshape(shape)
        overflow = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cap is not None and mask is not None and self.cap < n:
            o, mask, overflow = self._capped(q, k, v, mask)
        else:
            o = torch.stack([
                blockwise_attention(q[i], k[i], v[i],
                                    None if mask is None else mask[i],
                                    lowp=self.w_qs.compute_dtype is not None)
                for i in range(b)])
        y = self.ff(x + self.fc(o.reshape(b, n, self.n_heads * self.d)))
        if mask is not None:
            y = torch.where(mask[..., None], y, x)
        return (y, overflow) if return_overflow else y
