"""Token transformer backbone (a frozen copy of the program's
``nn/transformer.py``), with the diffusers module names of the reference
``Transformer1D``.

- channels-first tokens (B, C, N): GroupNorm -> proj_in -> blocks ->
  proj_out -> + residual;
- each block: pre-LN self-attention, a second attention over ``context``
  (the avatar's backbones pass none, so it is self-attention there; the
  point-cloud generator's passes the image tokens, ``context_dim`` wide),
  and a GEGLU feed-forward with the exact (erf) gelu;
- with ``modulation_dim`` the blocks' three norms are
  ``AdaLayerNormContinuous``: a LayerNorm with no scale or bias, shifted
  and scaled by the condition vector;
- attention is plain matmul + softmax over the 2048 tokens.

``compute_dtype`` is the JAX package's flax ``dtype``. None computes in
float32. ``torch.bfloat16`` runs proj_in, the blocks' residual stream and
their layers, and proj_out in bf16 with float32 parameters; the GroupNorm
takes no compute dtype and the block LayerNorms keep float32 statistics.
The attention's scores are bf16 products; with ``softmax_fp32`` (the
default) the softmax and the product with V run in float32, else in bf16.
``attn_remat`` recomputes the attention core (scores, softmax, AV) in the
backward instead of keeping its probabilities (``torch.utils.checkpoint``,
the same function to the bit).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nn.mlp import LN_EPS, LayerNorm, Linear
from benchmark.reference.precision import lowp


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, compute_dtype=compute_dtype)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        # net.0 / net.2 as in diffusers (net.1 is an inference no-op dropout)
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, compute_dtype=dt),
                                  nn.Identity(),
                                  Linear(dim * mult, dim, compute_dtype=dt)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 softmax_fp32: bool = True, attn_remat: bool = False,
                 context_dim: Optional[int] = None):
        super().__init__()
        context_dim = context_dim or dim
        inner = heads * head_dim
        dt = compute_dtype
        self.heads = heads
        self.head_dim = head_dim
        self.compute_dtype = dt
        self.softmax_fp32 = softmax_fp32
        self.attn_remat = attn_remat
        self.to_q = Linear(dim, inner, bias=False, compute_dtype=dt)
        self.to_k = Linear(context_dim, inner, bias=False, compute_dtype=dt)
        self.to_v = Linear(context_dim, inner, bias=False, compute_dtype=dt)
        self.to_out = nn.ModuleList([Linear(inner, inner, compute_dtype=dt)])

    def core(self, q, k, v):
        """softmax(q k^T / sqrt(D)) v of (B, H, N, D) heads. In a compute
        dtype as flax's ``dot_product_attention(dtype=...)``: q divided by
        sqrt(D) in it, the scores its product (rounded to it), then the
        softmax and the product with V in float32 (``softmax_fp32``) or in
        the compute dtype."""
        if self.compute_dtype is None:
            att = torch.softmax(
                q @ k.transpose(-1, -2) / math.sqrt(self.head_dim), dim=-1)
            return att @ v
        scores = lowp(lowp(q / math.sqrt(self.head_dim))
                      @ lowp(k).transpose(-1, -2))
        p = torch.softmax(scores, dim=-1)
        if self.softmax_fp32:
            return p @ v.float()
        return lowp(lowp(p) @ lowp(v))

    def forward(self, x, context=None):
        """x (B, N, dim); context (B, M, context_dim), x itself if None."""
        b, n, _ = x.shape
        context = x if context is None else context

        def split(t):
            return t.reshape(b, t.shape[1], self.heads,
                             self.head_dim).transpose(1, 2)

        q = split(self.to_q(x))
        k, v = split(self.to_k(context)), split(self.to_v(context))
        o = self.core(q, k, v)
        o = o.transpose(1, 2).reshape(b, n, self.heads * self.head_dim)
        return self.to_out[0](o)


class AdaLayerNormContinuous(nn.Module):
    """A LayerNorm with no scale or bias (eps 1e-6), then
    h * (1 + scale) + shift with (scale, shift) from the condition:
    linear2(silu(linear1(cond)))."""

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.dim = dim
        self.linear1 = nn.Linear(cond_dim, cond_dim)
        self.linear2 = nn.Linear(cond_dim, dim * 2)

    def forward(self, x, cond):
        """x (B, N, dim), cond (B, cond_dim)."""
        emb = self.linear2(F.silu(self.linear1(cond)))
        scale, shift = emb.chunk(2, dim=-1)
        h = F.layer_norm(x, (self.dim,), eps=LN_EPS)
        return h * (1.0 + scale[..., None, :]) + shift[..., None, :]


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 softmax_fp32: bool = True, attn_remat: bool = False,
                 context_dim: Optional[int] = None,
                 modulation_dim: Optional[int] = None):
        super().__init__()
        dt = compute_dtype
        attn = dict(compute_dtype=dt, softmax_fp32=softmax_fp32,
                    attn_remat=attn_remat)

        def norm():
            if modulation_dim is not None:
                return AdaLayerNormContinuous(dim, modulation_dim)
            return LayerNorm(dim, compute_dtype=dt)

        self.norm1 = norm()
        self.attn1 = Attention(dim, heads, head_dim, **attn)
        self.norm2 = norm()
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim,
                               **attn)
        self.norm3 = norm()
        self.ff = FeedForward(dim, compute_dtype=dt)
        self.modulated = modulation_dim is not None

    def forward(self, x, cond=None, context=None):
        """cond (B, modulation_dim) where the norms are modulated."""
        c = (cond,) if self.modulated else ()
        x = x + self.attn1(self.norm1(x, *c))
        x = x + self.attn2(self.norm2(x, *c), context)
        return x + self.ff(self.norm3(x, *c))


class Transformer1D(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 10, heads: int = 8,
                 head_dim: int = 64, norm_groups: int = 32,
                 compute_dtype: Optional[torch.dtype] = None,
                 softmax_fp32: bool = True, attn_remat: bool = False,
                 context_dim: Optional[int] = None,
                 modulation_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        dt = compute_dtype
        self.norm = nn.GroupNorm(norm_groups, in_channels, eps=LN_EPS)
        self.proj_in = Linear(in_channels, inner, compute_dtype=dt)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, heads, head_dim, compute_dtype=dt,
                              softmax_fp32=softmax_fp32,
                              attn_remat=attn_remat, context_dim=context_dim,
                              modulation_dim=modulation_dim)
             for _ in range(num_layers)])
        self.proj_out = Linear(inner, in_channels, compute_dtype=dt)

    def forward(self, tokens: torch.Tensor, modulation_cond=None,
                context=None) -> torch.Tensor:
        """tokens (B, C, N) channels-first; modulation_cond (B, Cm) for
        modulated norms; context (B, M, context_dim) for the second
        attention of each block."""
        h = self.proj_in(self.norm(tokens).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h, modulation_cond, context)
        return self.proj_out(h).transpose(1, 2).float() + tokens
