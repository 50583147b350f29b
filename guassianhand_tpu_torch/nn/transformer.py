"""Token transformer backbone (counterpart of ``nn/transformer.py``), with
the diffusers module names of the reference ``Transformer1D``.

- channels-first tokens (B, C, N): GroupNorm -> proj_in -> blocks ->
  proj_out -> + residual;
- each block: pre-LN self-attention, a second attention that is called
  with no context and so is self-attention too, and a GEGLU feed-forward
  with the exact (erf) gelu;
- attention is plain matmul + softmax over the 2048 triplane tokens.

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
import torch.utils.checkpoint

from guassianhand_tpu_torch.nn.mlp import LN_EPS, LayerNorm, Linear


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
                 softmax_fp32: bool = True, attn_remat: bool = False):
        super().__init__()
        inner = heads * head_dim
        dt = compute_dtype
        self.heads = heads
        self.head_dim = head_dim
        self.compute_dtype = dt
        self.softmax_fp32 = softmax_fp32
        self.attn_remat = attn_remat
        self.to_q = Linear(dim, inner, bias=False, compute_dtype=dt)
        self.to_k = Linear(dim, inner, bias=False, compute_dtype=dt)
        self.to_v = Linear(dim, inner, bias=False, compute_dtype=dt)
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
        scale = torch.tensor(math.sqrt(self.head_dim), dtype=q.dtype)
        scores = (q / scale) @ k.transpose(-1, -2)
        if self.softmax_fp32:
            return torch.softmax(scores.float(), dim=-1) @ v.float()
        return torch.softmax(scores, dim=-1) @ v

    def forward(self, x):
        b, n, _ = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        if self.attn_remat and torch.is_grad_enabled():
            # the core draws no random numbers: stashing the RNG state for
            # the recompute doubled the checkpoint's host cost on the card
            o = torch.utils.checkpoint.checkpoint(
                self.core, q, k, v, use_reentrant=False,
                preserve_rng_state=False)
        else:
            o = self.core(q, k, v)
        o = o.transpose(1, 2).reshape(b, n, self.heads * self.head_dim)
        return self.to_out[0](o)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 softmax_fp32: bool = True, attn_remat: bool = False):
        super().__init__()
        dt = compute_dtype
        attn = dict(compute_dtype=dt, softmax_fp32=softmax_fp32,
                    attn_remat=attn_remat)
        self.norm1 = LayerNorm(dim, compute_dtype=dt)
        self.attn1 = Attention(dim, heads, head_dim, **attn)
        self.norm2 = LayerNorm(dim, compute_dtype=dt)
        self.attn2 = Attention(dim, heads, head_dim, **attn)
        self.norm3 = LayerNorm(dim, compute_dtype=dt)
        self.ff = FeedForward(dim, compute_dtype=dt)

    def forward(self, x):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 10, heads: int = 8,
                 head_dim: int = 64, norm_groups: int = 32,
                 compute_dtype: Optional[torch.dtype] = None,
                 softmax_fp32: bool = True, attn_remat: bool = False):
        super().__init__()
        inner = heads * head_dim
        dt = compute_dtype
        self.norm = nn.GroupNorm(norm_groups, in_channels, eps=LN_EPS)
        self.proj_in = Linear(in_channels, inner, compute_dtype=dt)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, heads, head_dim, compute_dtype=dt,
                              softmax_fp32=softmax_fp32,
                              attn_remat=attn_remat)
             for _ in range(num_layers)])
        self.proj_out = Linear(inner, in_channels, compute_dtype=dt)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, C, N) channels-first."""
        h = self.proj_in(self.norm(tokens).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h)
        return self.proj_out(h).transpose(1, 2).to(tokens.dtype) + tokens
