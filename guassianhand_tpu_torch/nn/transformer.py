"""Token transformer backbone (counterpart of ``nn/transformer.py``), with
the diffusers module names of the reference ``Transformer1D``.

- channels-first tokens (B, C, N): GroupNorm -> proj_in -> blocks ->
  proj_out -> + residual;
- each block: pre-LN self-attention, a second attention that is called
  with no context and so is self-attention too, and a GEGLU feed-forward
  with the exact (erf) gelu;
- attention is plain matmul + softmax over the 2048 triplane tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from guassianhand_tpu_torch.nn.mlp import LN_EPS


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # net.0 / net.2 as in diffusers (net.1 is an inference no-op dropout)
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])

    def forward(self, x):
        b, n, _ = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(self.head_dim),
                            dim=-1)
        o = (att @ v).transpose(1, 2).reshape(b, n, self.heads * self.head_dim)
        return self.to_out[0](o)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = Attention(dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim)

    def forward(self, x):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 10, heads: int = 8,
                 head_dim: int = 64, norm_groups: int = 32):
        super().__init__()
        inner = heads * head_dim
        self.norm = nn.GroupNorm(norm_groups, in_channels, eps=LN_EPS)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, heads, head_dim) for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, C, N) channels-first."""
        h = self.proj_in(self.norm(tokens).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h)
        return self.proj_out(h).transpose(1, 2) + tokens
