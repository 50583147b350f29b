"""Triplane tokenizer and upsampler (a frozen copy of the program's
``nn/tokenizers.py``).

- ``TriplaneLearnablePositionalEmbedding``: learnable (n_plane, C, S, S)
  ``embeddings`` plus the point-encoder condition, flattened to
  (B, C, n_plane * S * S) tokens; ``detokenize`` restores the planes.
- ``TriplaneUpsampler``: ConvTranspose k=2 s=2 per plane, C_in -> C_out,
  under the reference name ``upsample``. Its weight is torch's
  (in, out, kh, kw); the JAX kernel is (kh, kw, in, out) with the spatial
  taps flipped (``compat/from_jax.py`` converts). With a
  ``compute_dtype`` it runs in that type (input, float32 weight and bias
  cast at the call, the bias added after the convolution as flax does).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nn.mlp import normal_
from benchmark.reference.precision import lowp


class TriplaneLearnablePositionalEmbedding(nn.Module):
    def __init__(self, plane_size: int = 32, num_channels: int = 512,
                 n_plane: int = 2):
        super().__init__()
        self.plane_size = plane_size
        self.num_channels = num_channels
        self.n_plane = n_plane
        self.embeddings = nn.Parameter(
            torch.zeros(n_plane, num_channels, plane_size, plane_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.embeddings, 1.0 / math.sqrt(self.num_channels), generator)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        """cond (B, C, S, S) -> tokens (B, C, n_plane * S * S)."""
        b = cond.shape[0]
        x = self.embeddings[None] + cond[:, None]            # (B, Np, C, S, S)
        s = self.plane_size
        return x.transpose(1, 2).reshape(b, self.num_channels,
                                         self.n_plane * s * s)

    def detokenize(self, tokens: torch.Tensor) -> torch.Tensor:
        b, c, nt = tokens.shape
        s = self.plane_size
        if nt != self.n_plane * s * s:
            raise ValueError(f"expected {self.n_plane * s * s} tokens, got {nt}")
        return tokens.reshape(b, c, self.n_plane, s, s).transpose(1, 2)


class TriplaneUpsampler(nn.Module):
    def __init__(self, in_channels: int = 512, out_channels: int = 80,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_channels = out_channels
        self.compute_dtype = compute_dtype
        self.upsample = nn.ConvTranspose2d(in_channels, out_channels,
                                           kernel_size=2, stride=2)

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        """(B, Np, C, S, S) -> (B, Np, out, 2S, 2S)."""
        b, np_, c, s, _ = planes.shape
        x = planes.reshape(b * np_, c, s, s)
        dt = self.compute_dtype
        if dt is None:
            x = self.upsample(x)
        else:
            up = self.upsample
            x = F.conv_transpose2d(lowp(x), lowp(up.weight), stride=2)
            x = lowp(x + lowp(up.bias)[:, None, None])
        return x.reshape(b, np_, self.out_channels, 2 * s, 2 * s)
