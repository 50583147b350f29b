"""Bilinear feature-map sampling, ``align_corners=True`` (a frozen copy of
the program's ``ops/grid_sample.py::_sample_core``): the four-tap gather
with the JAX package's clipping rules — corner indices clamped into the
map, weights clamped to [0, 1] — so out-of-range coordinates clamp to the
border."""
from __future__ import annotations

import torch


def grid_sample_2d(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat (C, H, W); uv (N, 2) in [-1, 1], x then y -> (N, C)."""
    c, h, w = feat.shape
    x = (uv[:, 0] + 1.0) * 0.5 * (w - 1)
    y = (uv[:, 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)
    wy = torch.clamp(y - y0, 0.0, 1.0)
    x0i, x1i, y0i, y1i = (v.to(torch.int64) for v in (x0, x1, y0, y1))

    f = feat.reshape(c, h * w)
    g00 = f[:, y0i * w + x0i]
    g01 = f[:, y0i * w + x1i]
    g10 = f[:, y1i * w + x0i]
    g11 = f[:, y1i * w + x1i]
    top = g00 * (1 - wx) + g01 * wx
    bot = g10 * (1 - wx) + g11 * wx
    return (top * (1 - wy) + bot * wy).T


def grid_sample_batched(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat (B, C, H, W); uv (B, N, 2) -> (B, N, C)."""
    return torch.stack([grid_sample_2d(f, u) for f, u in zip(feat, uv)])
