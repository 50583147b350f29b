"""Acceptance constants and shared helpers of the rasterizer (a frozen copy
of the program's ``ops/common.py``).

The compositing rule is the standard 3DGS tile rasterizer's:
- skip a pixel if power > 0;
- alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255;
- stop before the Gaussian that would take T * (1 - alpha) below 1e-4.
"""
from __future__ import annotations

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
TILE = 16  # tile edge in pixels: the composite kernel's CTA is TILE x TILE

# Margin on the opacity-cull distance bound: a pair is only culled when its
# alpha is below ALPHA_MIN with room to spare for fp32 rounding.
CULL_MARGIN = 1.001


def opacity_cull_r2(radius: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    """Squared pixel distance beyond which a Gaussian's alpha is provably
    below ALPHA_MIN, from lambda_max <= (radius / 3)^2."""
    lam_ub = (radius / 3.0) ** 2
    r2 = 2.0 * lam_ub * torch.log(torch.clamp(opacity, min=1e-12)
                                  * (1.0 / ALPHA_MIN))
    return torch.where(opacity > ALPHA_MIN, r2 * CULL_MARGIN + 1e-2,
                       torch.zeros_like(r2))


def tile_min_dist2(mx, my, tx, ty) -> torch.Tensor:
    """Min squared distance from (mx, my) to the pixel centres of tile
    (tx, ty), i.e. the rect [tx*ts, tx*ts + ts - 1] x [ty*ts, ty*ts + ts - 1]
    with ts = TILE."""
    ts = float(TILE)
    x0 = tx.to(torch.float32) * ts
    y0 = ty.to(torch.float32) * ts
    dx = torch.clamp(torch.maximum(x0 - mx, mx - (x0 + (ts - 1.0))), min=0.0)
    dy = torch.clamp(torch.maximum(y0 - my, my - (y0 + (ts - 1.0))), min=0.0)
    return dx * dx + dy * dy


def opacity_cull_keep(mx, my, radius, opacity, tx, ty) -> torch.Tensor:
    """Keep (gaussian, tile) iff the tile's nearest pixel lies within the
    provable sub-1/255 radius. The one cull rule of the binner and the
    reference compositor."""
    return (tile_min_dist2(mx, my, tx, ty)
            <= opacity_cull_r2(radius, opacity))


def straight_through_alpha(alpha_raw: torch.Tensor) -> torch.Tensor:
    """min(ALPHA_MAX, alpha) in value, identity in gradient: the clamp at
    0.99 passes the gradient straight through, as in the CUDA reference and
    the composite backward kernel."""
    clipped = torch.clamp(alpha_raw, max=ALPHA_MAX)
    return alpha_raw + (clipped - alpha_raw).detach()


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor, n_tiles_x: int,
              n_tiles_y: int, y_band=None):
    """Tile-space bounding rect [min, max) per Gaussian, CUDA getRect
    semantics. ``y_band``: optional per-Gaussian (y_lo, y_hi) tile-row clamp
    of the stacked multi-view canvas. Returns int32 x0, x1, y0, y1."""
    x, y = mean2d[:, 0], mean2d[:, 1]
    ts = float(TILE)

    def trunc(v):
        return v.to(torch.int32)

    zero = torch.zeros((), dtype=torch.int32, device=mean2d.device)
    if y_band is None:
        y_lo = zero
        y_hi = torch.full((), n_tiles_y, dtype=torch.int32, device=mean2d.device)
    else:
        y_lo, y_hi = y_band
    x_hi = torch.full((), n_tiles_x, dtype=torch.int32, device=mean2d.device)
    x0 = torch.minimum(torch.maximum(trunc((x - radius) / ts), zero), x_hi)
    y0 = torch.minimum(torch.maximum(trunc((y - radius) / ts), y_lo), y_hi)
    x1 = torch.minimum(torch.maximum(trunc((x + radius + ts - 1) / ts), zero),
                       x_hi)
    y1 = torch.minimum(torch.maximum(trunc((y + radius + ts - 1) / ts), y_lo),
                       y_hi)
    return x0, x1, y0, y1
