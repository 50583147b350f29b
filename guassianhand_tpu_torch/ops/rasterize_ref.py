"""Dense O(N * P) front-to-back compositing oracle (counterpart of
``ops/rasterize_ref.py``), for tests at a few thousand Gaussians and small
images. It applies the binner's tile-granularity inclusion rule and the same
opacity cull, so it agrees with the tiled path pair for pair. Differentiable by autograd; its
alpha clamp is straight-through (``ops/common.straight_through_alpha``), so
its gradients are those of the composite backward."""
from __future__ import annotations

import torch

from guassianhand_tpu_torch.ops.common import (ALPHA_MIN, T_EPS, TILE,
                                               opacity_cull_keep,
                                               straight_through_alpha,
                                               tile_rect)


def composite_reference(mean2d, conic, color, opacity, depth, radius,
                        visible, height: int, width: int, background):
    """Returns (image (H, W, 3), alpha (H, W), final_T (H, W))."""
    dev = mean2d.device
    sort_depth = torch.where(visible, depth, torch.full_like(depth,
                                                             float("inf")))
    order = torch.sort(sort_depth, stable=True).indices
    mean2d, conic, color = mean2d[order], conic[order], color[order]
    opacity, radius, visible = opacity[order], radius[order], visible[order]

    ys, xs = torch.meshgrid(torch.arange(height, dtype=mean2d.dtype, device=dev),
                            torch.arange(width, dtype=mean2d.dtype, device=dev),
                            indexing="ij")
    px = xs.reshape(-1)
    py = ys.reshape(-1)

    dx = mean2d[None, :, 0] - px[:, None]          # (P, N)
    dy = mean2d[None, :, 1] - py[:, None]
    A, B, C = conic[:, 0], conic[:, 1], conic[:, 2]
    power = -0.5 * (A[None] * dx * dx + C[None] * dy * dy) - B[None] * dx * dy
    alpha = straight_through_alpha(opacity[None, :] * torch.exp(power))

    ntx = -(-width // TILE)
    nty = -(-height // TILE)
    x0, x1, y0, y1 = tile_rect(mean2d, radius, ntx, nty)
    ptx = torch.div(px[:, None], TILE, rounding_mode="floor").to(torch.int32)
    pty = torch.div(py[:, None], TILE, rounding_mode="floor").to(torch.int32)
    in_tile = ((ptx >= x0[None]) & (ptx < x1[None]) & (pty >= y0[None])
               & (pty < y1[None]))
    keep = (visible[None, :] & in_tile & (power <= 0.0) & (alpha >= ALPHA_MIN)
            & opacity_cull_keep(mean2d[None, :, 0], mean2d[None, :, 1],
                                radius[None, :], opacity[None, :], ptx,
                                pty))
    alpha_eff = alpha * keep.to(alpha.dtype)

    g = 1.0 - alpha_eff
    cp_incl = torch.cumprod(g, dim=1)
    cp_excl = torch.cat([torch.ones_like(cp_incl[:, :1]), cp_incl[:, :-1]],
                        dim=1)
    accept = cp_incl >= T_EPS
    w = alpha_eff * cp_excl * accept.to(alpha.dtype)
    img = w @ color
    final_t = torch.amin(torch.where(accept, cp_incl, torch.ones_like(cp_incl)),
                         dim=1)
    img = img + final_t[:, None] * background[None, :]
    return (img.reshape(height, width, 3), (1.0 - final_t).reshape(height, width),
            final_t.reshape(height, width))
