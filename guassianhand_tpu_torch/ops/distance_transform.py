"""Chamfer distance transform (counterpart of ``ops/distance_transform.py``):
OpenCV's 3x3 chamfer approximation of the L2 distance of each background
pixel to the mask (``cv2.distanceTransform(1 - mask, DIST_L2,
DIST_MASK_3)``), with the axial step a = 0.955 and the diagonal step
b = 1.3693, as two raster sweeps.

Each row's left-to-right relaxation d[j] = min_{k <= j}(c[k] + (j - k) a)
is a running minimum of c[k] - k a, plus j a: one ``torch.cummin`` a row.
The rows chain in a Python loop (the row above enters through its three
neighbours), and the backward sweep is the same sweep on the flipped
image. No OpenCV: the card's machine has none. Batched over leading axes.
"""
from __future__ import annotations

import torch

CHAMFER_A = 0.955
CHAMFER_B = 1.3693
_BIG = 1e9


def _row_relax(c: torch.Tensor, a: float) -> torch.Tensor:
    """Left-to-right min-plus relaxation of rows c (..., W)."""
    ja = torch.arange(c.shape[-1], dtype=c.dtype, device=c.device) * a
    return torch.cummin(c - ja, dim=-1).values + ja


def _sweep(d: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """One raster scan, top to bottom and left to right, of (..., H, W)."""
    big = torch.full(d.shape[:-2] + (1,), _BIG, dtype=d.dtype,
                     device=d.device)
    rows = [_row_relax(d[..., 0, :], a)]
    for r in range(1, d.shape[-2]):
        prev = rows[-1]
        upl = torch.cat([big, prev[..., :-1]], dim=-1)
        upr = torch.cat([prev[..., 1:], big], dim=-1)
        c = torch.minimum(torch.minimum(d[..., r, :], prev + a),
                          torch.minimum(upl + b, upr + b))
        rows.append(_row_relax(c, a))
    return torch.stack(rows, dim=-2)


def chamfer_distance_transform(mask: torch.Tensor, a: float = CHAMFER_A,
                               b: float = CHAMFER_B) -> torch.Tensor:
    """Distance of each zero pixel of ``mask`` (..., H, W) to the nearest
    nonzero one in the 3x3 chamfer metric; 0 inside the mask. float32."""
    d = torch.where(mask > 0, 0.0, _BIG).to(torch.float32)
    d = _sweep(d, a, b)
    d = torch.flip(_sweep(torch.flip(d, (-2, -1)), a, b), (-2, -1))
    return torch.where(torch.isfinite(d), torch.clamp(d, max=_BIG), _BIG)


def mask_distance_channel(mask: torch.Tensor) -> torch.Tensor:
    """The reference's normalised channel: the chamfer distance to the mask
    (..., H, W), thresholded at 0.5, over W / 2, clipped to [0, 1]."""
    d = chamfer_distance_transform(mask > 0.5)
    return torch.clamp(d / (mask.shape[-1] / 2.0), 0.0, 1.0)
