"""The packed two-hand UV atlas (the program's ``mano/uv.py``, cut to the
synthetic atlas, the UV normalisation and ``get_uvd``).

Right-hand UVs occupy [0, .5] x [0, .5], left-hand UVs [.5, 1] x [0, .5];
the model normalises u by 1 and v by 0.5 into [-1, 1]. ``get_uvd``
projects off-mesh points (``RendererConfig.exact_duplicate_uv``): the
closest point on every triangle, the nearest face by ``argmin`` and its
barycentric UV.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def synthetic_uv_atlas(vertices: np.ndarray, right: bool = True) -> np.ndarray:
    """Per-vertex UV when no MANO atlas is at hand: a planar xz projection
    into the hand's half of the packed atlas."""
    v = np.asarray(vertices)
    mn = v.min(0)
    ext = np.maximum(v.max(0) - mn, 1e-6)
    u = (v[:, 0] - mn[0]) / ext[0] * 0.5
    w = (v[:, 1] - mn[1]) / ext[1] * 0.5
    if not right:
        u = u + 0.5
    return np.stack([u, w], axis=1).astype(np.float32)


def normalize_uv(uv: torch.Tensor) -> torch.Tensor:
    """Packed-atlas uv -> [-1, 1]^2: u by 1, v by 0.5."""
    return torch.stack([2.0 * uv[..., 0] - 1.0,
                        2.0 * (uv[..., 1] / 0.5) - 1.0], dim=-1)


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x != 0, x, torch.ones_like(x))


def _closest_point_on_tri(p, a, b, c):
    """Ericson's closest point on triangle (a, b, c) to p, all (..., 3):
    (the point, its barycentric coordinates (..., 3))."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom_in = _safe(va + vb + vc)
    v_in, w_in = vb / denom_in, vc / denom_in
    v_ab = (d1 / _safe(d1 - d3)).clamp(0.0, 1.0)
    w_ac = (d2 / _safe(d2 - d6)).clamp(0.0, 1.0)
    t_bc = ((d4 - d3) / _safe((d4 - d3) + (d5 - d6))).clamp(0.0, 1.0)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    vertex = in_a | in_b | in_c
    on_ab = ~vertex & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = ~vertex & ~on_ab & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (~vertex & ~on_ab & ~on_ac & (va <= 0) & ((d4 - d3) >= 0)
             & ((d5 - d6) >= 0))
    interior = ~vertex & ~on_ab & ~on_ac & ~on_bc

    zero = torch.zeros_like(d1)
    v = torch.where(in_b, 1.0, zero)
    w = torch.where(in_c, 1.0, zero)
    v = torch.where(on_ab, v_ab, v)
    w = torch.where(on_ac, w_ac, w)
    v = torch.where(on_bc, 1.0 - t_bc, v)
    w = torch.where(on_bc, t_bc, w)
    v = torch.where(interior, v_in, v)
    w = torch.where(interior, w_in, w)
    # every point falls in one of the regions, so u = 1 - v - w throughout
    u = 1.0 - v - w
    bary = torch.stack([u, v, w], dim=-1)
    point = a * u[..., None] + b * v[..., None] + c * w[..., None]
    return point, bary


def _nearest_faces(pc, a, b, c):
    """For the chunk of points pc (n, 3): (the nearest face of each (n,),
    its closest point's barycentric coordinates (n, 3), the closest point
    (n, 3))."""
    cp, bary = _closest_point_on_tri(pc[:, None, :], a[None], b[None],
                                     c[None])
    fi = torch.argmin(((pc[:, None, :] - cp) ** 2).sum(-1), dim=1)
    rows = torch.arange(pc.shape[0], device=pc.device)
    return fi, bary[rows, fi], cp[rows, fi]


def get_uvd(points: torch.Tensor, tri_xyz: torch.Tensor,
            tri_uv: torch.Tensor, chunk: int = 1024):
    """Project points (N, 3) onto the mesh of triangles tri_xyz (F, 3, 3)
    with corner UVs tri_uv (F, 3, 2): (uv (N, 2), signed distance (N,)),
    the sign that of the nearest face's normal. Differentiable; the choice
    of face is a hard selection, as in the reference's search."""
    a, b, c = tri_xyz[:, 0], tri_xyz[:, 1], tri_xyz[:, 2]
    normal = torch.linalg.cross(b - a, c - a)
    normal = normal / torch.linalg.norm(normal, dim=-1,
                                        keepdim=True).clamp_min(1e-12)
    uvs, ds = [], []
    for s in range(0, points.shape[0], chunk):
        pc = points[s:s + chunk]
        fi, bary, cp = _nearest_faces(pc, a, b, c)
        uvs.append(torch.einsum("nk,nkd->nd", bary, tri_uv[fi]))
        diff = pc - cp
        sign = torch.sign((diff * normal[fi]).sum(-1))
        ds.append(torch.linalg.norm(diff, dim=-1)
                  * torch.where(sign == 0, 1.0, sign))
    return torch.cat(uvs), torch.cat(ds)
