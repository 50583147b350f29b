"""The packed two-hand UV atlas (counterpart of ``mano/uv.py``): per-vertex
UVs, the atlas assets, and the projection of points onto the UV mesh.

Right-hand UVs occupy [0, .5] x [0, .5], left-hand UVs [.5, 1] x [0, .5];
the model normalises u by 1 and v by 0.5 into [-1, 1].

- Points that are mesh vertices (the standard path) read a static
  per-vertex UV table, built once by ``static_vertex_uv`` from the
  rest-pose vertices' closest faces of the coarse UV mesh (midpoint
  subdivision is linear and LBS poses the coarse vertices, so those
  barycentric coordinates hold in every pose).
- Off-mesh points (``RendererConfig.exact_duplicate_uv``) go through
  ``get_uvd``: the closest point on every triangle, chunked over the
  points so that no N x F x 3 tensor is held at once, the nearest face by
  ``argmin`` (ties to the first face, as JAX's ``argmin`` breaks them) and
  its barycentric UV. Differentiable in the points.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch


def read_obj_uv(filename: str):
    """(vt, ft, f) of an obj's ``vt`` and ``f`` lines: 0-based indices and
    the v axis flipped, as the reference reads its hand template."""
    vt, ft, f = [], [], []
    with open(filename) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            parts = line.strip().split(" ")
            if parts[0] == "vt":
                vt.append([float(a) for a in parts[1:]])
            elif parts[0] == "f":
                ft.append([int(a.split("/")[1]) for a in parts[1:] if a])
                f.append([int(a.split("/")[0]) for a in parts[1:] if a])
    vt = np.asarray(vt, np.float64)
    ft = np.asarray(ft, np.int32) - 1
    f = np.asarray(f, np.int64) - 1
    vt[:, 1] = 1.0 - vt[:, 1]
    return vt, ft, f


def vertex_uv_table(n_vertices: int, faces: np.ndarray, face_uv: np.ndarray,
                    vt: np.ndarray) -> np.ndarray:
    """(V, 2) float32: each mesh vertex takes the UV of its first face
    corner (seam vertices have several). Every vertex must be in a face."""
    fv = np.asarray(faces).reshape(-1)
    fuv = np.asarray(face_uv).reshape(-1)
    if np.setdiff1d(np.arange(n_vertices), fv).size:
        raise ValueError("some vertices are not referenced by any face")
    out = np.zeros((n_vertices, 2), np.float32)
    order = np.arange(fv.shape[0])[::-1]     # the first occurrence wins
    out[fv[order]] = vt[fuv[order]].astype(np.float32)
    return out


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


@dataclasses.dataclass(frozen=True)
class UVAtlas:
    """Packed two-hand UV atlas over the (possibly subdivided) mesh."""

    vert_uv: np.ndarray   # (V, 2) per-vertex UV in the packed layout
    faces: np.ndarray     # (F, 3) mesh faces
    face_uv: np.ndarray   # (F, 3, 2) per-corner UVs

    @property
    def n_vertices(self) -> int:
        return self.vert_uv.shape[0]


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


def project_to_faces(points: torch.Tensor, tri_xyz: torch.Tensor,
                     chunk: int = 1024):
    """Each point's nearest face and its barycentric coordinates there:
    (face index (N,) numpy, bary (N, 3) numpy)."""
    a, b, c = tri_xyz[:, 0], tri_xyz[:, 1], tri_xyz[:, 2]
    fis, barys = [], []
    for s in range(0, points.shape[0], chunk):
        fi, bary, _ = _nearest_faces(points[s:s + chunk], a, b, c)
        fis.append(fi)
        barys.append(bary)
    return torch.cat(fis).cpu().numpy(), torch.cat(barys).cpu().numpy()


def static_vertex_uv(rest_verts_sub: np.ndarray, coarse_tri_xyz: np.ndarray,
                     coarse_tri_uv: np.ndarray) -> np.ndarray:
    """Per-subdivided-vertex UV (N, 2) float32 by the static barycentric
    projection onto the coarse UV mesh (``project_to_faces``). numpy in and
    out; computed on the host, once, so that every device reads the same
    table."""
    fi, bary = project_to_faces(
        torch.as_tensor(np.asarray(rest_verts_sub, np.float32)),
        torch.as_tensor(np.asarray(coarse_tri_xyz, np.float32)))
    return np.einsum("nk,nkd->nd", bary,
                     np.asarray(coarse_tri_uv)[fi]).astype(np.float32)


def load_uv_atlas(asset_dir: Optional[str] = None) -> Optional[dict]:
    """The packed two-hand UV assets, or None: ``hand.obj`` (and, where
    present, ``change_r.npy``, ``change_l.npy``, ``face_left.npy``) from
    ``asset_dir``, ``$GH_MANO_UV_PATH`` or ``./assets/mano_uv``. Returns
    vt (packed: the right hand's UVs halved, the left hand's halved and
    shifted by 0.5 in u), ft_r, f and the .npy arrays by name."""
    bases = [asset_dir, os.environ.get("GH_MANO_UV_PATH"), "./assets/mano_uv"]
    base = next((b for b in bases if b and os.path.exists(
        os.path.join(b, "hand.obj"))), None)
    if base is None:
        return None
    vt_r, ft_r, f = read_obj_uv(os.path.join(base, "hand.obj"))
    vt_l = vt_r.copy()
    vt_r = vt_r / 2.0
    vt_l[:, 0] = 0.5 + vt_l[:, 0] / 2.0
    vt_l[:, 1] = vt_l[:, 1] / 2.0
    out = {"vt": np.concatenate([vt_r, vt_l]).astype(np.float32),
           "ft_r": ft_r, "f": f}
    for name in ("change_r", "change_l", "face_left"):
        p = os.path.join(base, f"{name}.npy")
        if os.path.exists(p):
            out[name] = np.load(p, allow_pickle=True)
    return out
