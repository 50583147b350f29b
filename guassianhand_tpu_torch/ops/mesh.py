"""Mesh utilities (counterpart of ``ops/mesh.py``): the wrist seal, vertex
normals and mesh concatenation. ``seal`` and ``concat_meshes`` are numpy
(set-up time); ``vertex_normals`` is torch."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# the MANO wrist's boundary ring
WRIST_RING = np.array([108, 79, 78, 121, 214, 215, 279, 239, 234, 92, 38,
                       122, 118, 117, 119, 120], np.int32)


def seal(verts: np.ndarray, faces: np.ndarray, left: bool = False):
    """Append a wrist-centre vertex and the fan that closes the ring (wound
    the other way for the left hand)."""
    center = verts[WRIST_RING].mean(0, keepdims=True)
    out_v = np.concatenate([verts, center], axis=0)
    cid = out_v.shape[0] - 1
    fan = []
    for i in range(len(WRIST_RING)):
        if left:
            fan.append([WRIST_RING[i - 1], cid, WRIST_RING[i]])
        else:
            fan.append([WRIST_RING[i - 1], WRIST_RING[i], cid])
    return out_v, np.concatenate([faces, np.asarray(fan, faces.dtype)], axis=0)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals; verts (V, 3), faces (F, 3)."""
    faces = faces.to(torch.int64)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    n = torch.zeros_like(verts)
    for i in range(3):
        n = n.index_add(0, faces[:, i], fn)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-6)


def concat_meshes(meshes: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """[(verts, faces), ...] -> (verts, faces), each mesh's faces offset by
    the vertices before it."""
    vs: List[np.ndarray] = []
    fs: List[np.ndarray] = []
    off = 0
    for v, f in meshes:
        vs.append(np.asarray(v))
        fs.append(np.asarray(f) + off)
        off += v.shape[0]
    return np.concatenate(vs, axis=0), np.concatenate(fs, axis=0)
