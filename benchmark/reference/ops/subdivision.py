"""Edge-midpoint mesh subdivision with precomputed static topology (a
frozen copy of the program's ``ops/subdivision.py``): the edge list is
built once in numpy; per pose, subdivision is one gather and a mean. New
vertices follow the originals in edge order; child faces come in the order
(a, ab, ca), (ab, b, bc), (ca, ab, bc), (ca, bc, c)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class SubdivisionPlan(NamedTuple):
    edges: np.ndarray       # (E, 2) int32 midpoint sources
    faces_out: np.ndarray   # (4F, 3) int32 child faces over V + E vertices
    n_vertices_in: int
    n_vertices_out: int


def build_subdivision_plan(faces: np.ndarray, n_vertices: int) -> SubdivisionPlan:
    faces = np.asarray(faces, np.int64)
    edge_map = {}
    edges = []

    def edge_id(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_map:
            edge_map[key] = len(edges)
            edges.append(key)
        return edge_map[key]

    child = np.zeros((4 * faces.shape[0], 3), np.int64)
    for i, (a, b, c) in enumerate(faces.tolist()):
        ab = n_vertices + edge_id(a, b)
        bc = n_vertices + edge_id(b, c)
        ca = n_vertices + edge_id(c, a)
        child[4 * i:4 * i + 4] = ((a, ab, ca), (ab, b, bc), (ca, ab, bc),
                                  (ca, bc, c))
    return SubdivisionPlan(edges=np.asarray(edges, np.int32).reshape(-1, 2),
                           faces_out=child.astype(np.int32),
                           n_vertices_in=n_vertices,
                           n_vertices_out=n_vertices + len(edges))


def build_subdivision_plans(faces: np.ndarray, n_vertices: int,
                            levels: int) -> Tuple[SubdivisionPlan, ...]:
    plans = []
    for _ in range(levels):
        plan = build_subdivision_plan(faces, n_vertices)
        plans.append(plan)
        faces, n_vertices = plan.faces_out, plan.n_vertices_out
    return tuple(plans)


def subdivide_vertices(vertices: torch.Tensor,
                       plan: SubdivisionPlan) -> torch.Tensor:
    """(V, D) -> (V + E, D): append the edge midpoints."""
    e = torch.as_tensor(plan.edges, dtype=torch.int64, device=vertices.device)
    mid = 0.5 * (vertices[e[:, 0]] + vertices[e[:, 1]])
    return torch.cat([vertices, mid], dim=0)


def subdivide_n(vertices: torch.Tensor, plans) -> torch.Tensor:
    for plan in plans:
        vertices = subdivide_vertices(vertices, plan)
    return vertices
