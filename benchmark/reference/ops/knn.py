"""Brute-force k-nearest neighbours and the interaction detector (a frozen
copy of the program's ``ops/knn.py``): a chunked distance matrix and a
top-k of the k smallest distances, ties by index.

The subdivided hand mesh has exact distance ties (an edge midpoint is
equidistant from the edge's two ends), and the interaction test compares
neighbour lists position by position, so the order of tied neighbours
decides the mask. Ties go to the lower index, as ``lax.top_k`` breaks them:
the top-k runs on int64 keys that order as (distance, index), so no two
keys tie. The distances are formed as the JAX package's compiled CPU code
forms them: the squared norms accumulate with fused multiply-adds
(evaluated exactly in float64 here), then d = (|q|^2 - 2 q.p) + |p|^2.
"""
from __future__ import annotations

import torch


def _sq_norm_fma(x: torch.Tensor) -> torch.Tensor:
    """sum_i x_i^2 over the last axis as a fused multiply-add chain."""
    xd = x.double()
    acc = (x[..., 0] * x[..., 0]).double()
    for i in range(1, x.shape[-1]):
        acc = (xd[..., i] * xd[..., i] + acc).float().double()
    return acc.float()


def _order_keys(d: torch.Tensor) -> torch.Tensor:
    """(Q, P) float32 -> int64 keys that order as (d, column index): the
    float's bits made monotone as a signed integer (-0.0 first turned into
    +0.0, which compares equal to it), times 2^32, plus the index."""
    bits = (d + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(d.shape[-1], device=d.device)
    return bits.to(torch.int64) * (1 << 32) + col


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        query_chunk: int = 4096):
    """(dists (Q, k), idx (Q, k)): squared L2 distances, ascending, ties
    by index."""
    p_sq = _sq_norm_fma(points)
    dists, idx = [], []
    for s in range(0, query.shape[0], query_chunk):
        qc = query[s:s + query_chunk]
        d = (_sq_norm_fma(qc)[:, None] - 2.0 * qc @ points.T) + p_sq[None, :]
        keys = torch.topk(_order_keys(d), k, dim=-1, largest=False).values
        i = keys & 0xFFFFFFFF
        dists.append(torch.gather(d, 1, i))
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)


def interaction_mask(points_posed: torch.Tensor, points_tpose: torch.Tensor,
                     k: int = 100, threshold: int = 10) -> torch.Tensor:
    """A point interacts when fewer than ``threshold`` of its k nearest
    neighbour indices agree, position by position, between posed space and
    the canonical T-pose. (N, 3) each -> (N,) bool."""
    _, idx_world = knn(points_posed, points_posed, k)
    _, idx_canon = knn(points_tpose, points_tpose, k)
    return torch.sum(idx_world == idx_canon, dim=-1) < threshold
