"""Farthest point sampling, ball query and grouping (counterpart of
``ops/fps.py``), for the snowflake upsampler of the point-cloud generator.

Farthest point sampling starts from point 0 and takes, at each step, the
point farthest from every sample so far: a min-distance scan, one step a
sample, in plain PyTorch (about 2,047 steps of a few launches each for
15,404 -> 2,048 points). A subdivided mesh has exact distance ties, and one
ulp decides the next sample, so the squared distance is formed as the JAX
package's compiled CPU code forms it (the fused multiply-add chain of
``ops/knn.py``), and ``argmax`` takes the first maximum, as ``jnp.argmax``.
"""
from __future__ import annotations

import torch

from guassianhand_tpu_torch.ops.knn import _sq_norm_fma, knn


def farthest_point_sample(points: torch.Tensor, n_samples: int
                          ) -> torch.Tensor:
    """points (N, 3) -> (n_samples,) int64 indices, starting from point 0.
    The loop stays on the device: no step reads a value back (indexing by
    a 0-d tensor would, so the next point is an ``index_select``)."""
    idx = torch.zeros(n_samples, dtype=torch.int64, device=points.device)
    mind = torch.full(points.shape[:1], float("inf"), device=points.device)
    last = points[:1]
    for i in range(1, n_samples):
        mind = torch.minimum(mind, _sq_norm_fma(points - last))
        j = torch.argmax(mind, dim=0, keepdim=True)
        idx[i:i + 1] = j
        last = torch.index_select(points, 0, j)
    return idx


def fps_subsample(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(N, C) -> (n_samples, C), xyz in the first 3 channels."""
    return points[farthest_point_sample(points[:, :3], n_samples)]


def ball_query(query: torch.Tensor, points: torch.Tensor, radius: float,
               k: int):
    """The k nearest points of each query that lie within ``radius``; slots
    outside the ball repeat the nearest. Returns (idx (Q, k), inside
    (Q, k) bool)."""
    d, idx = knn(query, points, k)
    inside = d <= radius * radius
    return torch.where(inside, idx, idx[:, :1]), inside


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (N, C), idx (Q, K) -> (Q, K, C)."""
    return features[idx]
