"""LocalPoolPointnet: point encoder with grid-pooled local features (a
frozen copy of the program's ``nn/pointnet.py``). The first two input
channels are plane coordinates in [-radius, radius]; per-block features are
max-pooled onto a plane_size^2 grid and gathered back per point; the last
features are mean-pooled into the (C, plane_size, plane_size) plane. Empty
cells pool to 0. With a ``compute_dtype`` the Dense and ResNet layers and
the block max-pools run in it (parameters stay float32); the final
mean-pool always sums in float32, as in the JAX package: a bf16 sum over
thousands of points a cell would lose most of its mantissa."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from benchmark.reference.nn.mlp import Linear, ResnetBlockFC


def coord_index(p_xy: torch.Tensor, plane_size: int,
                radius: float) -> torch.Tensor:
    """(B, T, 2) coords in [-radius, radius] -> (B, T) int64 cell index."""
    pos = torch.clamp(p_xy, -radius + 1e-6, radius - 1e-6)
    pos01 = (pos + radius) / (2.0 * radius)
    ij = (pos01 * plane_size).to(torch.int64)
    return ij[..., 0] + plane_size * ij[..., 1]


def _scatter(x: torch.Tensor, index: torch.Tensor, n_cells: int,
             reduce: str) -> torch.Tensor:
    """Per-batch scatter of (B, T, C) rows into (B, n_cells, C) with
    ``scatter_reduce`` (``include_self=False``: empty cells stay 0)."""
    b, t, c = x.shape
    flat = (index + n_cells * torch.arange(b, device=x.device)[:, None])
    out = torch.zeros((b * n_cells, c), dtype=x.dtype, device=x.device)
    out = out.scatter_reduce(0, flat.reshape(-1, 1).expand(-1, c),
                             x.reshape(-1, c), reduce, include_self=False)
    return out.reshape(b, n_cells, c)


class LocalPoolPointnet(nn.Module):
    def __init__(self, dim_in: int, c_dim: int = 512, hidden_dim: int = 128,
                 plane_size: int = 32, n_blocks: int = 5, radius: float = 1.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c_dim = c_dim
        self.plane_size = plane_size
        self.radius = radius
        dt = compute_dtype
        self.fc_pos = Linear(dim_in, 2 * hidden_dim, compute_dtype=dt)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(2 * hidden_dim, hidden_dim, compute_dtype=dt)
             for _ in range(n_blocks)])
        self.fc_c = Linear(hidden_dim, c_dim, compute_dtype=dt)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        """p (B, T, D) -> (B, c_dim, plane_size, plane_size)."""
        b = p.shape[0]
        n_cells = self.plane_size ** 2
        index = coord_index(p[..., :2], self.plane_size, self.radius)
        gather_idx = index[..., None]
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            pooled = _scatter(net, index, n_cells, "amax")
            pooled = torch.gather(pooled, 1,
                                  gather_idx.expand(-1, -1, net.shape[-1]))
            net = block(torch.cat([net, pooled], dim=-1))
        c = self.fc_c(net).float()
        plane = _scatter(c, index, n_cells, "mean")            # (B, cells, C)
        return plane.transpose(1, 2).reshape(b, self.c_dim, self.plane_size,
                                             self.plane_size)
