"""Tile binning: depth-sorted per-tile pair lists (a frozen copy of the
program's ``ops/binning.py``).

The JAX binner works under static shapes: a fixed number of tile slots per
Gaussian and a slab budget, with dropped pairs counted as overflow. Here the
shapes are dynamic, so the binner enumerates every (Gaussian, tile) pair of
each Gaussian's 3-sigma rect exactly and drops none:

  1. rect enumeration in row-major order per Gaussian, then the exact
     opacity cull (``ops/common.opacity_cull_keep``);
  2. a STABLE lexicographic (tile, depth) sort, ties in enumeration order —
     the pair order the JAX binner keeps when its overflow is 0;
  3. per-tile ranges as prefix sums of the per-tile counts.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.ops.common import TILE, opacity_cull_keep, tile_rect


@dataclasses.dataclass(frozen=True)
class TileBins:
    """tile_range (T+1,) int32: pairs of tile t are
    pair_gid[tile_range[t]:tile_range[t+1]]; pair_gid (P,) int32 Gaussian
    index per pair in (tile, depth) order."""

    tile_range: torch.Tensor
    pair_gid: torch.Tensor

    @property
    def n_pairs(self) -> int:
        return self.pair_gid.shape[0]

    def counts(self) -> torch.Tensor:
        return self.tile_range[1:] - self.tile_range[:-1]


def grid_dims(height: int, width: int):
    """(tiles across, tiles down) of a height x width image."""
    return -(-width // TILE), -(-height // TILE)


def enumerate_pairs(mean2d: torch.Tensor, radius: torch.Tensor,
                    visible: torch.Tensor, *, height: int, width: int,
                    y_band=None, opacity=None):
    """Every (Gaussian, tile) pair of the rects, Gaussian-major and row-major
    within a rect, minus the pairs the opacity cull drops when ``opacity`` is
    given. Returns (gid (P,) int64, tile (P,) int64)."""
    n = mean2d.shape[0]
    ntx, nty = grid_dims(height, width)
    mean2d = mean2d.detach()
    x0, x1, y0, y1 = tile_rect(mean2d, radius, ntx, nty, y_band=y_band)
    rw = (x1 - x0).to(torch.int64)
    rh = (y1 - y0).to(torch.int64)
    need = torch.where(visible, torch.clamp(rw, min=0) * torch.clamp(rh, min=0),
                       torch.zeros_like(rw))
    gid = torch.repeat_interleave(
        torch.arange(n, device=mean2d.device), need)
    start = torch.cumsum(need, 0) - need
    r = torch.arange(gid.shape[0], device=mean2d.device) - start[gid]
    rw_g = torch.clamp(rw[gid], min=1)
    tx = x0.to(torch.int64)[gid] + r % rw_g
    ty = y0.to(torch.int64)[gid] + r // rw_g
    if opacity is not None:
        keep = opacity_cull_keep(mean2d[gid, 0], mean2d[gid, 1], radius[gid],
                                 opacity.detach()[gid], tx, ty)
        gid, tx, ty = gid[keep], tx[keep], ty[keep]
    return gid, ty * ntx + tx


def bin_gaussians(mean2d: torch.Tensor, depth: torch.Tensor,
                  radius: torch.Tensor, visible: torch.Tensor, *, height: int,
                  width: int, y_band=None, opacity=None) -> TileBins:
    ntx, nty = grid_dims(height, width)
    num_tiles = ntx * nty
    gid, tile = enumerate_pairs(mean2d, radius, visible, height=height,
                                width=width, y_band=y_band, opacity=opacity)
    # Lexicographic stable sort: by depth first, then by tile — the second
    # stable pass keeps depth order (and enumeration order on equal depths)
    # inside each tile.
    by_depth = torch.sort(depth.detach()[gid], stable=True).indices
    by_tile = torch.sort(tile[by_depth], stable=True).indices
    order = by_depth[by_tile]
    counts = torch.bincount(tile, minlength=num_tiles)
    tile_range = torch.zeros(num_tiles + 1, dtype=torch.int32,
                             device=mean2d.device)
    tile_range[1:] = torch.cumsum(counts, 0)
    return TileBins(tile_range=tile_range,
                    pair_gid=gid[order].to(torch.int32).contiguous())
