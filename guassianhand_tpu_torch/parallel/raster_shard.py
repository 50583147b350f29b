"""The sharded rasterizer: Gaussian-parallel projection, one uneven
all_to_all moving (Gaussian, tile) pairs to the rank that owns the tile,
tile-parallel compositing (counterpart of ``parallel/raster_shard.py``).

On each rank of a model group (``parallel/mesh.py``):

  1. project this rank's shard of the Gaussians (N / n_model rows) for
     every (sample, view) of its data shard, on the stacked canvas of
     ``ops/rasterize.py::project_views``, and enumerate its pairs with the
     binner's own rule (``ops/binning.py::enumerate_pairs``, the exact
     opacity cull included);
  2. own the tiles DIAGONALLY (``_owner_slot``: a row-rotated bijection of
     tile ids, cyclic over the ranks), so that hands concentrated on a few
     rows or columns spread over every rank;
  3. bucket the pairs by owner, in their enumeration order, with each
     pair's attribute values in the tile's own frame (only the offset
     within the tile travels), and exchange them: the bucket counts first,
     then the rows themselves in ONE uneven all_to_all. Only live pairs
     travel; with ``exchange_capacity`` each (src, dst) bucket keeps at
     most that many and the pairs it drops are counted in ``overflow``;
  4. composite what it received as "virtual Gaussians" of one pair each on
     a one-tile-row canvas of its owned tiles, through ``CompositeInputs.
     composite()``: the forward kernel, its backward and the segment sum
     (K1, K2, K3) run as on the unsharded path;
  5. all-gather the owned tiles over the model group and un-permute them
     with a static index: every rank of the group holds the image.

The gradient comes back by autograd: the gather's backward hands each rank
its tiles' gradient, the composite's backward gives the received pairs'
gradients, the all_to_all's backward sends them to their senders, and the
sender's row gather scatters them onto its Gaussians. A rank's gradients
are therefore those of its shard; ``parallel/step.py`` sums them over the
model group.

Where JAX pads every bucket to a static capacity, the exchange here is
uneven and moves only the live pairs. The receive buffer is concatenated
by source rank and each bucket keeps its sender's order, so the stable
(tile, depth) sort breaks ties in global Gaussian order, as the unsharded
binner does. The tile-local frame changes the float32 rounding of the
means, so the sharded render equals the unsharded one within tolerances,
not to the bit (JAX's design too).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.core.gaussians import Gaussians
from guassianhand_tpu_torch.ops.binning import enumerate_pairs, grid_dims
from guassianhand_tpu_torch.ops.common import TILE
from guassianhand_tpu_torch.ops.rasterize import (CompositeInputs,
                                                  RasterizeConfig, _project,
                                                  project_views)
from guassianhand_tpu_torch.ops.rasterize_cuda import pack_attrs
from guassianhand_tpu_torch.parallel import comm
from guassianhand_tpu_torch.parallel.mesh import Mesh


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _diag_shift(n_model: int) -> int:
    """Row shift of the diagonal ownership: odd, about n_model / 2, coprime
    with n_model (bumped by 2 until it is)."""
    s = (n_model // 2) | 1
    while math.gcd(s, n_model) != 1:
        s += 2
    return s


def _owner_slot(tile, ntx: int, n_model: int):
    """(owner rank, local slot) of each tile id: a bijective permutation pi
    of the tile ids that rotates each tile row's columns by s * ty, then
    owner = pi % n_model, slot = pi // n_model. Plain ``tile % n_model``
    stripes ownership by column whenever ntx % n_model == 0 (256^2 in 16 px
    tiles on 4 or 8 ranks); the rotation runs the stripes diagonally. For
    numpy arrays and integer tensors alike."""
    s = _diag_shift(n_model)
    ty = tile // ntx
    pi = ty * ntx + (tile % ntx + s * ty) % ntx
    return pi % n_model, pi // n_model


def _shard(g: Gaussians, lo: int, hi: int) -> Gaussians:
    return Gaussians(xyz=g.xyz[lo:hi], opacity=g.opacity[lo:hi],
                     rotation=g.rotation[lo:hi], scaling=g.scaling[lo:hi],
                     shs=g.shs[lo:hi],
                     valid=None if g.valid is None else g.valid[lo:hi])


def _send_buckets(owner: torch.Tensor, n_model: int,
                  capacity: Optional[int]):
    """The pairs to send in bucket order (owner, then enumeration order),
    each bucket cut to ``capacity``. Returns (pair indices, counts per
    destination (n_model,), pairs dropped)."""
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=n_model)
    if capacity is None:
        return order, counts, 0
    start = torch.cumsum(counts, 0) - counts
    rank = (torch.arange(order.shape[0], device=owner.device)
            - start[owner[order]])
    keep = rank < capacity
    kept = torch.clamp(counts, max=capacity)
    return order[keep], kept, int((counts - kept).sum())


def _exchange(rows: torch.Tensor, depth: torch.Tensor, gid: torch.Tensor,
              owner: torch.Tensor, slot: torch.Tensor,
              offset: torch.Tensor, mesh: Mesh, capacity: Optional[int]):
    """One all_to_all of the pairs' rows over the model group.

    rows (R, 9): ``pack_attrs`` rows of the Gaussians (differentiable);
    per pair: gid into ``rows``, owner rank, slot on the owner's canvas and
    the (x, y) offset subtracted from the mean. Returns the received rows
    (P, 9), depths (P,), slots (P,) int64 and the pairs dropped."""
    sel, counts, dropped = _send_buckets(owner, mesh.n_model, capacity)
    g = gid[sel]
    pad = offset.new_zeros((sel.shape[0], 7))
    attrs = rows[g] - torch.cat([offset[sel], pad], dim=1)
    # depth and slot ride along as two more columns (slots stay far below
    # 2^24, exact in float32); they carry no gradient
    extra = torch.stack([depth.detach()[g], slot[sel].to(torch.float32)], 1)
    send = torch.cat([attrs, extra], dim=1)
    recv_counts = comm.exchange_counts(counts, mesh.model_group)
    recv = comm.all_to_all(send, counts.tolist(), recv_counts.tolist(),
                           mesh.model_group)
    return (recv[:, :9], recv[:, 9].detach(),
            recv[:, 10].detach().to(torch.int64), dropped)


def _composite_received(attrs: torch.Tensor, depth: torch.Tensor,
                        slot: torch.Tensor, n_tiles: int, height: int,
                        width: int):
    """(rgb, final_t) of the received pairs, each its own Gaussian binned to
    its slot alone: the stable (slot, depth) sort, ties in arrival order."""
    by_depth = torch.sort(depth, stable=True).indices
    by_slot = torch.sort(slot[by_depth], stable=True).indices
    order = by_depth[by_slot]
    tile_range = torch.zeros(n_tiles + 1, dtype=torch.int32,
                             device=attrs.device)
    tile_range[1:] = torch.cumsum(torch.bincount(slot, minlength=n_tiles), 0)
    return CompositeInputs(tile_range, order.to(torch.int32).contiguous(),
                           attrs.contiguous(), height, width).composite()


def _evidence(received: int, dropped: int, device, mesh: Mesh):
    """(live pairs received by each rank (world,), pairs dropped in all)."""
    mine = torch.tensor([received, dropped], dtype=torch.int64, device=device)
    every = comm.all_gather(mine, mesh.world)
    return every[:, 0], every[:, 1].sum()


def sharded_rasterize(gaussians: Gaussians, camera: Camera, *, height: int,
                      width: int, mesh: Mesh, background=None,
                      config: RasterizeConfig = RasterizeConfig(),
                      exchange_capacity: Optional[int] = None):
    """One view (RGB mode) with the Gaussians and the tile ROW BANDS split
    over the model group: model rank d owns rows [d * band_h, (d + 1) *
    band_h) and composites them as its own canvas (the band-local tile grid
    equals the global one shifted by the band). ``gaussians`` holds all N
    rows on every rank (N divisible by n_model); the tile-row count must
    divide over the model group. Returns comp_rgb (H, W, 3), comp_mask,
    final_t (H, W) on every rank of the group, and overflow."""
    n_dev, d = mesh.n_model, mesh.model_index
    n = gaussians.n
    if n % n_dev:
        raise ValueError(f"{n} Gaussians do not split over model={n_dev}")
    ntx, nty = grid_dims(height, width)
    if nty % n_dev:
        raise ValueError(f"tile rows {nty} must divide over model={n_dev}; "
                         "pad the image")
    band_rows = nty // n_dev
    band_h = band_rows * TILE
    n_loc = n // n_dev
    dev = gaussians.xyz.device
    background = torch.zeros(3, device=dev) if background is None else \
        torch.as_tensor(background, dtype=torch.float32, device=dev)
    g = _shard(gaussians, d * n_loc, (d + 1) * n_loc)
    opacity = g.effective_opacity()[:, 0]
    proj = _project(g, camera, config)
    gid, tile = enumerate_pairs(proj.mean2d, proj.radius, proj.visible,
                                height=height, width=width, opacity=opacity)
    owner = tile // (band_rows * ntx)
    slot = tile % (band_rows * ntx)
    rows = pack_attrs(proj.mean2d, proj.conic, g.shs[:, 0, :], opacity)
    # the receiver's band starts at its first pixel row
    offset = torch.stack([torch.zeros_like(owner), owner * band_h],
                         1).to(torch.float32)
    attrs, depth, rslot, dropped = _exchange(rows, proj.depth, gid, owner,
                                             slot, offset, mesh,
                                             exchange_capacity)
    rgb, final_t = _composite_received(attrs, depth, rslot,
                                       band_rows * ntx, band_h, width)
    band = comm.all_gather(torch.cat([rgb, final_t[..., None]], -1),
                           mesh.model_group).reshape(nty * TILE, width, 4)
    rgb, final_t = band[:height, :, :3], band[:height, :, 3]
    rgb = rgb + final_t[..., None] * background[None, None, :]
    _, overflow = _evidence(attrs.shape[0], dropped, dev, mesh)
    return {"comp_rgb": rgb, "comp_mask": 1.0 - final_t, "final_t": final_t,
            "overflow": overflow}


def _canvas(n_samples: int, views: int, height: int, width: int,
            n_model: int):
    """(ntx, tile rows of a band, band height, tiles, tiles a rank) of the
    stacked canvas of n_samples x views bands."""
    ntx, nty_band = grid_dims(height, width)
    num_tiles = n_samples * views * nty_band * ntx
    return ntx, nty_band, nty_band * TILE, num_tiles, -(-num_tiles // n_model)


def exchange_balance_stats(gaussians: Sequence[Gaussians], w2cs, Ks, *,
                           height: int, width: int, n_model: int,
                           config: RasterizeConfig = RasterizeConfig(),
                           use_rgb: bool = True, sh_degree: int = 3) -> dict:
    """Load-balance figures of the exchange, replaying
    ``sharded_rasterize_batch``'s enumeration and ownership unsharded, on
    one rank (CPU or card), for ``n_model`` ranks and one sample a data
    shard (the fit's). ``gaussians``: one Gaussians a sample.

    For the shipped DIAGONAL ownership and the two naive ones (CYCLIC,
    tile % n_model; contiguous BANDS of ceil(tiles / n_model)): live pairs
    per destination, their max / mean and the busiest (src, dst) bucket;
    the lossless default capacity of JAX's static exchange (every pair
    slot, ``config.max_tiles_per_gaussian`` a Gaussian) and its padding
    factor over that bucket; and ``suggested_capacity``, the busiest
    bucket plus 25 %, rounded up to 8. The JAX package's keys and formulas;
    the pairs are the port's exact enumeration (no per-Gaussian tile cap)."""
    b, n = len(gaussians), gaussians[0].n
    v = w2cs.shape[1]
    m = config.max_tiles_per_gaussian
    ntx, nty_band, band_h, num_tiles, tpd = _canvas(b, v, height, width,
                                                    n_model)
    n_loc = n // n_model
    tiles_all, src_all = [], []
    with torch.no_grad():
        for bi, g in enumerate(gaussians):
            rows = project_views(g, w2cs[bi], Ks[bi], height=height,
                                 width=width, sh_degree=sh_degree,
                                 use_rgb=use_rgb, config=config,
                                 first_band=bi * v)
            lo = rows["band_lo"]
            gid, tile = enumerate_pairs(
                rows["mean2d"], rows["radius"], rows["visible"],
                height=b * v * band_h, width=width,
                y_band=(lo, lo + nty_band), opacity=rows["opacity"])
            tiles_all.append(tile.cpu().numpy())
            # the source shard of a pair: the Gaussian-axis split
            src_all.append((gid % n).cpu().numpy() // n_loc)
    tiles = np.concatenate(tiles_all)
    srcs = np.concatenate(src_all)
    owners = {"diagonal": np.asarray(_owner_slot(tiles, ntx, n_model)[0]),
              "cyclic": tiles % n_model,
              "banded": tiles // tpd}
    out = {"live_pairs": int(tiles.shape[0]), "num_tiles": int(num_tiles),
           "n_model": n_model}
    for name, owner in owners.items():
        per_dst = np.bincount(owner, minlength=n_model)
        buckets = np.zeros((n_model, n_model), np.int64)
        np.add.at(buckets, (srcs, owner), 1)
        out[name] = {
            "per_dst": per_dst.tolist(),
            "max_over_mean": round(float(per_dst.max())
                                   / max(per_dst.mean(), 1e-9), 3),
            "max_bucket": int(buckets.max()),
        }
    default_cap = _round_up(b * v * n_loc * m, 8)
    out["default_capacity"] = default_cap
    out["capacity_padding_factor"] = round(
        default_cap / max(out["diagonal"]["max_bucket"], 1), 2)
    out["suggested_capacity"] = _round_up(
        int(out["diagonal"]["max_bucket"] * 1.25), 8)
    return out


def sharded_rasterize_batch(gaussians: Sequence[Gaussians], w2cs, Ks, *,
                            height: int, width: int, mesh: Mesh,
                            background=None, sh_degree: int = 3,
                            use_rgb: bool = True,
                            config: RasterizeConfig = RasterizeConfig(),
                            exchange_capacity: Optional[int] = None):
    """Render this rank's data shard through the exchange (the module
    docstring's steps). ``gaussians``: one Gaussians of N rows for each of
    its bl samples, whole on every rank of the model group (N divisible by
    n_model); w2cs (bl, V, 4, 4), Ks (bl, V, 3/4, 3/4), background (bl, 3).
    RGB or SH colours.

    Returns comp_rgb (bl, V, H, W, 3), comp_mask and final_t (bl, V, H, W),
    the same on every rank of the model group; overflow, the pairs the
    capacity dropped on every rank; exchange_pairs (world,), the live pairs
    each rank received: the evidence that the exchange ran."""
    n_model, m = mesh.n_model, mesh.model_index
    bl, n = len(gaussians), gaussians[0].n
    v = w2cs.shape[1]
    if n % n_model:
        raise ValueError(f"{n} Gaussians do not split over model={n_model}")
    n_loc = n // n_model
    ntx, nty_band, band_h, num_tiles, tpd = _canvas(bl, v, height, width,
                                                    n_model)
    dev = gaussians[0].xyz.device
    if background is None:
        background = torch.zeros((bl, 3), device=dev)
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)

    parts = [project_views(_shard(g, m * n_loc, (m + 1) * n_loc), w2cs[i],
                           Ks[i], height=height, width=width,
                           sh_degree=sh_degree, use_rgb=use_rgb,
                           config=config, first_band=i * v)
             for i, g in enumerate(gaussians)]
    rows = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    lo = rows["band_lo"]
    gid, tile = enumerate_pairs(rows["mean2d"], rows["radius"],
                                rows["visible"], height=bl * v * band_h,
                                width=width, y_band=(lo, lo + nty_band),
                                opacity=rows["opacity"])
    owner, slot = _owner_slot(tile, ntx, n_model)
    # sender-side remap to the tile's own frame: the owner lays its tiles
    # out as one row, so only the offset within the tile survives
    offset = torch.stack([tile % ntx, tile // ntx], 1).to(torch.float32) \
        * TILE
    packed = pack_attrs(rows["mean2d"], rows["conic"], rows["color"],
                        rows["opacity"])
    attrs, depth, rslot, dropped = _exchange(packed, rows["depth"], gid,
                                             owner, slot, offset, mesh,
                                             exchange_capacity)
    # the received pair sits at slot * TILE on the owner's canvas
    shift = torch.zeros_like(attrs[:, :2])
    shift[:, 0] = rslot.to(torch.float32) * TILE
    attrs = torch.cat([attrs[:, :2] + shift, attrs[:, 2:]], dim=1)
    rgb, final_t = _composite_received(attrs, depth, rslot, tpd, TILE,
                                       tpd * TILE)
    # (TILE, tpd * TILE, 4) -> this rank's tiles (tpd, TILE, TILE, 4)
    tiles = torch.cat([rgb, final_t[..., None]], -1).reshape(
        TILE, tpd, TILE, 4).transpose(0, 1)
    every = comm.all_gather(tiles, mesh.model_group).reshape(
        n_model * tpd, TILE, TILE, 4)
    # static un-permutation: canvas tile t is owner(t)'s slot(t)
    t_owner, t_slot = _owner_slot(np.arange(num_tiles), ntx, n_model)
    idx = torch.as_tensor(t_owner * tpd + t_slot, device=dev)
    canvas = every[idx].reshape(bl, v, nty_band, ntx, TILE, TILE, 4)
    canvas = canvas.permute(0, 1, 2, 4, 3, 5, 6).reshape(
        bl, v, band_h, ntx * TILE, 4)[:, :, :height, :width]
    rgb, final_t = canvas[..., :3], canvas[..., 3]
    rgb = rgb + final_t[..., None] * background[:, None, None, None, :]
    exchange_pairs, overflow = _evidence(attrs.shape[0], dropped, dev, mesh)
    return {"comp_rgb": rgb, "comp_mask": 1.0 - final_t, "final_t": final_t,
            "overflow": overflow, "exchange_pairs": exchange_pairs}
