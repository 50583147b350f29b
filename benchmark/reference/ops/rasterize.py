"""Plain 3DGS rasterization: the projection and the binning as the port
states them, and a composite written anew.

The composite takes the binned (tile, depth)-ordered pairs and evaluates
every pixel of each pair's 16 x 16 tile at once. The front-to-back rule
(``ops/common.py``) keeps a prefix of each pixel's pairs: those whose
transmittance after them stays at or above 1e-4, skipping the pairs with
power > 0 or alpha < 1/255. The transmittance is a segmented product,
taken here as the exponential of a float64 segmented sum of log(1 - alpha)
over the pairs of a tile, so no pixel loop runs. Tiles go in blocks of at
most ``block_pairs`` pairs, so memory stays bounded at any pair count.
Differentiable by autograd; the alpha clamp at 0.99 is straight-through.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.reference.core.camera import Camera
from benchmark.reference.core.gaussians import Gaussians
from benchmark.reference.ops.binning import bin_gaussians, grid_dims
from benchmark.reference.ops.common import (ALPHA_MIN, T_EPS, TILE,
                                            straight_through_alpha)
from benchmark.reference.ops.projection import project_gaussians

BLOCK_PAIRS = 1 << 17


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    scale_modifier: float = 1.0
    znear: float = 0.01
    zfar: float = 1000.0


def _blocks(tile_range: torch.Tensor, block_pairs: int):
    """[(t0, t1)] tile blocks of at most ``block_pairs`` pairs (a tile
    with more stands alone)."""
    tr = tile_range.cpu().tolist()
    out, t0 = [], 0
    n_tiles = len(tr) - 1
    while t0 < n_tiles:
        t1 = t0 + 1
        while t1 < n_tiles and tr[t1 + 1] - tr[t0] <= block_pairs:
            t1 += 1
        out.append((t0, t1))
        t0 = t1
    return out


# fp32 operations of the front-to-back rule (a fused multiply-add two,
# expf one, a comparison one), by the stage a (pair, pixel) reaches:
# evaluated (dx, dy; the quadratic form; power > 0), past power (expf;
# alpha; alpha < 1/255), past alpha (T (1 - alpha); < 1e-4), accepted
# (w; three colour multiply-adds); and in the backward, for the pairs
# before the pixel's last contributor: the forward's gates, then for a
# live pair the 43 operations of its gradient and their sum over the tile.
OPS_EVALUATED, OPS_PAST_POWER, OPS_PAST_ALPHA, OPS_ACCEPTED = 12, 4, 3, 7
OPS_BWD_EVALUATED, OPS_BWD_PAST_POWER, OPS_BWD_LIVE = 12, 4, 43


def composite(tile_range, pair_gid, mean2d, conic, color, opacity, *,
              height: int, width: int, block_pairs: int = BLOCK_PAIRS,
              work: bool = False):
    """(rgb (H, W, 3), final_t (H, W)) of the binned pairs; with ``work``
    also {"forward_ops", "backward_ops"}: the operations the sequential
    rule needs at these inputs (each pixel's pairs through the one that
    stops it; in the backward, through its last contributor)."""
    dev = mean2d.device
    ntx, nty = grid_dims(height, width)
    n_tiles = ntx * nty
    t_pix = TILE * TILE
    oy, ox = torch.meshgrid(torch.arange(TILE, device=dev),
                            torch.arange(TILE, device=dev), indexing="ij")
    ox, oy = ox.reshape(-1).float(), oy.reshape(-1).float()
    rgb_t, logt_t = [], []
    fwd_ops = bwd_ops = 0
    for t0, t1 in _blocks(tile_range, block_pairs):
        p0, p1 = int(tile_range[t0]), int(tile_range[t1])
        counts = (tile_range[t0 + 1:t1 + 1] - tile_range[t0:t1]).long()
        nt = t1 - t0
        if p1 == p0:
            rgb_t.append(torch.zeros(nt, t_pix, 3, device=dev))
            logt_t.append(torch.zeros(nt, t_pix, device=dev,
                                      dtype=torch.float64))
            continue
        local = torch.repeat_interleave(torch.arange(nt, device=dev), counts)
        tile = local + t0
        gid = pair_gid[p0:p1].long()
        px = (tile % ntx).float()[:, None] * TILE + ox[None]   # (p, 256)
        py = (tile // ntx).float()[:, None] * TILE + oy[None]
        dx = mean2d[gid, 0][:, None] - px
        dy = mean2d[gid, 1][:, None] - py
        ca, cb, cc = (conic[gid, i][:, None] for i in range(3))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = straight_through_alpha(opacity[gid][:, None]
                                       * torch.exp(power))
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        g = torch.log1p(-alpha.double())
        csum = torch.cumsum(g, 0)
        first = torch.cumsum(counts, 0) - counts                 # (nt,)
        base = torch.where((first > 0)[:, None],
                           csum[(first - 1).clamp(min=0)],
                           torch.zeros_like(csum[:1]))
        log_incl = csum - base[local]
        accept = (torch.exp(log_incl.detach()) >= T_EPS)
        t_excl = torch.exp(log_incl - g).float()
        w = alpha * t_excl * accept.float()
        rgb = torch.zeros(nt, t_pix, 3, device=dev).index_add(
            0, local, w[..., None] * color[gid][:, None, :])
        logt = torch.zeros(nt, t_pix, device=dev, dtype=torch.float64) \
            .index_add(0, local, g * accept.double())
        rgb_t.append(rgb)
        logt_t.append(logt)
        if work:
            f, b = _work(local, first, counts, power <= 0.0, alpha > 0.0,
                         accept)
            fwd_ops += f
            bwd_ops += b
    rgb = torch.cat(rgb_t)                                  # (T, 256, 3)
    final_t = torch.exp(torch.cat(logt_t)).float()          # (T, 256)
    assert rgb.shape[0] == n_tiles

    def image(x):
        x = x.reshape(nty, ntx, TILE, TILE, *x.shape[2:])
        x = x.transpose(1, 2).reshape(nty * TILE, ntx * TILE, *x.shape[4:])
        return x[:height, :width]

    if work:
        return image(rgb), image(final_t), {"forward_ops": fwd_ops,
                                            "backward_ops": bwd_ops}
    return image(rgb), image(final_t)


def _work(local, first, counts, pmask, lit, accept):
    """(forward, backward) operations of one block (``composite``)."""
    with torch.no_grad():
        nt, t_pix = counts.shape[0], pmask.shape[1]
        slot = (torch.arange(local.shape[0], device=local.device)
                - first[local])[:, None]
        n_accept = torch.zeros(nt, t_pix, dtype=torch.long,
                               device=local.device).index_add(
            0, local, accept.long())
        n_eval = torch.minimum(n_accept + 1, counts[:, None])
        evaluated = slot < n_eval[local]
        fwd = (OPS_EVALUATED * evaluated.sum()
               + OPS_PAST_POWER * (evaluated & pmask).sum()
               + OPS_PAST_ALPHA * (evaluated & lit).sum()
               + OPS_ACCEPTED * (accept & lit).sum())
        contrib = torch.where(accept & lit, slot + 1, torch.zeros_like(slot))
        n_contrib = torch.zeros(nt, t_pix, dtype=torch.long,
                                device=local.device).scatter_reduce(
            0, local[:, None].expand(-1, t_pix), contrib, "amax")
        walked = slot < n_contrib[local]
        bwd = (OPS_BWD_EVALUATED * walked.sum()
               + OPS_BWD_PAST_POWER * (walked & pmask).sum()
               + OPS_BWD_LIVE * (walked & lit).sum())
        return int(fwd), int(bwd)


def _project(gaussians: Gaussians, camera: Camera, config: RasterizeConfig):
    return project_gaussians(gaussians.xyz, gaussians.scaling,
                             gaussians.rotation, camera,
                             scale_modifier=config.scale_modifier,
                             znear=config.znear, zfar=config.zfar)


def _background(background, device) -> torch.Tensor:
    if background is None:
        return torch.zeros(3, dtype=torch.float32, device=device)
    return torch.as_tensor(background, dtype=torch.float32, device=device)


def rasterize(gaussians: Gaussians, camera: Camera, *, height: int,
              width: int, background: Optional[torch.Tensor] = None,
              use_rgb: bool = True,
              config: RasterizeConfig = RasterizeConfig(),
              work: bool = False):
    """One view, colours as RGB. comp_rgb (H, W, 3), comp_mask (H, W),
    radii (N,), n_pairs; with ``work`` the composite's operations."""
    if not use_rgb:
        raise NotImplementedError("the reference renders RGB colours only")
    dev = gaussians.xyz.device
    opacity = gaussians.effective_opacity()[:, 0]
    p = _project(gaussians, camera, config)
    bins = bin_gaussians(p.mean2d, p.depth, p.radius, p.visible,
                         height=height, width=width, opacity=opacity)
    rgb, final_t, *work = composite(
        bins.tile_range, bins.pair_gid, p.mean2d, p.conic,
        gaussians.shs[:, 0, :], opacity, height=height, width=width,
        work=work)
    rgb = rgb + final_t[..., None] * _background(background, dev)
    return {"comp_rgb": rgb, "comp_mask": 1.0 - final_t, "radii": p.radius,
            "n_pairs": bins.n_pairs, "work": work[0] if work else None}


def rasterize_multiview(gaussians: Gaussians, w2cs: torch.Tensor,
                        Ks: torch.Tensor, *, height: int, width: int,
                        background: Optional[torch.Tensor] = None,
                        use_rgb: bool = True,
                        config: RasterizeConfig = RasterizeConfig(),
                        work: bool = False):
    """V views on one stacked canvas of tile-aligned bands, binned
    together. comp_rgb (V, H, W, 3), comp_mask (V, H, W), radii (V, N),
    n_pairs, n_tiles; with ``work`` the composite's operations."""
    if not use_rgb:
        raise NotImplementedError("the reference renders RGB colours only")
    dev = gaussians.xyz.device
    v, n = w2cs.shape[0], gaussians.n
    nty_band = -(-height // TILE)
    band_h = nty_band * TILE
    opacity = gaussians.effective_opacity()[:, 0]
    projs = [_project(gaussians, Camera.from_w2c(w2cs[i], Ks[i], height,
                                                 width, device=dev), config)
             for i in range(v)]
    mean2d = torch.cat([torch.stack(
        [p.mean2d[:, 0], p.mean2d[:, 1] + float(i * band_h)], dim=1)
        for i, p in enumerate(projs)])
    conic, depth, radius, visible = (torch.cat([getattr(p, k) for p in projs])
                                     for k in ("conic", "depth", "radius",
                                               "visible"))
    band_lo = torch.repeat_interleave(
        torch.arange(v, dtype=torch.int32, device=dev) * nty_band, n)
    bins = bin_gaussians(mean2d, depth, radius, visible, height=v * band_h,
                         width=width, y_band=(band_lo, band_lo + nty_band),
                         opacity=opacity.repeat(v))
    rgb, final_t, *work = composite(
        bins.tile_range, bins.pair_gid, mean2d, conic,
        gaussians.shs[:, 0, :].repeat(v, 1), opacity.repeat(v),
        height=v * band_h, width=width, work=work)
    rgb = rgb + final_t[..., None] * _background(background, dev)
    rgb = rgb.reshape(v, band_h, width, 3)[:, :height]
    final_t = final_t.reshape(v, band_h, width)[:, :height]
    return {"comp_rgb": rgb, "comp_mask": 1.0 - final_t,
            "radii": radius.reshape(v, n), "n_pairs": bins.n_pairs,
            "n_tiles": bins.tile_range.numel() - 1,
            "work": work[0] if work else None}
