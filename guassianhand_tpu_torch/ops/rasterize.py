"""Differentiable 3DGS rasterization (counterpart of ``ops/rasterize.py``).

  project (PyTorch, or the fused CUDA kernels of ``ops/projection_cuda.py``
  with ``projection_impl="pallas"``)  ->  bin (exact pair enumeration +
  stable sort)  ->  composite (CUDA kernels on the card,
  ``ops/rasterize_cuda.py``)

The composite is a ``torch.autograd.Function`` over the packed per-Gaussian
attributes: its forward runs the forward kernel in training mode, its
backward the backward kernel and then the sorted-segment reduction
(``ops/segreduce_cuda.py``) that sums the per-pair gradients per Gaussian.
Gradients reach means, scales, rotations, opacities and colours through the
projection and SH code by plain autograd, as the JAX package's do. Without
grad (rendering) the forward kernel runs in render mode alone.

The mask render equals ``1 - final_T`` of the same pass. The JAX package's
static caps (tiles per Gaussian, pair budget, blocks per tile) do not exist
here: every pair is binned, so ``overflow`` is always 0; the key stays so
that callers match.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from guassianhand_tpu_torch.core import sh as sh_lib
from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.core.gaussians import Gaussians
from guassianhand_tpu_torch.ops.binning import bin_gaussians
from guassianhand_tpu_torch.ops.common import TILE
from guassianhand_tpu_torch.ops.projection import project_gaussians
from guassianhand_tpu_torch.ops.projection_cuda import project_gaussians_pallas
from guassianhand_tpu_torch.ops.rasterize_cuda import (composite_backward,
                                                       composite_forward,
                                                       pack_attrs)
from guassianhand_tpu_torch.ops.segreduce_cuda import segment_reduce_sorted


PROJECTIONS = {"xla": project_gaussians, "pallas": project_gaussians_pallas}


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    scale_modifier: float = 1.0
    znear: float = 0.01
    zfar: float = 1000.0
    # "xla" (default): the plain PyTorch projection of ops/projection.py,
    # differentiated by autograd; "pallas": the fused projection kernels and
    # their hand-derived adjoint (ops/projection_cuda.py). The values are
    # the JAX package's, so that its config dicts load unchanged.
    projection_impl: str = "xla"
    # The JAX package's TPU layout keys, accepted so that its configs load,
    # with no effect here:
    # - opacity_cull: the port always applies the exact cull
    #   (ops/common.opacity_cull_keep), which changes no pixel; off, JAX
    #   bins the whole 3-sigma rect, the same image from more pairs;
    # - pack_rgb, walk_cells, max_tiles_per_gaussian, max_blocks_per_tile,
    #   pairs_per_gaussian: the port bins every (Gaussian, tile) pair
    #   exactly with dynamic shapes (no tile, block or pair caps, no cell
    #   walk) and keeps colours in float32 (no packed rgb lane);
    # - tile_size, block_size: the image does not depend on them; the
    #   port's tile stays ops/common.TILE (16), the composite kernel's CTA;
    # - sort_stable: the port's pair sort is always stable, which is one
    #   valid order of an unstable sort on exact depth ties;
    # - grad_segsort, segreduce_pallas, segreduce_window, segreduce_chunk:
    #   they choose only the order in which pair gradients are summed per
    #   Gaussian; the sorted segment sum (ops/segreduce_cuda.py) always runs;
    # - interpret (Pallas' interpreter): a CPU tensor always goes to a
    #   kernel's plain twin.
    opacity_cull: bool = True
    tile_size: int = 16
    block_size: int = 128
    max_tiles_per_gaussian: int = 16
    max_blocks_per_tile: int = 64
    pairs_per_gaussian: float = 4.5
    sort_stable: bool = True
    pack_rgb: bool = False
    grad_segsort: bool = True
    segreduce_pallas: bool = False
    segreduce_window: int = 256
    segreduce_chunk: int = 512
    walk_cells: int = 0
    interpret: bool = False

    def __post_init__(self):
        if self.projection_impl not in PROJECTIONS:
            raise ValueError(f"projection_impl must be one of "
                             f"{sorted(PROJECTIONS)}, got "
                             f"{self.projection_impl!r}")


def _project(gaussians: Gaussians, camera: Camera, config: RasterizeConfig):
    return PROJECTIONS[config.projection_impl](
        gaussians.xyz, gaussians.scaling, gaussians.rotation, camera,
        scale_modifier=config.scale_modifier, znear=config.znear,
        zfar=config.zfar)


def _colors(gaussians: Gaussians, camera: Camera, sh_degree: int,
            use_rgb: bool) -> torch.Tensor:
    if use_rgb:
        return gaussians.shs[:, 0, :]
    dirs = gaussians.xyz - camera.camera_center()[None, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-9)
    return sh_lib.eval_sh(sh_degree, gaussians.shs, dirs)


class Composite(torch.autograd.Function):
    """(rgb, final_t) of the binned pairs, differentiable in ``attrs``
    (N, 9) (``pack_attrs``' layout)."""

    @staticmethod
    def forward(ctx, attrs, tile_range, pair_gid, height, width):
        rgb, final_t, n_contrib, checkpoints, slot_base = composite_forward(
            tile_range, pair_gid, attrs, height=height, width=width,
            store_contrib=True)
        # the pairs in Gaussian order, for the backward's reduction
        order = torch.argsort(pair_gid, stable=True).to(torch.int32)
        ctx.save_for_backward(attrs, tile_range, pair_gid, rgb, final_t,
                              n_contrib, checkpoints, slot_base, order)
        ctx.size = (height, width)
        return rgb, final_t

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_rgb, grad_t):
        (attrs, tile_range, pair_gid, rgb, final_t, n_contrib, checkpoints,
         slot_base, order) = ctx.saved_tensors
        height, width = ctx.size
        # an output with no gradient arrives as zeros (materialize_grads)
        pair_grads = composite_backward(
            tile_range, pair_gid, attrs, grad_rgb.contiguous(),
            grad_t.contiguous(), rgb, final_t, n_contrib, checkpoints,
            slot_base, height=height, width=width)
        # summed per Gaussian in the stable order, read through it
        grad_attrs = segment_reduce_sorted(pair_gid, pair_grads,
                                           attrs.shape[0], order=order)
        return grad_attrs, None, None, None, None


@dataclasses.dataclass(frozen=True)
class CompositeInputs:
    """What the composite kernel reads: the binned pairs and the packed
    per-Gaussian rows, for a canvas of height x width pixels."""

    tile_range: torch.Tensor
    pair_gid: torch.Tensor
    attrs: torch.Tensor
    height: int
    width: int

    def composite(self):
        """(rgb (H, W, 3), final_t (H, W)): through ``Composite`` when a
        gradient is wanted, else the render-mode forward alone."""
        if torch.is_grad_enabled() and self.attrs.requires_grad:
            return Composite.apply(self.attrs, self.tile_range,
                                   self.pair_gid, self.height, self.width)
        return composite_forward(self.tile_range, self.pair_gid, self.attrs,
                                 height=self.height, width=self.width)


def composite_inputs(mean2d, conic, color, opacity, depth, radius, visible,
                     *, height: int, width: int,
                     y_band=None) -> CompositeInputs:
    # the exact opacity cull changes no output and keeps the pair count down
    bins = bin_gaussians(mean2d, depth, radius, visible, height=height,
                         width=width, y_band=y_band, opacity=opacity)
    return CompositeInputs(bins.tile_range, bins.pair_gid,
                           pack_attrs(mean2d, conic, color, opacity),
                           height, width)


def _background(background, device) -> torch.Tensor:
    if background is None:
        return torch.zeros(3, dtype=torch.float32, device=device)
    return torch.as_tensor(background, dtype=torch.float32, device=device)


def rasterize(gaussians: Gaussians, camera: Camera, *, height: int,
              width: int, background: Optional[torch.Tensor] = None,
              sh_degree: int = 3, use_rgb: bool = False,
              config: RasterizeConfig = RasterizeConfig()):
    """Render one view. Returns comp_rgb (H, W, 3), comp_mask (H, W),
    final_t (H, W), radii (N,), n_pairs and overflow."""
    dev = gaussians.xyz.device
    background = _background(background, dev)
    opacity = gaussians.effective_opacity()[:, 0]
    proj = _project(gaussians, camera, config)
    color = _colors(gaussians, camera, sh_degree, use_rgb)
    inputs = composite_inputs(
        proj.mean2d, proj.conic, color, opacity, proj.depth, proj.radius,
        proj.visible, height=height, width=width)
    rgb, final_t = inputs.composite()
    rgb = rgb + final_t[..., None] * background[None, None, :]
    return {
        "comp_rgb": rgb,
        "comp_mask": 1.0 - final_t,
        "final_t": final_t,
        "radii": proj.radius,
        "n_pairs": inputs.pair_gid.shape[0],
        "overflow": 0,
    }


def render_gaussians(gaussians, w2c, K, *, height, width, **kwargs):
    """``rasterize`` with the camera built from (w2c, K)."""
    cam = Camera.from_w2c(w2c, K, height, width, device=gaussians.xyz.device)
    return rasterize(gaussians, cam, height=height, width=width, **kwargs)


def project_views(gaussians: Gaussians, w2cs: torch.Tensor, Ks: torch.Tensor,
                  *, height: int, width: int, sh_degree: int = 3,
                  use_rgb: bool = False,
                  config: RasterizeConfig = RasterizeConfig(),
                  first_band: int = 0) -> dict:
    """The rows of V views of the N Gaussians on a stacked canvas of
    H_band-row bands (tile-row aligned): view v's rows are band
    first_band + v, their means offset by that band's first pixel row and
    their tile rects clamped to it (``band_lo``). Returns the V * N rows'
    mean2d, conic, color, opacity, depth, radius, visible and band_lo."""
    dev = gaussians.xyz.device
    v = w2cs.shape[0]
    nty_band = -(-height // TILE)
    band_h = nty_band * TILE
    opacity = gaussians.effective_opacity()[:, 0]
    cams = [Camera.from_w2c(w2cs[i], Ks[i], height, width, device=dev)
            for i in range(v)]
    color = torch.cat([_colors(gaussians, cam, sh_degree, use_rgb)
                       for cam in cams])
    if config.projection_impl == "pallas":
        # every view from one launch of the fused kernel: (V, N, ...)
        p = PROJECTIONS["pallas"](
            gaussians.xyz, gaussians.scaling, gaussians.rotation, cams,
            scale_modifier=config.scale_modifier, znear=config.znear,
            zfar=config.zfar)
        band = (torch.arange(v, dtype=torch.float32, device=dev)
                + first_band) * band_h
        mean2d = torch.stack([p.mean2d[..., 0],
                              p.mean2d[..., 1] + band[:, None]], dim=-1)
        mean2d, conic, depth, radius, visible = (
            t.flatten(0, 1) for t in (mean2d, p.conic, p.depth, p.radius,
                                      p.visible))
    else:
        projs = [_project(gaussians, cam, config) for cam in cams]
        mean2d = torch.cat([torch.stack(
            [p.mean2d[:, 0],
             p.mean2d[:, 1] + float((first_band + i) * band_h)],
            dim=1) for i, p in enumerate(projs)])
        conic, depth, radius, visible = (
            torch.cat([getattr(p, k) for p in projs])
            for k in ("conic", "depth", "radius", "visible"))
    band_lo = torch.repeat_interleave(
        (torch.arange(v, dtype=torch.int32, device=dev) + first_band)
        * nty_band, gaussians.n)
    return {"mean2d": mean2d, "conic": conic, "color": color,
            "opacity": opacity.repeat(v), "depth": depth, "radius": radius,
            "visible": visible, "band_lo": band_lo}


def multiview_composite_inputs(gaussians: Gaussians, w2cs: torch.Tensor,
                               Ks: torch.Tensor, *, height: int, width: int,
                               sh_degree: int = 3, use_rgb: bool = False,
                               config: RasterizeConfig = RasterizeConfig()
                               ) -> CompositeInputs:
    """The composite inputs of V views stacked vertically on one
    (V * H_band, W) canvas (``project_views``' rows)."""
    rows = project_views(gaussians, w2cs, Ks, height=height, width=width,
                         sh_degree=sh_degree, use_rgb=use_rgb, config=config)
    band_lo = rows.pop("band_lo")
    nty_band = -(-height // TILE)
    return composite_inputs(
        **rows, height=w2cs.shape[0] * nty_band * TILE, width=width,
        y_band=(band_lo, band_lo + nty_band))


def rasterize_multiview(gaussians: Gaussians, w2cs: torch.Tensor,
                        Ks: torch.Tensor, *, height: int, width: int,
                        background: Optional[torch.Tensor] = None,
                        sh_degree: int = 3, use_rgb: bool = False,
                        config: RasterizeConfig = RasterizeConfig()):
    """Render V views with ONE binning and ONE composite launch over the
    stacked canvas of ``multiview_composite_inputs``.

    w2cs (V, 4, 4); Ks (V, 3, 3) or (V, 4, 4). Returns comp_rgb
    (V, H, W, 3), comp_mask / final_t (V, H, W), n_pairs, overflow."""
    background = _background(background, gaussians.xyz.device)
    v = w2cs.shape[0]
    inputs = multiview_composite_inputs(
        gaussians, w2cs, Ks, height=height, width=width, sh_degree=sh_degree,
        use_rgb=use_rgb, config=config)
    rgb, final_t = inputs.composite()
    band_h = inputs.height // v
    rgb = rgb + final_t[..., None] * background[None, None, :]
    rgb = rgb.reshape(v, band_h, width, 3)[:, :height]
    final_t = final_t.reshape(v, band_h, width)[:, :height]
    return {
        "comp_rgb": rgb,
        "comp_mask": 1.0 - final_t,
        "final_t": final_t,
        "n_pairs": inputs.pair_gid.shape[0],
        "overflow": 0,
    }
