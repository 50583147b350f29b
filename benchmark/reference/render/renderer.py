"""Gaussian renderer head (a frozen copy of the program's
``render/renderer.py``): validity and duplication into 2N static slots, the
UV appearance residuals, and the multi-view render.

- validity: slot i < N keeps point i when its score > threshold_low; slot
  N + i holds its refined duplicate when the score > threshold_high;
  invalid slots stay in place with opacity 0;
- appearance: ``color_w`` gain/bias, the ``color_b`` map sampled at the
  Gaussians' UVs (only its first rgb triple is read, so the 48-channel and
  the narrow 3-channel layouts give the same result), ``opacity_b`` and
  ``xyz_b``, under the texture-edit flags of ``EditConfig``;
- views: one stacked multi-view raster, one binning and one composite
  launch for all views;
- ``exact_duplicate_uv``: every point's UV (the refined duplicates' too)
  re-projected through the posed UV mesh (``mano/uv.py::get_uvd``) where
  the caller passes it, as the reference does each forward; off by
  default, where the duplicates reuse their parent's UV.

The interaction attention ``self_attn_layer`` lives here, as in the
reference module tree; the model calls it before rendering, and it alone
takes the model's compute dtype: everything the renderer computes itself
is float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from benchmark.reference.core.gaussians import Gaussians
from benchmark.reference.mano.uv import get_uvd, normalize_uv
from benchmark.reference.nn.heads import (GSLayer, SelfAttn, VertPosRefinement,
                                             VertValid)
from benchmark.reference.nn.mlp import MLP
from benchmark.reference.ops.grid_sample import grid_sample_2d
from benchmark.reference.ops.rasterize import (RasterizeConfig,
                                                  rasterize_multiview)


@dataclasses.dataclass(frozen=True)
class EditConfig:
    """Texture-edit flags (the JAX package's ``render/renderer.py::
    EditConfig``), read by ``GSRenderer.apply_appearance``. In the packed
    atlas the left half (u < 0.5) is the right hand."""

    # per-hand color_w pairs: the right hand's gain and bias are cw[0] and
    # cw[1], the left hand's cw[2] and cw[3]
    enabled: bool = False
    # color_b zeroed on the right hand
    edit_left_only: bool = False
    # the right hand samples color_b at u + 0.5 (the left hand's texture)
    # and both hands take the left hand's color_w pair
    duplication: bool = False


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    hidden_dim: int = 128
    feature_dim: int = 131       # 80 scene-code + 51 additional channels
    threshold_low: float = 0.1
    threshold_high: float = 0.9
    sh_degree: int = 3
    use_rgb: bool = True
    # accepted so that the JAX package's configs load, with no effect here:
    # JAX's per-view route (False) renders what the stacked canvas renders
    multiview_batched: bool = True
    # render through the Gaussian->tile all_to_all exchange
    # (parallel/raster_shard.py::sharded_rasterize_batch) while a mesh is
    # published with parallel/mesh.py::use_exchange_mesh (the sharded fit
    # step does so when the model axis is wider than 1); otherwise warn and
    # render unsharded
    sharded_exchange: bool = False
    # raise instead of warning when sharded_exchange is set and no mesh is
    # published: a validation run then cannot pass on the unsharded path
    sharded_exchange_required: bool = False
    # per-(src, dst) pair budget of the exchange; None: lossless (every live
    # pair travels). Pairs beyond it are dropped and counted in overflow;
    # exchange_balance_stats()["suggested_capacity"] is a safe value
    exchange_capacity: Optional[int] = None
    # re-project all 2N points' UVs through the posed UV mesh (tri_xyz
    # (F, 3, 3), tri_uv (F, 3, 2)) with get_uvd: O(N F) a forward
    exact_duplicate_uv: bool = False
    raster: RasterizeConfig = RasterizeConfig()


class GSRenderer(nn.Module):
    def __init__(self, cfg: RendererConfig = RendererConfig(),
                 interaction_cap: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.mlp_net = MLP(cfg.feature_dim, cfg.hidden_dim, cfg.hidden_dim,
                           n_hidden_layers=2, activation="silu")
        self.gs_net = GSLayer(cfg.hidden_dim, sh_degree=cfg.sh_degree,
                              use_rgb=cfg.use_rgb)
        self.gs_valid = VertValid(cfg.feature_dim + 3)
        self.vert_pos_refinement = VertPosRefinement(cfg.feature_dim + 3)
        self.self_attn_layer = SelfAttn(cfg.feature_dim, cap=interaction_cap,
                                        compute_dtype=compute_dtype)

    def build_gaussians(self, features: torch.Tensor, points: torch.Tensor,
                        vert_uv: torch.Tensor, tri_xyz=None, tri_uv=None):
        """features (N, C), points (N, 3), vert_uv (N, 2) packed-atlas UVs.
        Returns (Gaussians with 2N slots and validity, uv (2N, 2)); the
        duplicates reuse their parent's UV (the refinement moves a point by
        at most 1e-3, below one texel), unless ``exact_duplicate_uv`` is on
        and the posed UV mesh ``tri_xyz`` (F, 3, 3), ``tri_uv`` (F, 3, 2) is
        given: then all 2N UVs come from ``get_uvd``."""
        score = self.gs_valid(features, points)[:, 0]
        keep = score > self.cfg.threshold_low
        dup = score > self.cfg.threshold_high
        refined = self.vert_pos_refinement(features, points)

        gs = self.gs_net(self.mlp_net(torch.cat([features, features], 0)),
                         torch.cat([points, refined], 0))
        valid = torch.cat([keep, dup], 0).to(torch.float32)
        gs = dataclasses.replace(gs, valid=valid)
        if self.cfg.exact_duplicate_uv and tri_xyz is not None:
            return gs, get_uvd(gs.xyz, tri_xyz, tri_uv)[0]
        return gs, torch.cat([vert_uv, vert_uv], 0)

    @staticmethod
    def apply_appearance(gs: Gaussians, uv: torch.Tensor,
                         color_w: Optional[torch.Tensor],
                         xyz_b: Optional[torch.Tensor],
                         color_b_map: Optional[torch.Tensor],
                         opacity_b_map: Optional[torch.Tensor],
                         edit: EditConfig = EditConfig()) -> Gaussians:
        """color_w (48,): the first two rgb triples are gain and bias (with
        ``edit.enabled`` the first four, a pair for each hand);
        color_b_map (48 or 3, Hm, Wm); opacity_b_map (1, Hm, Wm); xyz_b (3,).
        ``edit.duplication`` shifts only the colour map's sample, not the
        opacity map's."""
        uvn = normalize_uv(uv)
        rgb = gs.shs[:, 0, :]
        right = uv[:, 0] < 0.5
        uvn_color = uvn
        if edit.duplication:
            shifted = torch.stack([uvn[:, 0] + 1.0, uvn[:, 1]], dim=1)
            uvn_color = torch.where(right[:, None], shifted, uvn)
        if color_w is not None:
            cw = color_w.reshape(16, 3)
            if edit.enabled:
                left_pair = (~right[:, None]) | edit.duplication
                gain = torch.where(left_pair, cw[2][None], cw[0][None])
                bias = torch.where(left_pair, cw[3][None], cw[1][None])
            else:
                gain, bias = cw[0][None], cw[1][None]
            rgb = rgb * gain + bias - 1.0
        if color_b_map is not None:
            cb = grid_sample_2d(color_b_map[:3], uvn_color)
            if edit.edit_left_only:
                cb = cb * (~right)[:, None].to(cb.dtype)
            rgb = rgb + cb
        opacity = gs.opacity
        if opacity_b_map is not None:
            opacity = opacity + grid_sample_2d(opacity_b_map, uvn)
        xyz = gs.xyz if xyz_b is None else gs.xyz + xyz_b[None, :]
        return Gaussians(xyz=xyz, opacity=opacity, rotation=gs.rotation,
                         scaling=gs.scaling, shs=rgb[:, None, :],
                         valid=gs.valid)

    def render_views(self, gs: Gaussians, w2cs: torch.Tensor, Ks: torch.Tensor,
                     height: int, width: int,
                     background: Optional[torch.Tensor] = None):
        """w2cs (V, 4, 4), Ks (V, 3/4, 3/4) -> comp_rgb (V, H, W, 3),
        comp_mask (V, H, W), n_pairs, overflow."""
        cfg = self.cfg
        out = rasterize_multiview(
            gs, w2cs, Ks, height=height, width=width, background=background,
            use_rgb=cfg.use_rgb, config=cfg.raster, work=True)
        return {k: out[k] for k in ("comp_rgb", "comp_mask", "n_pairs",
                                    "work")}

    def forward(self, features, points, vert_uv, w2cs, Ks, *, height: int,
                width: int, background=None, color_w=None, xyz_b=None,
                color_b_map=None, opacity_b_map=None,
                edit: EditConfig = EditConfig(), tri_xyz=None, tri_uv=None):
        """One sample; the model loops over its batch."""
        gs, uv = self.build_gaussians(features, points, vert_uv, tri_xyz,
                                      tri_uv)
        gs = self.apply_appearance(gs, uv, color_w, xyz_b, color_b_map,
                                   opacity_b_map, edit)
        out = self.render_views(gs, w2cs, Ks, height, width, background)
        out["3dgs"] = gs
        return out
