"""Shared helpers of the PyTorch-port parity tests: JAX <-> torch
conversion, seeded parameter noise, and the JAX -> port config mapping.

Inputs are made with numpy and handed to both packages; JAX stays on the
CPU (tests/conftest.py) and the port runs with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from guassianhand_tpu_torch.models.one_shot import OneShotConfig as TOneShotConfig
from guassianhand_tpu_torch.ops.common import TILE
from guassianhand_tpu_torch.ops.rasterize import RasterizeConfig as TRasterizeConfig
from guassianhand_tpu_torch.render.renderer import RendererConfig as TRendererConfig

# Tolerances of the forward rasterizer tests (tests/test_rasterize.py).
RASTER_ATOL = 2e-5
RASTER_RTOL = 1e-4


def to_numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def to_torch(x, dtype=None):
    """numpy/JAX array -> CPU torch tensor (a copy; JAX arrays are
    read-only)."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def batch_to_torch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def perturb(params, seed: int, scale: float = 0.05):
    """Every leaf plus seeded noise of ``scale`` times its spread (at least
    ``scale``): the zero-initialised heads and maps would otherwise hide
    mapping bugs."""
    rng = np.random.RandomState(seed)

    def one(x):
        x = np.asarray(x)
        spread = max(float(np.std(x)), 1.0)
        return (x + scale * spread * rng.normal(size=x.shape)).astype(x.dtype)

    return jax.tree.map(one, params)


def random_params(shapes, seed: int):
    """Seeded numpy values for a flax params tree of ``jax.ShapeDtypeStruct``
    leaves (from ``jax.eval_shape`` of ``init``): kernels normal with std
    1/sqrt(fan_in), norm scales 1 + noise, every other leaf small noise.
    Nothing is zero, so no mapping hides behind a zero-initialised leaf."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.normal(size=s.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.2 * x
        else:
            x = 0.2 * x
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_raster_config(cfg) -> TRasterizeConfig:
    assert cfg.opacity_cull, "the port always applies the exact opacity cull"
    assert cfg.tile_size == TILE, f"the port composites {TILE}-pixel tiles"
    return TRasterizeConfig(scale_modifier=cfg.scale_modifier,
                            znear=cfg.znear, zfar=cfg.zfar)


def port_model_config(cfg) -> TOneShotConfig:
    """The port's OneShotConfig for a JAX OneShotConfig (fp32 path)."""
    r = cfg.renderer
    renderer = TRendererConfig(
        hidden_dim=r.hidden_dim, feature_dim=r.feature_dim,
        threshold_low=r.threshold_low, threshold_high=r.threshold_high,
        sh_degree=r.sh_degree, use_rgb=r.use_rgb,
        raster=port_raster_config(r.raster))
    names = {f.name for f in dataclasses.fields(TOneShotConfig)} - {"renderer"}
    return TOneShotConfig(renderer=renderer,
                          **{k: getattr(cfg, k) for k in names})
