"""Shared helpers of the PyTorch-port parity tests: JAX <-> torch
conversion, seeded parameter noise, and the JAX -> port config mapping.

Inputs are made with numpy and handed to both packages; JAX stays on the
CPU (tests/conftest.py) and the port runs with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from guassianhand_tpu.compat.torch_port import (merge_ported,
                                                port_reference_checkpoint)

from guassianhand_tpu_torch.compat.from_jax import load_jax_params
from guassianhand_tpu_torch.models.one_shot import OneShotConfig as TOneShotConfig
from guassianhand_tpu_torch.ops.common import TILE
from guassianhand_tpu_torch.ops.rasterize import RasterizeConfig as TRasterizeConfig
from guassianhand_tpu_torch.render.renderer import RendererConfig as TRendererConfig

# Tolerances of the forward rasterizer tests (tests/test_rasterize.py).
RASTER_ATOL = 2e-5
RASTER_RTOL = 1e-4
# Tolerances of the module tests: the fp32 rounding of matmuls and
# reductions that XLA and PyTorch order differently.
MODULE_ATOL = 2e-5
MODULE_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's test modules run torch on one thread. The suite runs in
    parallel worker processes, and torch's default of a thread per core in
    each of them oversubscribes the CPU: every parallel op then waits for
    threads that other workers keep off the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def close(got, want, atol=MODULE_ATOL, rtol=MODULE_RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def carried(flax_module, torch_module, *args, seed=0, **kw):
    """Seeded numpy parameters in the layout of ``flax_module``'s params
    (no zero leaf), loaded into ``torch_module``; returns them."""
    shapes = jax.eval_shape(functools.partial(flax_module.init, **kw),
                            jax.random.PRNGKey(0), *args)
    params = random_params(shapes, seed)
    load_jax_params(torch_module, params)
    return params


def japply(flax_module, params, *args, **kw):
    """``flax_module.apply`` compiled: eager flax dispatch is slower."""
    return jax.jit(functools.partial(flax_module.apply, **kw))(params, *args)


def randn(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


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


def jax_layout(model, shapes, backbone_layers: int = 1):
    """The port model's state_dict in the JAX params layout, through the
    JAX package's reference-checkpoint converter, over a zero tree of the
    JAX model's structure ``shapes``. Returns (params, converter
    leftovers)."""
    ported, unmapped = port_reference_checkpoint(
        model.state_dict(), backbone_layers=backbone_layers)
    # the converter emits an empty subtree for the point-cloud generator
    # that the one-shot model does not have
    ported = {k: v for k, v in ported.items() if not (isinstance(v, dict)
                                                      and not v)}
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    merged, skipped = merge_ported(zeros, ported)
    return to_numpy_tree(merged), unmapped + skipped
