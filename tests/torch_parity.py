"""Shared helpers of the PyTorch-port parity tests: JAX <-> torch
conversion, seeded parameter noise, the JAX -> port config mapping, and the
few-step TINY fit run by both packages (``fit_against_jax``).

Inputs are made with numpy and handed to both packages; JAX stays on the
CPU (tests/conftest.py) and the port runs with ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.compat.torch_port import (merge_ported,
                                                port_reference_checkpoint)

from guassianhand_tpu_torch.compat.from_jax import (identity_code_infer_to_jax,
                                                    load_jax_params)
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


# the scaled tolerance of the point-cloud generator's modules: the rounding
# of matmuls and reductions that XLA and PyTorch order apart, relative to
# the output's scale
RTOL_SCALED = 1e-4


def scaled_close(got, want, rtol: float = RTOL_SCALED) -> None:
    """max |got - want| <= rtol * max(1, max |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * max(1.0, float(np.max(np.abs(want)))), err


def positive_variances(params):
    """The frozen BatchNorms' ``var`` leaves moved into [0.5, 1.5]."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        return 0.5 + np.abs(x) % 1.0 if name == "var" else x
    return jax.tree_util.tree_map_with_path(leaf, params)


def carry(jmodule, tmodule, *args, seed=0):
    """Seeded parameters of ``jmodule`` (for ``args``) in both modules."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *args)
    params = positive_variances(random_params(shapes, seed))
    load_jax_params(tmodule, params)
    return params


def hf_dinov2(width: int = 64, layers: int = 2, seed: int = 9) -> dict:
    """A seeded state dict in the Hugging Face ``Dinov2Model`` layout (as
    tests/test_compat.py::test_port_dinov2_backbone builds one), keys
    prefixed ``dinov2.`` as a ``Dinov2ForImageClassification`` stores them,
    with its mask token and one key no model has."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    sd = {"embeddings.cls_token": r(1, 1, width),
          "embeddings.mask_token": r(1, width),
          "embeddings.position_embeddings": r(1, 257, width),
          "embeddings.patch_embeddings.projection.weight": r(width, 3, 14, 14)
          / 24.0,
          "embeddings.patch_embeddings.projection.bias": r(width),
          "layernorm.weight": r(width), "layernorm.bias": r(width),
          "classifier.weight": r(10, width)}
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for name, shape in (("attention.attention.query", (width, width)),
                            ("attention.attention.key", (width, width)),
                            ("attention.attention.value", (width, width)),
                            ("attention.output.dense", (width, width)),
                            ("mlp.fc1", (4 * width, width)),
                            ("mlp.fc2", (width, 4 * width))):
            sd[f"{p}.{name}.weight"] = r(*shape) / np.sqrt(shape[1])
            sd[f"{p}.{name}.bias"] = r(shape[0])
        for name in ("norm1", "norm2"):
            sd[f"{p}.{name}.weight"] = 1.0 + 0.1 * r(width)
            sd[f"{p}.{name}.bias"] = r(width)
        sd[f"{p}.layer_scale1.lambda1"] = r(width)
        sd[f"{p}.layer_scale2.lambda1"] = r(width)
    return {("dinov2." + k if "classifier" not in k else k): v
            for k, v in sd.items()}


def port_raster_config(cfg) -> TRasterizeConfig:
    assert cfg.opacity_cull, "the port always applies the exact opacity cull"
    assert cfg.tile_size == TILE, f"the port composites {TILE}-pixel tiles"
    return TRasterizeConfig(scale_modifier=cfg.scale_modifier,
                            znear=cfg.znear, zfar=cfg.zfar,
                            projection_impl=cfg.projection_impl)


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
    leftovers). The identity-code head, which the reference converter does
    not know, is carried by ``identity_code_infer_to_jax``, and only where
    ``shapes`` has it (a JAX model initialised with infer_identity=True)."""
    head = "identity_code_infer"
    ported, unmapped = port_reference_checkpoint(
        {k: v for k, v in model.state_dict().items()
         if not k.startswith(head + ".")}, backbone_layers=backbone_layers)
    # the converter emits an empty subtree for the point-cloud generator
    # that the one-shot model does not have
    ported = {k: v for k, v in ported.items() if not (isinstance(v, dict)
                                                      and not v)}
    inner = shapes["params"] if "params" in shapes else shapes
    if head in inner:
        ported[head] = identity_code_infer_to_jax(model.identity_code_infer)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    merged, skipped = merge_ported(zeros, ported)
    return to_numpy_tree(merged), unmapped + skipped


def leaf_names(tree):
    def name(p):
        return str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
    return {"/".join(name(p) for p in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@contextlib.contextmanager
def environ(**values):
    """os.environ with ``values`` set, restored afterwards."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fit_against_jax(jcfg, tiny, hw: int, steps: int, port_env=None,
                    forward_kw=None, lr: float = 0.01, vgg: float = 0.1,
                    batch=None):
    """``steps`` fit steps (one update each, learning rate ``lr``, VGG
    weight ``vgg``) of each package from the same parameters on the same
    batch, at the JAX model config ``jcfg`` (the port gets
    ``port_model_config(tiny)`` with ``jcfg``'s raster switches), each
    forward with the options ``forward_kw`` (the edit fit's ``edit`` and
    ``identity_from_book``, given as the port's ``EditConfig``); the port's
    steps run under the environment ``port_env``. Both get the JAX
    package's batch: ``batch`` (numpy arrays of the model's and the
    targets' keys) or the synthetic scene's (the points' last-ulp LBS
    differences would otherwise
    flip a few points of the interaction mask, ROADMAP.md Queue C) and the
    port's seeded init carried into the JAX layout, with seeded noise on
    every leaf. Returns the parameters, the losses and error terms of both,
    Adam's first moments after the first step, the JAX parameters after the
    last and the port model."""
    from guassianhand_tpu.data.synthetic import SyntheticHandScene as JScene
    from guassianhand_tpu.data.synthetic import synthetic_batch as j_batch
    from guassianhand_tpu.models.one_shot import OneShotAvatarModel as JModel
    from guassianhand_tpu.train import fit as jfit
    from guassianhand_tpu.train import losses as jlosses
    from guassianhand_tpu.train import vgg as jvgg
    from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
    from guassianhand_tpu_torch.train import losses
    from guassianhand_tpu_torch.train.fit import (FitConfig,
                                                  attach_static_features,
                                                  lr_schedule, make_fit_step,
                                                  make_optimizer)
    from guassianhand_tpu_torch.train.vgg import VGGLoss

    from guassianhand_tpu.render.renderer import EditConfig as JEditConfig
    fit_kw = dict(steps_per_epoch=1, epochs=steps, lr=lr)
    forward_kw = dict(forward_kw or {})
    j_forward_kw = dict(forward_kw)
    if "edit" in forward_kw:
        j_forward_kw["edit"] = JEditConfig(
            **dataclasses.asdict(forward_kw["edit"]))
    if batch is None:
        jscene = JScene.build(n_vertices=96, subdivide=1, height=hw,
                              width=hw)
        batch = {k: np.asarray(v) for k, v in jax.jit(lambda: j_batch(
            jscene, seed=0, raster=jcfg.renderer.raster))().items()}
    jm = JModel(cfg=jcfg)
    shapes = jax.eval_shape(lambda k, b: jm.init(k, b, hw, hw),
                            jax.random.PRNGKey(0), batch)
    tcfg_model = port_model_config(dataclasses.replace(
        tiny, renderer=dataclasses.replace(
            tiny.renderer, raster=jcfg.renderer.raster)))
    seeded = OneShotAvatarModel(tcfg_model)
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    params, leftovers = jax_layout(seeded, shapes)
    # every leaf of the JAX tree is carried over
    assert leftovers == []
    # seed 21 (as in test_torch_model.py): with other noise some cell of
    # the texture pointnet's max-pool can hold two inputs equal to the last
    # bits, which the packages break differently, routing that point's
    # gradient elsewhere (seen with seed 22: 3 points' identity-code texels)
    params = perturb(params, 21)

    jcfg_fit = jfit.FitConfig(weights=jlosses.LossWeights(vgg=vgg), **fit_kw)
    jparams = jax.tree.map(jnp.asarray, params)
    optimizer = jfit.make_optimizer(jparams, jcfg_fit)
    opt_state = optimizer.init(jparams)
    step = jfit.make_fit_step(
        lambda p, b: jm.apply(p, b, hw, hw, **j_forward_kw),
        jvgg.VGGLoss() if vgg else None, optimizer, jcfg_fit)
    jb = jfit.attach_static_features(jm, jparams,
                                     jax.tree.map(jnp.asarray, batch))
    j_losses, j_errs = [], []
    for i in range(steps):
        jparams, opt_state, loss, err = step(jparams, opt_state, jb)
        j_losses.append(float(loss))
        j_errs.append({k: float(v) for k, v in err.items()})
        if i == 0:
            j_mu = {k.split("/")[-1]: np.asarray(v)
                    for k, v in leaf_names(opt_state).items() if "/mu/" in k}

    model = OneShotAvatarModel(tcfg_model).eval()
    load_jax_params(model, params)
    tcfg = FitConfig(weights=losses.LossWeights(vgg=vgg), **fit_kw)
    opt, sched = make_optimizer(model, tcfg)
    tstep = make_fit_step(model, VGGLoss() if vgg else None, opt, sched, tcfg,
                          height=hw, width=hw, forward_kw=forward_kw)
    t_losses, t_errs = [], []
    with environ(**(port_env or {})):
        tb = attach_static_features(model, batch_to_torch(batch))
        for i in range(steps):
            loss, err = tstep(tb)
            t_losses.append(float(loss))
            t_errs.append({k: float(v) for k, v in err.items()})
            if i == 0:
                t_mu = {n: opt.state[p]["exp_avg"].clone()
                        for n, p in model.named_parameters()
                        if p in opt.state}
    return {"params": params, "shapes": shapes, "batch": batch,
            "j_losses": j_losses, "j_errs": j_errs, "j_mu": j_mu,
            "j_after": {k.split("/")[-1]: np.asarray(v) for k, v in
                        leaf_names(jparams).items()},
            "t_losses": t_losses, "t_errs": t_errs, "t_mu": t_mu,
            "model": model, "lrs": [lr_schedule(tcfg)(i)
                                    for i in range(steps)]}
