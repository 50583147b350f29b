"""The PyTorch port's snowflake upsampler (``nn/snowflake.py``) held against
the JAX package's on the CPU: ``SkipTransformer``, the ``SPDpp``, ``SPD``
and ``SPDCrossAttn`` stages, the ``SnowflakeDecoder`` and PointNet++'s kNN
set abstraction and feature propagation.

Each test makes the points and the module's parameters with numpy from a
seed (no zero leaf; the frozen BatchNorms' variances in [0.5, 1.5]),
carries the parameters across with ``compat/from_jax.load_jax_params`` and
requires max |port - JAX| <= 1e-4 * max(1, max |JAX|) in float32: the
rounding of matmuls and reductions that XLA and PyTorch order apart.
"""
import numpy as np
import pytest
import torch

from guassianhand_tpu.nn import snowflake as jsf
from guassianhand_tpu_torch.nn import snowflake as sf
from tests.torch_parity import (carry, japply,  # noqa: F401
                                one_torch_thread, scaled_close, to_torch)


def points(rng, n, scale=0.3):
    return (scale * rng.normal(size=(n, 3))).astype(np.float32)


def feats(rng, n, c):
    return rng.normal(size=(n, c)).astype(np.float32)


def test_skip_transformer():
    rng = np.random.RandomState(0)
    pos, key, query = points(rng, 80), feats(rng, 80, 128), feats(rng, 80, 128)
    jm, tm = jsf.SkipTransformer(), sf.SkipTransformer()
    p = carry(jm, tm, pos, key, query)
    with torch.no_grad():
        got = tm(*(to_torch(x) for x in (pos, key, query)))
    scaled_close(got, japply(jm, p, pos, key, query))


@pytest.mark.parametrize("with_prev", [False, True])
def test_spdpp(with_prev):
    """The flagship's stage, first (no previous feature) and later."""
    rng = np.random.RandomState(1)
    pts, cond = points(rng, 60), feats(rng, 60, 128)
    prev = feats(rng, 60, 128) if with_prev else None
    jm = jsf.SPDpp(up_factor=4, i=1, radius=2.0)
    tm = sf.SPDpp(up_factor=4, i=1, radius=2.0)
    p = carry(jm, tm, pts, cond, prev)
    with torch.no_grad():
        got = tm(to_torch(pts), to_torch(cond),
                 None if prev is None else to_torch(prev))
    want = japply(jm, p, pts, cond, prev)
    for g, w in zip(got, want):
        scaled_close(g, w)


def test_spd_and_cross_attention_stages():
    """SPD (one global condition vector) and SPD_crossattn (attention over
    condition tokens of another count than the points)."""
    rng = np.random.RandomState(2)
    pts, prev = points(rng, 48), feats(rng, 48, 128)
    glob, tokens = feats(rng, 1, 128)[0], feats(rng, 20, 128)
    for jm, tm, cond in ((jsf.SPD(dim_feat=128), sf.SPD(dim_feat=128), glob),
                         (jsf.SPDCrossAttn(), sf.SPDCrossAttn(), tokens)):
        p = carry(jm, tm, pts, cond, prev, seed=3)
        with torch.no_grad():
            got = tm(to_torch(pts), to_torch(cond), to_torch(prev))
        for g, w in zip(got, japply(jm, p, pts, cond, prev)):
            scaled_close(g, w)


@pytest.mark.parametrize("spd_type", ["SPD_PP", "SPD_crossattn", "SPD"])
def test_snowflake_decoder(spd_type):
    """Two stages (2, 4) from 40 points and 24 condition rows: SPD_PP
    resamples the rows to each stage's point count by nearest index."""
    rng = np.random.RandomState(4)
    pts, cond = points(rng, 40), feats(rng, 24, 64)
    jm = jsf.SnowflakeDecoder(input_channels=64, spd_type=spd_type)
    tm = sf.SnowflakeDecoder(input_channels=64, spd_type=spd_type)
    p = carry(jm, tm, pts, cond, seed=5)
    with torch.no_grad():
        got, levels = tm(to_torch(pts), to_torch(cond))
    want, want_levels = japply(jm, p, pts, cond)
    assert got.shape == (320, 3)
    for g, w in zip(levels, want_levels):
        scaled_close(g, w)


def test_pointnet_set_abstraction_and_propagation():
    """PointNet++: kNN set abstraction with features (FPS centres, groups
    re-centred), without them and over all points; feature propagation
    by inverse-distance weights with the skip features."""
    rng = np.random.RandomState(6)
    xyz, f = points(rng, 96), feats(rng, 96, 5)
    cases = [(jsf.PointNetSAModuleKNN(npoint=24, nsample=8, mlp=(16, 32)),
              sf.PointNetSAModuleKNN(24, 8, 5, (16, 32)), (xyz, f)),
             (jsf.PointNetSAModuleKNN(npoint=24, nsample=8, mlp=(16, 32)),
              sf.PointNetSAModuleKNN(24, 8, 0, (16, 32)), (xyz,)),
             (jsf.PointNetSAModuleKNN(npoint=1, nsample=96, mlp=(16, 32),
                                      group_all=True),
              sf.PointNetSAModuleKNN(1, 96, 5, (16, 32), group_all=True),
              (xyz, f))]
    for i, (jm, tm, args) in enumerate(cases):
        p = carry(jm, tm, *args, seed=7 + i)
        with torch.no_grad():
            got = tm(*(to_torch(a) for a in args))
        for g, w in zip(got, japply(jm, p, *args)):
            scaled_close(g, w)

    coarse, cf = points(rng, 24), feats(rng, 24, 32)
    jm = jsf.PointNetFPModule(mlp=(32, 16), use_points1=True)
    tm = sf.PointNetFPModule(32 + 5, (32, 16), use_points1=True)
    p = carry(jm, tm, xyz, coarse, f, cf, seed=11)
    with torch.no_grad():
        got = tm(*(to_torch(a) for a in (xyz, coarse, f, cf)))
    scaled_close(got, japply(jm, p, xyz, coarse, f, cf))
