"""The PyTorch port's network building blocks held against the JAX package
on the CPU: the MLPs, the positional encoding, the local-pool PointNet, the
triplane tokenizer and upsampler, the 1-D transformer and grid sampling.

Every test makes its inputs and the module's parameters with numpy from a
seed, with no zero leaf (zero-initialised heads and maps would otherwise
hide mapping bugs), carries the parameters across with
``compat/from_jax.load_jax_params`` and compares the outputs at atol 2e-5 /
rtol 1e-5 (``tests/torch_parity.py::close``): the fp32 rounding of matmuls
and reductions that XLA and PyTorch order differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from guassianhand_tpu.nn import mlp as jmlp
from guassianhand_tpu.nn import pointnet as jpointnet
from guassianhand_tpu.nn import tokenizers as jtok
from guassianhand_tpu.nn import transformer as jtr
from guassianhand_tpu.nn.spatial import positional_encoding as j_pe
from guassianhand_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample
from guassianhand_tpu_torch.nn import mlp, pointnet, tokenizers, transformer
from guassianhand_tpu_torch.nn.spatial import positional_encoding
from guassianhand_tpu_torch.ops.grid_sample import grid_sample_2d
from tests.torch_parity import (carried, close, japply,  # noqa: F401
                                one_torch_thread, randn, to_torch)


@pytest.mark.parametrize("activation", ["silu", "relu"])
def test_mlp(activation):
    rng = np.random.RandomState(0)
    x = randn(rng, 5, 25)
    jm = jmlp.MLP(dim_out=12, n_neurons=32, n_hidden_layers=2,
                  activation=activation)
    tm = mlp.MLP(25, 12, 32, n_hidden_layers=2, activation=activation)
    p = carried(jm, tm, x)
    close(tm(to_torch(x)), japply(jm, p, x))


def test_mlp_blocks():
    rng = np.random.RandomState(1)
    x = randn(rng, 7, 20)
    jb, tb = jmlp.MLPBlock(hid_dim=9), mlp.MLPBlock(20, 9)
    p = carried(jb, tb, x)
    close(tb(to_torch(x)), japply(jb, p, x))
    jr, tr = jmlp.MLPResBlock(hid_dim=11), mlp.MLPResBlock(20, 11)
    p = carried(jr, tr, x)
    close(tr(to_torch(x)), japply(jr, p, x))


def test_positional_encoding():
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (4, 6, 3)).astype(np.float32)
    close(positional_encoding(to_torch(x), 4), j_pe(jnp.asarray(x), 4),
          atol=1e-6, rtol=1e-6)


def test_local_pool_pointnet():
    """Coordinates reach the clip at +-(radius - 1e-6) and leave cells of
    the 4x4 grid empty (pooled to 0)."""
    rng = np.random.RandomState(3)
    p = randn(rng, 2, 40, 7)
    p[:, :, :2] = rng.uniform(-1.2, 0.3, (2, 40, 2))
    jm = jpointnet.LocalPoolPointnet(c_dim=16, plane_size=4)
    tm = pointnet.LocalPoolPointnet(7, c_dim=16, plane_size=4)
    params = carried(jm, tm, p)
    close(tm(to_torch(p)), japply(jm, params, p))


def test_triplane_tokenizer_and_upsampler():
    rng = np.random.RandomState(4)
    cond = randn(rng, 2, 8, 4, 4)
    jt = jtok.TriplaneLearnablePositionalEmbedding(plane_size=4,
                                                   num_channels=8, n_plane=2)
    tt = tokenizers.TriplaneLearnablePositionalEmbedding(4, 8, 2)
    pt = carried(jt, tt, cond)
    tokens = tt(to_torch(cond))
    close(tokens, japply(jt, pt, cond))
    planes = randn(rng, 2, 2, 8, 4, 4)
    close(tt.detokenize(to_torch(planes.reshape(2, 8, 32))),
          japply(jt, pt, planes.reshape(2, 8, 32), method="detokenize"))
    ju, tu = jtok.TriplaneUpsampler(out_channels=5), \
        tokenizers.TriplaneUpsampler(8, 5)
    pu = carried(ju, tu, planes)
    close(tu(to_torch(planes)), japply(ju, pu, planes))


def test_transformer1d():
    rng = np.random.RandomState(5)
    tokens = randn(rng, 2, 64, 32)
    jm = jtr.Transformer1D(num_layers=2, heads=2, head_dim=16)
    tm = transformer.Transformer1D(64, num_layers=2, heads=2, head_dim=16)
    p = carried(jm, tm, tokens)
    close(tm(to_torch(tokens)), japply(jm, p, tokens), atol=5e-5)


def test_grid_sample_matches_at_borders():
    """Interior, edge and out-of-range coordinates: the JAX sampler clamps
    indices and weights, which zero-padded F.grid_sample does not."""
    rng = np.random.RandomState(6)
    feat = randn(rng, 5, 7, 9)
    uv = rng.uniform(-1.3, 1.3, (200, 2)).astype(np.float32)
    uv[:4] = [[-1, -1], [1, 1], [1, -1], [-1, 1]]
    close(grid_sample_2d(to_torch(feat), to_torch(uv)),
          jax.jit(j_grid_sample)(jnp.asarray(feat), jnp.asarray(uv)),
          atol=1e-6)
