"""The PyTorch port's heads and attention held against the JAX package on
the CPU: the masked blockwise attention, GSLayer, the vertex heads, the
additional-features head and the masked self-attention.

Every test makes its inputs and the module's parameters with numpy from a
seed, with no zero leaf (zero-initialised heads and maps would otherwise
hide mapping bugs), carries the parameters across with
``compat/from_jax.load_jax_params`` and compares the outputs at atol 2e-5 /
rtol 1e-5 (``tests/torch_parity.py::close``): the fp32 rounding of matmuls
and reductions that XLA and PyTorch order differently.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.nn import heads as jheads
from guassianhand_tpu.ops.blockwise_attention import blockwise_attention as j_attn
from guassianhand_tpu_torch.nn import heads
from guassianhand_tpu_torch.ops.blockwise_attention import blockwise_attention
from tests.torch_parity import (carried, close, japply,  # noqa: F401
                                one_torch_thread, randn, to_torch)


def test_blockwise_attention_masked():
    rng = np.random.RandomState(7)
    q, k, v = (randn(rng, 300, 4, 8) for _ in range(3))
    mask = rng.uniform(size=300) > 0.4
    want = j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(mask), q_chunk=128, k_chunk=128)
    got = blockwise_attention(to_torch(q), to_torch(k), to_torch(v),
                              to_torch(mask), q_chunk=128)
    close(got, want)
    assert float(got[torch.from_numpy(~mask)].abs().max()) == 0.0


@pytest.mark.parametrize("use_rgb", [True, False])
def test_gs_layer(use_rgb):
    rng = np.random.RandomState(8)
    x, pts = randn(rng, 30, 16), randn(rng, 30, 3, scale=0.1)
    jm = jheads.GSLayer(sh_degree=1, use_rgb=use_rgb)
    tm = heads.GSLayer(16, sh_degree=1, use_rgb=use_rgb)
    p = carried(jm, tm, x, pts)
    want, got = japply(jm, p, x, pts), tm(to_torch(x), to_torch(pts))
    for name in ("xyz", "opacity", "rotation", "scaling", "shs"):
        close(getattr(got, name), getattr(want, name))


def test_vert_heads_and_additional_features():
    rng = np.random.RandomState(9)
    feats, pts = randn(rng, 25, 13), randn(rng, 25, 3, scale=0.1)
    for jm, tm in ((jheads.VertValid(), heads.VertValid(16)),
                   (jheads.VertPosRefinement(), heads.VertPosRefinement(16))):
        p = carried(jm, tm, feats, pts)
        close(tm(to_torch(feats), to_torch(pts)), japply(jm, p, feats, pts))
    jm, tm = jheads.AdditionalFeaturesFC(out_dim=7), \
        heads.AdditionalFeaturesFC(13, 7)
    p = carried(jm, tm, feats)
    close(tm(to_torch(feats)), japply(jm, p, feats))


def test_self_attn_masked_rows_pass_through():
    rng = np.random.RandomState(10)
    x = randn(rng, 2, 150, 131)
    mask = rng.uniform(size=(2, 150)) > 0.5
    jm = jheads.SelfAttn(chunk_size=128)
    tm = heads.SelfAttn(131)
    p = carried(jm, tm, x, mask)
    got = tm(to_torch(x), mask=to_torch(mask))
    close(got, japply(jm, p, x, mask))
    np.testing.assert_array_equal(got.detach().numpy()[~mask], x[~mask])
