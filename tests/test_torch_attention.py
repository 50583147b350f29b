"""The port's masked flash attention (K5, ``ops/flash_attention_cuda.py``)
held against the JAX package on the CPU: the forward and backward twins
against JAX ``blockwise_attention(flash=False)`` (the scan path, which JAX's
own tests hold equal to its Pallas flash path), once against
``flash=True`` in TPU interpret mode at n = 512, the backward twin against
torch autograd of the port's chunked route, ``SelfAttn`` with
``GH_FLASH_ATTN=1`` against off, and the ``interaction_cap`` path against
JAX ``SelfAttn(cap=...)``.

Tolerances: outputs atol 2e-5; gradients atol 1e-4 * scale (scale the
largest |gradient| of the array), the tolerances of
tests/test_attention.py's flash test; SelfAttn at the module tolerances of
tests/torch_parity.py (atol 2e-5, rtol 1e-5): the softmax sums are taken in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.nn import heads as jheads
from guassianhand_tpu.ops.blockwise_attention import \
    blockwise_attention as j_attention
from guassianhand_tpu_torch.nn import heads
from guassianhand_tpu_torch.ops import flash_attention_cuda as fa
from guassianhand_tpu_torch.ops.blockwise_attention import blockwise_attention
from tests.torch_parity import (carried, close, environ,  # noqa: F401
                                one_torch_thread, randn, to_torch)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4


def qkv(n, seed, live=0.6, h=4, d=32):
    rng = np.random.RandomState(seed)
    q, k, v, tgt = (randn(rng, n, h, d) for _ in range(4))
    mask = rng.uniform(size=n) < live
    return q, k, v, mask, tgt


def jax_value_and_grad(q, k, v, mask, tgt, flash):
    """JAX's attention output and the gradients of sum(out * tgt)."""
    def loss(a, b, c):
        o = j_attention(a, b, c, jnp.asarray(mask), q_chunk=256, k_chunk=256,
                        flash=flash)
        return jnp.sum(o * tgt), o
    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in g]


def port_value_and_grad(q, k, v, mask, tgt, flash=True):
    leaves = [to_torch(x).requires_grad_() for x in (q, k, v)]
    o = blockwise_attention(*leaves, None if mask is None else to_torch(mask),
                            flash=flash)
    grads = torch.autograd.grad((o * to_torch(tgt)).sum(), leaves)
    return o.detach().numpy(), [g.numpy() for g in grads]


def assert_matches(got, want, mask, common_scale=False):
    """Outputs and gradients within tolerance, masked rows exactly 0. The
    gradient scale is each array's largest |gradient|, or with
    ``common_scale`` the largest of all three."""
    (o, g), (o_ref, g_ref) = got, want
    np.testing.assert_allclose(o, o_ref, atol=OUT_ATOL)
    if mask is not None:
        np.testing.assert_array_equal(o[~mask], 0.0)
    common = max(np.abs(b).max() for b in g_ref)
    for name, a, b in zip("qkv", g, g_ref):
        scale = (common if common_scale else np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL * scale,
                                   err_msg=f"grad {name}")
        if mask is not None:
            np.testing.assert_array_equal(a[~mask], 0.0)


@pytest.mark.parametrize("n", [300, 1000])
def test_flash_twins_match_jax_scan(n):
    """The twins through the port's flash route (gather, FlashAttention,
    scatter) against JAX's scan path, forward and backward."""
    q, k, v, mask, tgt = qkv(n, seed=n)
    assert_matches(port_value_and_grad(q, k, v, mask, tgt),
                   jax_value_and_grad(q, k, v, mask, tgt, flash=False), mask)


def test_flash_twins_match_jax_pallas_flash():
    """Against JAX's Pallas flash attention itself, in TPU interpret mode on
    the CPU, as tests/test_attention.py runs it (n = 512: its 512-row
    block)."""
    from jax.experimental.pallas import tpu as pltpu
    q, k, v, mask, tgt = qkv(512, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_value_and_grad(q, k, v, mask, tgt, flash=True)
    assert_matches(port_value_and_grad(q, k, v, mask, tgt), want, mask)


def test_flash_edge_cases_match_the_chunked_route():
    """L = 1, L = N, no mask, no live row, and N that no block divides:
    the flash route against the port's chunked route (autograd). With one
    live row dq is 0 up to rounding (its softmax is the constant 1), so the
    gradient scale is the largest of the three arrays'."""
    q, k, v, _, tgt = qkv(77, seed=4, h=2)
    one = np.zeros(77, bool)
    one[40] = True
    for mask in (one, np.ones(77, bool), None, np.zeros(77, bool)):
        assert_matches(port_value_and_grad(q, k, v, mask, tgt),
                       port_value_and_grad(q, k, v, mask, tgt, flash=False),
                       mask, common_scale=True)


def test_backward_twin_matches_autograd_of_the_chunked_route():
    """flash_attention_backward_plain (the flash formulas, no autograd)
    against torch autograd through the default chunked route, unmasked, and
    the forward twin's lse against a direct logsumexp."""
    q, k, v, _, tgt = (to_torch(x) for x in qkv(300, seed=5))
    out, lse = fa.flash_attention_plain(q, k, v, q_chunk=64)
    scores = torch.einsum("qhd,khd->hqk", q, k) / np.sqrt(32.0)
    close(lse, torch.logsumexp(scores, dim=-1), atol=OUT_ATOL, rtol=0)
    got = fa.flash_attention_backward_plain(q, k, v, out, lse, tgt,
                                            q_chunk=64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = blockwise_attention(*leaves, flash=False)
    close(out, o.detach(), atol=OUT_ATOL, rtol=0)
    want = torch.autograd.grad((o * tgt).sum(), leaves)
    for name, a, b in zip("qkv", got, want):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_self_attn_with_flash_matches_without():
    """SelfAttn with GH_FLASH_ATTN=1 against off, on the port: output and
    input gradient; non-interacting rows pass through."""
    rng = np.random.RandomState(10)
    x = randn(rng, 2, 150, 131)
    mask = to_torch(rng.uniform(size=(2, 150)) > 0.5)
    tm = heads.SelfAttn(131)
    results = []
    for flag in ("0", "1"):
        xt = to_torch(x).requires_grad_()
        with environ(GH_FLASH_ATTN=flag):
            y = tm(xt, mask=mask)
        (g,) = torch.autograd.grad((y * y).sum(), [xt])
        results.append((y.detach().numpy(), g.numpy()))
    (y0, g0), (y1, g1) = results
    close(y1, y0)
    close(g1, g0, atol=GRAD_ATOL * float(np.abs(g0).max()), rtol=0)
    np.testing.assert_array_equal(y1[~mask.numpy()], x[~mask.numpy()])


@pytest.mark.parametrize("flag", ["0", "1"])
def test_self_attn_interaction_cap_matches_jax(flag):
    """SelfAttn(cap=128) against JAX's, with the flash route off and on:
    sample 0 fits the budget (100 interacting rows), sample 1 does not
    (256): its first 128 interacting rows attend among themselves, the rest
    pass through, and the overflow is 128."""
    rng = np.random.RandomState(3)
    b, n, f = 2, 512, 131
    x = randn(rng, b, n, f)
    mask = np.zeros((b, n), bool)
    mask[0, :100] = True
    mask[1, ::2] = True
    jm = jheads.SelfAttn(dropout=0.0, cap=128)
    tm = heads.SelfAttn(f, cap=128)
    p = carried(jm, tm, x, mask)
    (want, j_overflow), _ = jax.jit(lambda p, x, m: jm.apply(
        p, x, m, return_overflow=True, mutable=["diagnostics"]))(p, x, mask)
    with environ(GH_FLASH_ATTN=flag):
        got, overflow = tm(to_torch(x), mask=to_torch(mask),
                           return_overflow=True)
    close(got, want)
    dropped = np.arange(256, n, 2)
    np.testing.assert_array_equal(got.detach().numpy()[1][dropped],
                                  x[1][dropped])
    assert float(overflow) == float(j_overflow) == 128.0
