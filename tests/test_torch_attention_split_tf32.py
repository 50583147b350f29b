"""Why the port's masked flash attention (K5) may run its products on the
tensor cores: the split TF32 ("3xTF32") product, emulated on the CPU and
held against JAX.

``guassianhand_tpu_torch/csrc/flash_attention.cu`` computes every product of
the attention as TF32 MMAs with fp32 accumulation, each fp32 operand split
into hi = tf32(x) and lo = tf32(x - hi), a.b taken as hi.hi + (hi.lo +
lo.hi). Here ``tf32_round`` emulates ``cvt.rna.tf32.f32`` (round to nearest,
ties away from zero, onto 10 mantissa bits) through an int32 view, and
``split_mm`` the product in float32 (a product of two TF32 values is exact
in float32). Put into the twins' forward and backward formulas
(``ops/flash_attention_cuda.py``) with every product split, it stays within
tests/test_torch_attention.py's tolerances of JAX
``blockwise_attention(flash=False)`` (out atol 2e-5, gradients 1e-4 *
scale) on that file's inputs and mask; one TF32 product alone (hi.hi) does
not.
"""
import math

import numpy as np
import pytest
import torch

from tests.test_torch_attention import (GRAD_ATOL, OUT_ATOL,
                                        jax_value_and_grad, qkv)
from tests.torch_parity import one_torch_thread  # noqa: F401


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 ``x`` (NaN aside): round to nearest, ties
    away from zero, onto 10 mantissa bits, on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_mm(a, b, single: bool = False):
    """a @ b as the kernel's MMAs take it: hi.hi + (hi.lo + lo.hi), the
    small terms summed first; with ``single`` one TF32 product, hi.hi."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if single:
        return a_hi @ b_hi
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def attention_split(q, k, v, dout, single: bool = False):
    """(out, dq, dk, dv) of unmasked attention over q, k, v (L, H, D) with
    the twins' formulas, every product ``split_mm``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, dout))
    s = split_mm(qh, kh.transpose(1, 2), single) * scale
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    out = split_mm(p, vh, single)
    delta = (doh * out).sum(dim=-1, keepdim=True)
    ds = p * (split_mm(doh, vh.transpose(1, 2), single) - delta)
    dq = split_mm(ds, kh, single) * scale
    dk = split_mm(ds.transpose(1, 2), qh, single) * scale
    dv = split_mm(p.transpose(1, 2), doh, single)
    return [x.transpose(0, 1) for x in (out, dq, dk, dv)]


def emulated(q, k, v, mask, tgt, single: bool = False):
    """The masked route as the wrapper runs it (gather the live rows, attend
    among them, scatter back), with dout = tgt: out and [dq, dk, dv]."""
    live = np.flatnonzero(mask)
    outs = attention_split(*(torch.from_numpy(x[live])
                             for x in (q, k, v, tgt)), single=single)
    full = []
    for x in outs:
        z = np.zeros(q.shape, np.float32)
        z[live] = x.numpy()
        full.append(z)
    return full[0], full[1:]


@pytest.fixture(scope="module")
def case():
    """tests/test_torch_attention.py's inputs and mask at n = 1000, and
    JAX's scan attention's output and gradients of sum(out * tgt)."""
    inputs = qkv(1000, seed=1000)
    return inputs, jax_value_and_grad(*inputs, flash=False)


def test_tf32_round_is_round_to_nearest_ties_away():
    """Ties go away from zero, either sign; just below a tie goes down; the
    largest float rounds to inf; and random values match a float64 rounding
    of the significand to 11 bits, each with its low 13 bits 0 and the
    split's remainder within 2^-22 |x|."""
    t = 2.0 ** -11
    x = torch.tensor([1 + t, -(1 + t), 1 + t - 2.0 ** -23, 1 + 3 * t,
                      3.4028234663852886e38, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 * t, -(1 + 2 * t), 1.0, 1 + 4 * t,
                         math.inf, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    r = np.random.RandomState(0)
    x = torch.from_numpy((r.normal(size=4096)
                          * 10.0 ** r.uniform(-20, 20, 4096))
                         .astype(np.float32))
    hi, lo = split(x)
    m, e = np.frexp(np.abs(x.numpy().astype(np.float64)))
    ref = np.sign(x.numpy()) * np.floor(m * 2 ** 11 + 0.5) * 2.0 ** (e - 11)
    np.testing.assert_array_equal(hi.numpy(), ref.astype(np.float32))
    assert not (hi.view(torch.int32) & 0x1fff).any()
    assert not (lo.view(torch.int32) & 0x1fff).any()
    rest = x.double() - hi.double() - lo.double()
    assert bool((rest.abs() <= 2.0 ** -22 * x.double().abs()).all())


def test_split_tf32_attention_matches_jax(case):
    """The split product in the twins' formulas, through the masked route,
    against JAX: out within atol 2e-5, dq, dk, dv within 1e-4 * scale,
    masked rows exactly 0."""
    (q, k, v, mask, tgt), (o_ref, g_ref) = case
    o, g = emulated(q, k, v, mask, tgt)
    np.testing.assert_allclose(o, o_ref, atol=OUT_ATOL)
    np.testing.assert_array_equal(o[~mask], 0.0)
    for name, a, b in zip("qkv", g, g_ref):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL * np.abs(b).max(),
                                   err_msg=f"grad {name}")


def test_one_tf32_product_misses_the_gradient_tolerance(case):
    """The same with one TF32 product (hi.hi) in place of the split: some
    gradient is further from JAX than 1e-4 * scale, so the split is what
    keeps the kernels within tolerance."""
    (q, k, v, mask, tgt), (_, g_ref) = case
    _, g = emulated(q, k, v, mask, tgt, single=True)
    over = [float(np.abs(a - b).max() / (GRAD_ATOL * np.abs(b).max()))
            for a, b in zip(g, g_ref)]
    assert max(over) > 1.0, over
