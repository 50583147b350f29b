"""Masked flash attention, forward and backward: the CUDA kernels and their
plain-PyTorch twins (counterpart of
``ops/blockwise_attention.py::_flash_attention_masked``).

``flash_attention`` replaces the JAX package's ``GH_FLASH_ATTN=1`` route,
which calls JAX's bundled Pallas TPU flash attention with segment ids. Its
mask contract is the JAX one: masked rows neither attend nor are attended
to, and their outputs (and so their gradients) are 0. Here the live rows
are gathered, attend among themselves through the ``FlashAttention``
autograd Function, and are scattered back, so the kernels compute no score
outside live x live. The kernel source is ``csrc/flash_attention.cu``,
whose header note gives its design and what bounds it: every product runs
on the tensor cores as TF32 MMAs in the split ("3xTF32") form, with fp32
accumulation, which the twins' fp32 tolerances admit (one TF32 product
alone does not).

- ``flash_forward``: out and the rows' log-sum-exp (kernel
  ``flash_fwd_kernel``, twin ``flash_attention_plain``);
- ``flash_backward_dkv`` and ``flash_backward_dq``: the backward's two
  kernels (twin ``flash_attention_backward_plain``), given
  delta = rowsum(dout * out), which stays a torch reduction as in JAX.

Each wrapper takes float32 or bf16 q, k, v (and dout), one type in a call,
and runs the kernel of that type: the float32 kernels above, or the bf16
kernels (``flash_fwd_bf16_kernel``, ``flash_dkv_bf16_kernel``,
``flash_dq_bf16_kernel``) that the model's bf16 compute dtype reaches.
These follow the rounding points of JAX's Pallas flash attention in bf16:
bf16 products accumulated in float32, the scale applied to the float32
scores, the softmax in float32, P (and in the backward dS, scaled before
the cast) rounded to bf16 for their products, out, dq, dk and dv rounded to
bf16 once, lse float32. Their twins (the same functions, given bf16
tensors) round at the kernels' points; the forward rounds P against the
running maximum of 64-key tiles, as the kernel does (``KERNEL_TILE``).
No other type is taken, and none is converted into another.

Each wrapper sends CUDA tensors to its kernel and CPU tensors to the twin;
nothing falls back from one to the other. ``<wrapper>.launches`` counts
the float32 kernel's launches and ``<wrapper>.launches_bf16`` the bf16
kernel's. The kernels take head width 32 (the interaction attention's);
other widths raise on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from guassianhand_tpu_torch.ops.cuda_build import (F, I, P, CudaLibrary,
                                                   check_launch)

LIB = CudaLibrary("flash_attention.cu", {
    "gh_flash_forward": [P, P, P, I, I, F, P, P, P],
    "gh_flash_backward_dkv": [P, P, P, P, P, P, I, I, F, P, P, P],
    "gh_flash_backward_dq": [P, P, P, P, P, P, I, I, F, P, P],
    "gh_flash_forward_bf16": [P, P, P, I, I, F, P, P, P],
    "gh_flash_backward_dkv_bf16": [P, P, P, P, P, P, I, I, F, P, P, P],
    "gh_flash_backward_dq_bf16": [P, P, P, P, P, P, I, I, F, P, P]})
KERNEL_HEAD_DIM = 32
# the kernels' operand types; lse and delta are float32 for both
DTYPES = (torch.float32, torch.bfloat16)
# query rows per chunk of the twins: (H, Q_CHUNK, L) scores at a time
Q_CHUNK = 1024
# keys a tile of the bf16 forward kernel: P is rounded to bf16 against the
# running maximum of the tiles so far
KERNEL_TILE = 64


def _heads_first(x):
    return x.transpose(0, 1)                                # (H, L, D)


def flash_attention_plain(q, k, v, q_chunk: int = Q_CHUNK):
    """The forward kernel's function in plain PyTorch: (out (L, H, D),
    lse (H, L)) of q, k, v (L, H, D), with scale 1/sqrt(D); chunked over
    queries so that the scores of one chunk are the largest temporary.
    bf16 inputs take the bf16 kernel's function (``_forward_plain_bf16``)."""
    if q.dtype == torch.bfloat16:
        return _forward_plain_bf16(q, k, v, q_chunk)
    n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(1, 2, 0)                                 # (H, D, L)
    vh = _heads_first(v)
    out = torch.empty_like(q)
    lse = torch.empty((h, n), dtype=q.dtype, device=q.device)
    for s in range(0, n, q_chunk):
        scores = (_heads_first(q[s:s + q_chunk]) @ kt) * scale
        lse_c = torch.logsumexp(scores, dim=-1)             # (H, qc)
        p = torch.exp(scores - lse_c[..., None])
        out[s:s + q_chunk] = (p @ vh).transpose(0, 1)
        lse[:, s:s + q_chunk] = lse_c
    return out, lse


def _forward_plain_bf16(q, k, v, q_chunk):
    """The bf16 forward kernel's function: scores in float32 from the bf16
    operands, times the scale; over the keys in KERNEL_TILE tiles, in
    order, an online softmax in float32 whose P = exp(S - m), m the
    running maximum with this tile, is rounded to bf16 for P V (float32
    sums); out = acc / l rounded to bf16; lse = m + log(l) float32."""
    n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(1, 2, 0).float()                         # (H, D, L)
    vh = _heads_first(v).float()
    out = torch.empty_like(q)
    lse = torch.empty((h, n), dtype=torch.float32, device=q.device)
    for s in range(0, n, q_chunk):
        qc = _heads_first(q[s:s + q_chunk]).float()
        rows = qc.shape[1]
        m = torch.full((h, rows, 1), -math.inf, device=q.device)
        l = torch.zeros((h, rows, 1), device=q.device)
        acc = torch.zeros((h, rows, d), device=q.device)
        for t in range(0, n, KERNEL_TILE):
            scores = (qc @ kt[:, :, t:t + KERNEL_TILE]) * scale
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            p = torch.exp(scores - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + (p.to(torch.bfloat16).float()
                                @ vh[:, t:t + KERNEL_TILE])
            m = m_new
        out[s:s + q_chunk] = (acc / l).transpose(0, 1).to(q.dtype)
        lse[:, s:s + q_chunk] = (m + torch.log(l))[..., 0]
    return out, lse


def _backward_plain_bf16(q, k, v, dout, lse, delta, *, want_dq: bool,
                         want_dkv: bool, q_chunk: int = Q_CHUNK):
    """The bf16 backward kernels' function: P = exp(S scale - lse) and
    dP = dout v^T in float32 from the bf16 operands, dS = (dP - delta) P
    scale in float32; dv = bf16(P)^T dout, dk = bf16(dS)^T q and
    dq = bf16(dS) k summed in float32 and each rounded to bf16 once."""
    n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kh, vh = _heads_first(k).float(), _heads_first(v).float()
    kt, vt = kh.transpose(1, 2), vh.transpose(1, 2)         # (H, D, L)
    dq = torch.empty_like(q) if want_dq else None
    dk = torch.zeros_like(kh) if want_dkv else None
    dv = torch.zeros_like(vh) if want_dkv else None
    for s in range(0, n, q_chunk):
        qc = _heads_first(q[s:s + q_chunk]).float()         # (H, qc, D)
        doc = _heads_first(dout[s:s + q_chunk]).float()
        p = torch.exp((qc @ kt) * scale - lse[:, s:s + q_chunk, None])
        ds = (((doc @ vt) - delta[:, s:s + q_chunk, None]) * p) * scale
        ds16 = ds.to(torch.bfloat16).float()
        if want_dq:
            dq[s:s + q_chunk] = (ds16 @ kh).transpose(0, 1).to(q.dtype)
        if want_dkv:
            dk += ds16.transpose(1, 2) @ qc
            dv += p.to(torch.bfloat16).float().transpose(1, 2) @ doc
    dk, dv = (None if t is None else t.transpose(0, 1).to(q.dtype)
              .contiguous() for t in (dk, dv))
    return dq, dk, dv


def _backward_plain(q, k, v, dout, lse, delta, *, want_dq: bool,
                    want_dkv: bool, q_chunk: int = Q_CHUNK):
    if q.dtype == torch.bfloat16:
        return _backward_plain_bf16(q, k, v, dout, lse, delta,
                                    want_dq=want_dq, want_dkv=want_dkv,
                                    q_chunk=q_chunk)
    n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kh, vh = _heads_first(k), _heads_first(v)
    kt, vt = kh.transpose(1, 2), vh.transpose(1, 2)         # (H, D, L)
    dq = torch.empty_like(q) if want_dq else None
    dk = torch.zeros_like(kh) if want_dkv else None
    dv = torch.zeros_like(vh) if want_dkv else None
    for s in range(0, n, q_chunk):
        qc = _heads_first(q[s:s + q_chunk])                 # (H, qc, D)
        doc = _heads_first(dout[s:s + q_chunk])
        p = torch.exp((qc @ kt) * scale - lse[:, s:s + q_chunk, None])
        ds = p * ((doc @ vt) - delta[:, s:s + q_chunk, None])
        if want_dq:
            dq[s:s + q_chunk] = ((ds @ kh) * scale).transpose(0, 1)
        if want_dkv:
            dk += (ds.transpose(1, 2) @ qc) * scale
            dv += p.transpose(1, 2) @ doc
    return (dq,
            None if dk is None else dk.transpose(0, 1).contiguous(),
            None if dv is None else dv.transpose(0, 1).contiguous())


def attention_delta(out, dout):
    """delta = rowsum(dout * out) as (H, L), float32 (from bf16 out and
    dout too, as JAX computes it)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(0, 1
                                                              ).contiguous()


def flash_attention_backward_plain(q, k, v, out, lse, dout,
                                   q_chunk: int = Q_CHUNK):
    """The backward kernels' function in plain PyTorch, with the flash
    formulas and no autograd: D = rowsum(dout * out), P = exp(S - lse),
    dS = P * (dP - D), then (dq, dk, dv), each (L, H, D); for bf16 inputs
    ``_backward_plain_bf16``'s rounding."""
    return _backward_plain(q, k, v, dout, lse, attention_delta(out, dout),
                           want_dq=True, want_dkv=True, q_chunk=q_chunk)


def _check(q, k, v, **extra):
    """Shapes, types and devices: q, k, v and dout one of DTYPES, all the
    same; lse and delta float32."""
    if q.dim() != 3 or q.dtype not in DTYPES:
        raise ValueError(f"q must be (L, H, D) float32 or bfloat16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    n, h, d = q.shape
    for name, t, shape in (("k", k, q.shape), ("v", v, q.shape),
                           *((nm, t, s) for nm, (t, s) in extra.items())):
        dtype = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type == "cuda" and d != KERNEL_HEAD_DIM:
        raise ValueError(f"the attention kernels take head width "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return n, h, d


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _suffixed(name: str, bf16: bool) -> str:
    return f"{name}_bf16" if bf16 else name


def _count(wrapper, bf16: bool) -> None:
    """One launch of ``wrapper``'s float32 or bf16 kernel."""
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _aligned(*tensors):
    """The kernels copy rows 16 bytes at a time: each CUDA pointer 16-byte
    aligned."""
    for t in tensors:
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("the attention kernels need 16-byte aligned "
                             "tensors")
    return tensors


def flash_forward(q, k, v):
    """(out (L, H, D), lse (H, L)) of unmasked attention over q, k, v."""
    n, h, d = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    dev = q.device
    q, k, v = _aligned(q.contiguous(), k.contiguous(), v.contiguous())
    out = torch.empty_like(q)
    lse = torch.empty((h, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out, lse
    bf16 = q.dtype == torch.bfloat16
    fn = getattr(LIB.load(), _suffixed("gh_flash_forward", bf16))
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), n, h,
                 1.0 / math.sqrt(d), out.data_ptr(), lse.data_ptr(),
                 _stream(dev))
    check_launch(err, _suffixed("flash_fwd", bf16) + "_kernel")
    _count(flash_forward, bf16)
    return out, lse


flash_forward.launches = 0
flash_forward.launches_bf16 = 0


def _backward_args(q, k, v, dout, lse, delta):
    n, h, d = _check(q, k, v, dout=(dout, q.shape),
                     lse=(lse, (q.shape[1], q.shape[0])),
                     delta=(delta, (q.shape[1], q.shape[0])))
    return (n, h, d), list(_aligned(*(t.contiguous()
                                     for t in (q, k, v, dout, lse, delta))))


def flash_backward_dkv(q, k, v, dout, lse, delta):
    """(dk, dv), each (L, H, D), from dout (L, H, D), the forward's lse
    (H, L) and delta (H, L) (``attention_delta``)."""
    (n, h, d), ins = _backward_args(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return _backward_plain(*ins, want_dq=False, want_dkv=True)[1:]
    dev = q.device
    dk = torch.empty_like(ins[0])
    dv = torch.empty_like(ins[0])
    if n == 0:
        return dk, dv
    bf16 = q.dtype == torch.bfloat16
    fn = getattr(LIB.load(), _suffixed("gh_flash_backward_dkv", bf16))
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in ins), n, h, 1.0 / math.sqrt(d),
                 dk.data_ptr(), dv.data_ptr(), _stream(dev))
    check_launch(err, _suffixed("flash_dkv", bf16) + "_kernel")
    _count(flash_backward_dkv, bf16)
    return dk, dv


flash_backward_dkv.launches = 0
flash_backward_dkv.launches_bf16 = 0


def flash_backward_dq(q, k, v, dout, lse, delta):
    """dq (L, H, D) from the same inputs as ``flash_backward_dkv``."""
    (n, h, d), ins = _backward_args(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return _backward_plain(*ins, want_dq=True, want_dkv=False)[0]
    dev = q.device
    dq = torch.empty_like(ins[0])
    if n == 0:
        return dq
    bf16 = q.dtype == torch.bfloat16
    fn = getattr(LIB.load(), _suffixed("gh_flash_backward_dq", bf16))
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in ins), n, h, 1.0 / math.sqrt(d),
                 dq.data_ptr(), _stream(dev))
    check_launch(err, _suffixed("flash_dq", bf16) + "_kernel")
    _count(flash_backward_dq, bf16)
    return dq


flash_backward_dq.launches = 0
flash_backward_dq.launches_bf16 = 0


class FlashAttention(torch.autograd.Function):
    """Unmasked exact attention over q, k, v (L, H, D), scale 1/sqrt(D);
    the backward runs the dkv and dq kernels. It saves q, k, v and out in
    their own type (bf16 for bf16 inputs) and lse in float32."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta)
        dq = flash_backward_dq(q, k, v, dout, lse, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (N, H, D); mask optional (N,) bool. The live rows attend
    among themselves; masked rows give 0. Returns (N, H, D) in q's type."""
    if mask is None:
        return FlashAttention.apply(q, k, v)
    live = mask.nonzero()[:, 0]
    return torch.zeros_like(q).index_copy(0, live, FlashAttention.apply(
        q[live], k[live], v[live]))
