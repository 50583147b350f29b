"""Exact masked attention over the interacting Gaussians (counterpart of
``ops/blockwise_attention.py::blockwise_attention``).

The default route is plain matmul + softmax, chunked over query blocks so
that memory stays at O(q_chunk * N) per head: the dense 15.4k x 15.4k
score matrix of the avatar scene would take about 3.8 GB for 4 heads. With
``flash`` (or ``$GH_FLASH_ATTN=1``) it is the masked flash attention of
``ops/flash_attention_cuda.py``, CUDA kernels on the card. Either way
masked positions neither attend nor are attended to, and their output rows
are 0.

With bf16 q, k, v (the model's bf16 compute dtype) the chunked route is
the JAX scan path's mixed-precision recipe: float32 scores from the bf16
operands, the scale applied in float32, the softmax statistics in float32,
the probabilities rounded to bf16 for the product with V, which
accumulates in float32, and a float32 output (the flash route's output is
bf16, as JAX's Pallas kernel's). ``torch.matmul`` of two bf16 tensors would
round the scores to bf16, so the operands are widened to float32 first:
a product of two bf16 values is exact in float32.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from guassianhand_tpu_torch.ops.flash_attention_cuda import flash_attention

NEG_INF = -1e30
Q_CHUNK = 1024


def use_flash() -> bool:
    """$GH_FLASH_ATTN, read at call time: "1" routes the attention through
    the flash kernels (off by default, as in the JAX package)."""
    return os.environ.get("GH_FLASH_ATTN", "0") == "1"


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        q_chunk: int = Q_CHUNK,
                        flash: Optional[bool] = None) -> torch.Tensor:
    """q, k, v (N, H, D); mask optional (N,) bool. Returns (N, H, D).
    ``flash`` True/False forces the flash kernels / the chunked route; None
    follows ``$GH_FLASH_ATTN``."""
    if use_flash() if flash is None else flash:
        return flash_attention(q, k, v, mask)
    if q.dtype == torch.bfloat16:
        return _chunked_bf16(q, k, v, mask, q_chunk)
    n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(1, 2, 0)                                # (H, D, N)
    vh = v.transpose(0, 1)                                 # (H, N, D)
    out = torch.empty_like(q)
    for s in range(0, n, q_chunk):
        qc = q[s:s + q_chunk].transpose(0, 1)              # (H, qc, D)
        scores = (qc @ kt) * scale                          # (H, qc, N)
        if mask is not None:
            scores = scores.masked_fill(~mask[None, None, :], NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out[s:s + q_chunk] = (p @ vh).transpose(0, 1)
    if mask is not None:
        out = out * mask[:, None, None].to(out.dtype)
    return out


def _chunked_bf16(q, k, v, mask, q_chunk):
    """The chunked route for bf16 q, k, v: a float32 (N, H, D) output. The
    probabilities are rounded to bf16 against their row's maximum over all
    keys (JAX's scan rounds them against a running maximum over its key
    blocks); the sum is divided out after the product, as JAX does."""
    n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(1, 2, 0).float()                        # (H, D, N)
    vh = v.transpose(0, 1).float()                         # (H, N, D)
    out = torch.empty((n, h, d), dtype=torch.float32, device=q.device)
    for s in range(0, n, q_chunk):
        qc = q[s:s + q_chunk].transpose(0, 1).float()       # (H, qc, D)
        scores = (qc @ kt) * scale
        if mask is not None:
            scores = scores.masked_fill(~mask[None, None, :], NEG_INF)
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        acc = p.to(torch.bfloat16).float() @ vh
        out[s:s + q_chunk] = (acc / p.sum(dim=-1, keepdim=True).clamp_min(
            1e-30)).transpose(0, 1)
    if mask is not None:
        out = out * mask[:, None, None].to(out.dtype)
    return out


def ring_blockwise_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: torch.Tensor, group,
                             n_dev: int) -> torch.Tensor:
    """Exact masked attention with the sequence split over the ``n_dev``
    ranks of ``group`` (forward only; the counterpart of
    ``ring_blockwise_attention``, which runs inside shard_map).

    q, k, v (N / n_dev, H, D): this rank's rows; mask (N / n_dev,) bool.
    The queries stay; the key, value and mask blocks go round the ring
    (``parallel/comm.ring_shift``, one collective a step for all three),
    and each step's partial softmax statistics merge by the online-softmax
    recurrence, in float32 whatever the operands' dtype (scores from
    float32 operands, the probabilities rounded to v's dtype for the
    product with v, as JAX's ``preferred_element_type`` einsums). Memory
    stays O((N / n_dev)^2) a step. Returns (N / n_dev, H, D) float32, 0 on
    masked rows."""
    from guassianhand_tpu_torch.parallel.comm import ring_shift
    n_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m_run = torch.full((h, n_loc), NEG_INF, device=q.device)
    l_run = torch.zeros((h, n_loc), device=q.device)
    acc = torch.zeros((h, n_loc, d), device=q.device)
    # k, v and the mask travel as one float32 block (exact for bf16 and 0/1)
    block = torch.cat([k.reshape(n_loc, h * d).float(),
                       v.reshape(n_loc, h * d).float(),
                       mask.reshape(n_loc, 1).float()], dim=1)
    for step in range(n_dev):
        kc = block[:, :h * d].reshape(n_loc, h, d).to(k.dtype)
        vc = block[:, h * d:2 * h * d].reshape(n_loc, h, d).to(v.dtype)
        mc = block[:, -1] > 0.5
        s = torch.einsum("qhd,khd->hqk", qf, kc.float()) * scale
        s = s.masked_fill(~mc[None, None, :], NEG_INF)
        m_i = s.amax(dim=-1)
        p = torch.exp(s - m_i[..., None])
        l_i = p.sum(dim=-1)
        a_i = torch.einsum("hqk,khd->hqd", p.to(vc.dtype).float(),
                           vc.float())
        m_new = torch.maximum(m_run, m_i)
        c1 = torch.exp(m_run - m_new)
        c2 = torch.exp(m_i - m_new)
        l_run = l_run * c1 + l_i * c2
        acc = acc * c1[..., None] + a_i * c2[..., None]
        m_run = m_new
        if step + 1 < n_dev:
            block = ring_shift(block, group)
    out = (acc / torch.clamp(l_run, min=1e-30)[..., None]).transpose(0, 1)
    return out * mask[:, None, None].to(out.dtype)
