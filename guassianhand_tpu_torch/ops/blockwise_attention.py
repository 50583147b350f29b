"""Exact masked attention over the interacting Gaussians (counterpart of
``ops/blockwise_attention.py::blockwise_attention``).

Plain matmul + softmax, chunked over query blocks so that memory stays at
O(q_chunk * N) per head: the dense 15.4k x 15.4k score matrix of the
avatar scene would take about 3.8 GB for 4 heads. Masked positions neither
attend nor are attended to, and their output rows are 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
Q_CHUNK = 1024


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """q, k, v (N, H, D); mask optional (N,) bool. Returns (N, H, D)."""
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
