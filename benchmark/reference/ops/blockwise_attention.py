"""Exact masked attention over the interacting Gaussians, in plain
matmul and softmax, chunked over query blocks so that memory stays at
O(q_chunk * N) a head. Masked positions neither attend nor are attended
to, and their output rows are 0. ``lowp``: the inputs, the probabilities
and the output pass through ``precision.lowp`` (the program's bf16
layers)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from benchmark.reference.precision import lowp as _lowp

NEG_INF = -1e30
Q_CHUNK = 1024


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        q_chunk: int = Q_CHUNK,
                        lowp: bool = False) -> torch.Tensor:
    """q, k, v (N, H, D); mask optional (N,) bool. Returns (N, H, D)."""
    lp = _lowp if lowp else (lambda t: t.float())
    q, k, v = lp(q), lp(k), lp(v)
    n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kt = k.permute(1, 2, 0)                                # (H, D, N)
    vh = v.transpose(0, 1)                                 # (H, N, D)
    outs = []
    for s in range(0, n, q_chunk):
        qc = q[s:s + q_chunk].transpose(0, 1)              # (H, qc, D)
        scores = (qc @ kt) * scale                          # (H, qc, N)
        if mask is not None:
            scores = scores.masked_fill(~mask[None, None, :], NEG_INF)
        p = lp(torch.softmax(scores, dim=-1))
        outs.append((p @ vh).transpose(0, 1))
    out = lp(torch.cat(outs))
    if mask is not None:
        out = out * mask[:, None, None].to(out.dtype)
    return out
