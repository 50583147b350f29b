"""Sorted-segment sum: the CUDA kernel and its plain-PyTorch twin
(counterpart of ``ops/segreduce_pallas.py``).

``segment_reduce_sorted`` replaces
``guassianhand_tpu/ops/segreduce_pallas.py::segment_reduce_sorted`` and,
given ``order``, the key-value sort before it: it sums ``vals[:, order[k]]``
over the runs of ``ids[order[k]]``, so the backward passes its pair
gradients as they stand with the stable order that sorts their ids. The
kernel source is ``csrc/segment_reduce.cu``, whose header note gives its
design and what bounds it. The wrapper sends CUDA tensors to the kernel and
CPU tensors to ``segment_reduce_plain``; nothing falls back from one to the
other. ``segment_reduce_sorted.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from guassianhand_tpu_torch.ops.cuda_build import (I, P, CudaLibrary,
                                                   check_launch)

LIB = CudaLibrary("segment_reduce.cu", {
    "gh_segment_reduce_sorted": [P, P, P, I, I, I, P, P]})
# segments per chunk of the twin's padded gather
PLAIN_CHUNK_ELEMS = 1 << 24


def segment_reduce_sorted(ids: torch.Tensor, vals: torch.Tensor, n: int, *,
                          order: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-segment sums of ``vals`` (R, P) float32 over ``ids`` (P,) int32:
    ascending as they stand, or ascending in ``ids[order]`` when ``order``
    (P,) int32, a permutation of [0, P), is given; each segment's values
    are then ``vals[:, order[k]]`` summed in ascending k. Ids outside
    [0, n) are dropped. Returns (n, R) float32."""
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError("ids must be 1-D int32")
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[1] != ids.shape[0]:
        raise ValueError(f"vals must be (R, {ids.shape[0]}) float32, "
                         f"got {tuple(vals.shape)} {vals.dtype}")
    if order is not None and (order.dtype != torch.int32
                              or order.shape != ids.shape):
        raise ValueError(f"order must be ({ids.shape[0]},) int32, got "
                         f"{tuple(order.shape)} {order.dtype}")
    tensors = (ids, vals) if order is None else (ids, vals, order)
    if any(t.device != vals.device for t in tensors):
        raise ValueError(f"ids, vals and order must share a device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ids, vals and order must be contiguous")
    dev = vals.device
    if dev.type == "cpu":
        return segment_reduce_plain(ids, vals, n, order=order)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    r, p = vals.shape
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_segment_reduce_sorted(
            ids.data_ptr(), None if order is None else order.data_ptr(),
            vals.data_ptr(), p, r, n, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "segment_reduce_kernel")
    segment_reduce_sorted.launches += 1
    return out


segment_reduce_sorted.launches = 0


def segment_reduce_plain(ids: torch.Tensor, vals: torch.Tensor, n: int, *,
                         order: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the items gathered into
    order, each segment's run found by a binary search over the sorted ids
    (``searchsorted``), the runs padded to the longest and summed."""
    if order is not None:
        ids, vals = ids[order.long()], vals[:, order.long()]
    dev = vals.device
    r = vals.shape[0]
    ids_sorted = ids.contiguous()
    bounds = torch.searchsorted(
        ids_sorted, torch.arange(n + 1, dtype=torch.int32, device=dev))
    lo, hi = bounds[:-1], bounds[1:]
    length = hi - lo
    longest = int(length.max()) if n else 0
    out = torch.zeros((n, r), dtype=torch.float32, device=dev)
    if longest == 0:
        return out
    step = max(1, PLAIN_CHUNK_ELEMS // (longest * r))
    k = torch.arange(longest, device=dev)
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        idx = lo[s0:s1, None] + k[None, :]                   # (s, longest)
        take = k[None, :] < length[s0:s1, None]
        idx = torch.where(take, idx, torch.zeros_like(idx))
        gathered = vals[:, idx] * take.to(vals.dtype)        # (R, s, longest)
        out[s0:s1] = gathered.sum(dim=2).T
    return out
