"""Sorted-segment sum: the CUDA kernel and its plain-PyTorch twin
(counterpart of ``ops/segreduce_pallas.py``).

``segment_reduce_sorted`` replaces
``guassianhand_tpu/ops/segreduce_pallas.py::segment_reduce_sorted``; the
kernel source is ``csrc/segment_reduce.cu``, whose header note gives its
design and what bounds it. The wrapper sends CUDA tensors to the kernel and
CPU tensors to ``segment_reduce_plain``; nothing falls back from one to the
other. ``segment_reduce_sorted.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from guassianhand_tpu_torch.ops.cuda_build import (I, P, CudaLibrary,
                                                   check_launch)

LIB = CudaLibrary("segment_reduce.cu", {
    "gh_segment_reduce_sorted": [P, P, I, I, I, P, P]})
# segments per chunk of the twin's padded gather
PLAIN_CHUNK_ELEMS = 1 << 24


def segment_reduce_sorted(ids_sorted: torch.Tensor, vals: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Per-segment sums of ``vals`` (R, P) float32 over ``ids_sorted`` (P,)
    int32 ascending. Ids >= n are dropped. Returns (n, R) float32."""
    if ids_sorted.dtype != torch.int32 or ids_sorted.dim() != 1:
        raise ValueError("ids_sorted must be 1-D int32")
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[1] != ids_sorted.shape[0]:
        raise ValueError(f"vals must be (R, {ids_sorted.shape[0]}) float32, "
                         f"got {tuple(vals.shape)} {vals.dtype}")
    if vals.device != ids_sorted.device:
        raise ValueError(f"ids_sorted is on {ids_sorted.device}, vals on "
                         f"{vals.device}")
    if not (vals.is_contiguous() and ids_sorted.is_contiguous()):
        raise ValueError("ids_sorted and vals must be contiguous")
    dev = vals.device
    if dev.type == "cpu":
        return segment_reduce_plain(ids_sorted, vals, n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    r, p = vals.shape
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_segment_reduce_sorted(
            ids_sorted.data_ptr(), vals.data_ptr(), p, r, n, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "segment_reduce_kernel")
    segment_reduce_sorted.launches += 1
    return out


segment_reduce_sorted.launches = 0


def segment_reduce_plain(ids_sorted: torch.Tensor, vals: torch.Tensor,
                         n: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each segment's run found by
    a binary search over the sorted ids (``searchsorted``), the runs padded
    to the longest and summed."""
    dev = vals.device
    r = vals.shape[0]
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
