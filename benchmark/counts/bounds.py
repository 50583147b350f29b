"""Peaks and the least time a kernel could take at given work.

Frozen here so that the yardstick does not move with the program: the
arithmetic of the repository's ``chip_smoke.py`` (``bound``,
``attention_bounds``, ``bf16_attention_bounds``, ``elementwise_ops``),
with one correction: ``bound`` takes bf16 tensor-core products apart and
divides them by the bf16 peak, where the original divided every operation
by the float32 peak.

Peaks: NVIDIA H100 SXM data sheet, dense. The special-function units'
exp: 16 a clock on each of the 132 SMs at the data sheet's largest SM
clock, 1,980 MHz. Times are in seconds.
"""
from __future__ import annotations

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK, SMS = 16, 132
SM_CLOCK_MHZ = 1980.0


def bound(n_bytes: float, fp32_ops: float = 0.0, bf16_flops: float = 0.0
          ) -> dict:
    """The least time: bytes over the memory rate, float32 operations
    over the float32 peak plus bf16 products over the bf16 peak, whichever
    is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = fp32_ops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": n_bytes, "fp32_ops": fp32_ops, "bf16_flops": bf16_flops}


def attention_bounds(n_live: int, heads: int, d: int) -> dict:
    """The float32 (split-TF32) flash kernels over L live rows: per score
    the products are 4 D flops forward, 8 D dkv and 6 D dq, run as three
    TF32 products each, and the other operations 4, 5 and 5 on the
    float32 cores; the bound is the largest of the three parts."""
    rows, scores = n_live * heads, n_live * n_live * heads
    out = {}
    for name, n_bytes, product, other in (
            ("forward", 4 * (4 * rows * d + rows), 4 * d, 4),
            ("dkv", 4 * (6 * rows * d + 2 * rows), 8 * d, 5),
            ("dq", 4 * (5 * rows * d + 2 * rows), 6 * d, 5)):
        times = {"bytes": n_bytes / PEAK_BYTES_PER_S,
                 "tensor_cores": product * scores / (PEAK_TF32_FLOPS / 3),
                 "fp32_cores": other * scores / PEAK_FP32_FLOPS}
        by = max(times, key=times.get)
        out[name] = {"bound_s": times[by], "limited_by": by,
                     "bytes": n_bytes, "split_tf32_flops": product * scores,
                     "fp32_ops": other * scores}
    return out


def bf16_attention_bounds(n_live: int, heads: int, d: int,
                          sm_clock_mhz: float = SM_CLOCK_MHZ) -> dict:
    """The bf16 flash kernels over L live rows: the larger of the products
    on the tensor cores (4 D flops a score forward, 8 D dkv, 6 D dq), one
    exp a score on the special-function units, and the bytes (q, k, v,
    dout, out, dq, dk, dv 2 bytes a value, lse and delta 4 a row, each
    read or written once)."""
    rows, scores = n_live * heads, n_live * n_live * heads
    sfu_per_s = SFU_PER_CLOCK * SMS * sm_clock_mhz * 1e6
    out = {}
    for name, n_bytes, product in (
            ("forward", 2 * 4 * rows * d + 4 * rows, 4 * d),
            ("dkv", 2 * 6 * rows * d + 8 * rows, 8 * d),
            ("dq", 2 * 5 * rows * d + 8 * rows, 6 * d)):
        times = {"bytes": n_bytes / PEAK_BYTES_PER_S,
                 "tensor_cores": product * scores / PEAK_BF16_FLOPS,
                 "exp": scores / sfu_per_s}
        by = max(times, key=times.get)
        out[name] = {"bound_s": times[by], "limited_by": by,
                     "bytes": n_bytes, "bf16_flops": product * scores,
                     "exps": scores}
    return out


def composite_forward_bound(n_tiles: int, n_pairs: int, n_rows: int,
                            height: int, width: int, fp32_ops: int) -> dict:
    """The forward composite (K1): its fp32 operations at these inputs
    (``reference/ops/rasterize.py``'s work count) and its inputs and
    outputs read or written once: the tile ranges and pair ids (4 bytes
    each), the packed rows (9 floats a Gaussian row) and the image, final
    transmittance and contributor count (5 values a pixel)."""
    n_bytes = 4 * (n_tiles + 1 + n_pairs) + 4 * 9 * n_rows + 20 * height * width
    return bound(n_bytes, fp32_ops=fp32_ops)


def elementwise_ops(fn, n: int, views: int = 0) -> int:
    """The operations of a function written on (N,) vectors, or on (V, N)
    for ``views`` V: the elements of every PyTorch call in ``fn`` that
    gives a tensor of that shape, indexing excluded."""
    from torch.overrides import TorchFunctionMode
    count = [0]
    shape = (views, n) if views else (n,)

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is not torch.Tensor.__getitem__ \
                    and isinstance(out, torch.Tensor) and out.shape == shape:
                count[0] += out.numel()
            return out

    with Count():
        fn()
    return count[0]
