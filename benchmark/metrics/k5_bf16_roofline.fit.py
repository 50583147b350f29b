"""The bf16 flash attention's share of its roofline in the fit, in %: the
summed least times of its forward, dkv and dq kernels at the step's
interacting rows (``counts/bounds.py::bf16_attention_bounds``) times the
steps in the traced window, over the three kernels' device time there."""
from benchmark.counts.bounds import bf16_attention_bounds

KERNELS = ("flash_fwd_bf16_kernel", "flash_dkv_bf16_kernel",
           "flash_dq_bf16_kernel")


def read(r):
    steps = r.layer.get("steps", 0)
    seconds = sum(r.kernel_seconds(k) for k in KERNELS)
    if not steps or seconds <= 0:
        return None
    b = bf16_attention_bounds(r.layer["k5_rows"], r.layer["k5_heads"],
                              r.layer["k5_head_dim"])
    return 100.0 * steps * sum(v["bound_s"] for v in b.values()) / seconds
