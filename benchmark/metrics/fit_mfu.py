"""The fit step's share of the bf16 peak, in %: the counted FLOPs of the
steps in the traced window (``counts/flops.py::fit_step``) over the
window's seconds and 989 TFLOP/s."""
from benchmark.counts.flops import mfu_percent


def read(r):
    steps = r.layer.get("steps", 0)
    if not steps or r.busy_s <= 0:
        return None
    return mfu_percent(steps * r.layer["flops_per_step"], r.window_s)
