"""A drive request's share of the bf16 peak, in %: the counted FLOPs of
the requests in the traced window (``counts/flops.py::request``) over the
window's seconds and 989 TFLOP/s."""
from benchmark.counts.flops import mfu_percent


def read(r):
    flops = r.layer.get("flops_in_window")
    if not flops or r.busy_s <= 0:
        return None
    return mfu_percent(flops, r.window_s)
