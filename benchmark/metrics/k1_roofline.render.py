"""The forward composite's share of its roofline in the render, in %: the
summed least times (``counts/bounds.py::composite_forward_bound``) of the
calls in the traced window, each at the operations the reference's
binning and front-to-back rule count for that call's pose, over the
device time of ``composite_fwd_kernel`` there."""
from benchmark.counts.bounds import composite_forward_bound


def read(r):
    seconds = r.kernel_seconds("composite_fwd_kernel")
    calls = r.layer.get("k1_calls")
    if not calls or seconds <= 0:
        return None
    total = sum(n * composite_forward_bound(**w)["bound_s"]
                for n, w in calls)
    return 100.0 * total / seconds
