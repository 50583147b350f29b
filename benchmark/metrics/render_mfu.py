"""The render's share of the bf16 peak, in %: the operations the
front-to-back rule needs at the traced window's calls (each call's pose
counted as ``k1_roofline.render`` counts it; the projection's few
operations a Gaussian left out) over the window's seconds and 989
TFLOP/s."""
from benchmark.counts.flops import mfu_percent


def read(r):
    calls = r.layer.get("k1_calls")
    if not calls or r.busy_s <= 0:
        return None
    return mfu_percent(sum(n * w["fp32_ops"] for n, w in calls), r.window_s)
