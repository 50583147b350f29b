"""The yardstick's counts against values worked by hand at tiny shapes."""
import torch

from benchmark.counts import bounds, flops


def test_bound():
    assert bounds.bound(3.35e12)["bound_s"] == 1.0
    b = bounds.bound(1.0, fp32_ops=67e12, bf16_flops=989e12)
    assert b["bound_s"] == 2.0 and b["bound_by"] == "operations"


def test_attention_bounds():
    # L = 1000 live rows, 1 head of width 1: 1000 rows, 10^6 scores
    b = bounds.bf16_attention_bounds(1000, 1, 1, sm_clock_mhz=1000.0)
    assert b["forward"]["bytes"] == 2 * 4 * 1000 + 4 * 1000
    assert b["forward"]["bf16_flops"] == 4 * 10 ** 6
    assert b["dkv"]["bf16_flops"] == 8 * 10 ** 6
    assert b["dq"]["bf16_flops"] == 6 * 10 ** 6
    # a million exps at 16 a clock on 132 SMs at 1 GHz
    assert b["forward"]["limited_by"] == "exp"
    assert abs(b["forward"]["bound_s"] - 1e6 / (16 * 132 * 1e9)) < 1e-15
    f = bounds.attention_bounds(2, 1, 1)
    assert f["forward"]["bytes"] == 4 * (4 * 2 + 2)
    assert f["dkv"]["split_tf32_flops"] == 8 * 4


def test_composite_forward_bound():
    b = bounds.composite_forward_bound(n_tiles=4, n_pairs=10, n_rows=3,
                                       height=16, width=16, fp32_ops=670)
    assert b["bytes"] == 4 * 15 + 4 * 27 + 20 * 256
    assert b["bound_by"] == "bytes"


def test_elementwise_ops():
    a, b = torch.ones(5), torch.ones(5)
    assert bounds.elementwise_ops(lambda: (a + b * 2).sum(), 5) == 10


def test_flop_pieces():
    assert flops.attention_core(2, 3, 4) == 96
    assert flops.dense({"x.fc.weight": (3, 4), "x.fc.bias": (3,),
                        "y.weight": (9, 9)}, "x.", 10) == 240
    # VGG19 to relu4_1 at 16 x 16: two convs at 16^2, two at 8^2, four at
    # 4^2, one at 2^2
    want = 2 * 9 * (256 * (3 * 64 + 64 * 64) + 64 * (64 * 128 + 128 * 128)
                    + 16 * (128 * 256 + 3 * 256 * 256) + 4 * 256 * 512)
    assert flops.vgg19(16, 16) == want
    assert flops.mfu_percent(989e12, 2.0) == 50.0
