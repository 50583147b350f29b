"""The port's utils/debug.py and utils/profiling.py against the JAX
package's: the finite report's paths and values, ``checked`` raising where
checkify.float_checks raises, the anomaly print, ``timed``, and the FLOPs
of a matmul (exact comparisons)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.utils import debug as jdebug
from guassianhand_tpu.utils import profiling as jprof
from guassianhand_tpu_torch.utils import debug, profiling
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_tree_finite_report_equals_jax():
    """The same leaf paths (dict keys, ``[i]`` for sequence items), the
    same finite flags and max |value|s, integer leaves left out; and
    assert_tree_finite names the bad leaf."""
    nan = float("nan")
    tree = {"a": {"b": [1.0, -3.0]}, "l": [[0.0], ([nan, 2.0], [7])],
            "s": 2.5, "i": [1, 2, 3], "inf": {"x": [float("-inf"), 1.0]}}

    def build(array, ints):
        return {"a": {"b": array(tree["a"]["b"])},
                "l": [array(tree["l"][0]),
                      (array(tree["l"][1][0]), ints(tree["l"][1][1]))],
                "s": tree["s"], "i": ints(tree["i"]),
                "inf": {"x": array(tree["inf"]["x"])}}

    want = jdebug.tree_finite_report(build(
        lambda v: jnp.asarray(v, jnp.float32),
        lambda v: jnp.asarray(v, jnp.int32)))
    got = debug.tree_finite_report(build(
        lambda v: torch.tensor(v, dtype=torch.float32),
        lambda v: torch.tensor(v, dtype=torch.int32)))
    assert set(got) == set(want) == {"a/b", "l/[0]", "l/[1]/[0]", "s",
                                     "inf/x"}
    for k in want:
        assert got[k][0] == want[k][0], k
        np.testing.assert_equal(got[k][1], want[k][1])
    with pytest.raises(FloatingPointError, match=r"inf/x.*l/\[1\]/\[0\]"):
        debug.assert_tree_finite(build(torch.tensor, torch.tensor), "step 3")


PROBES = {"log(-1)": (torch.log, jnp.log, -1.0),
          "1/0": (lambda x: 1.0 / x, lambda x: 1.0 / x, 0.0),
          "nan*2": (lambda x: x * 2, lambda x: x * 2, float("nan")),
          "inf-inf": (lambda x: x - x, lambda x: x - x, float("inf")),
          "exp(1000)": (torch.exp, jnp.exp, 1000.0)}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_checked_raises_where_checkify_does(probe):
    """``checked`` raises FloatingPointError on the probes where JAX's
    ``checked`` raises (a NaN output, a division by zero), and passes
    the overflow to inf as JAX's does."""
    tfn, jfn, x = PROBES[probe]
    try:
        jdebug.checked(jfn)(jnp.float32(x))
        jax_raised = False
    except Exception:       # checkify's error type is jax-internal
        jax_raised = True
    if jax_raised:
        with pytest.raises(FloatingPointError):
            debug.checked(tfn)(torch.tensor(x))
    else:
        out = debug.checked(tfn)(torch.tensor(x))
        assert float(out) == float(jfn(jnp.float32(x)))
    assert jax_raised == (probe != "exp(1000)")


def test_debug_assert_finite_prints_and_passes(capsys):
    x = torch.tensor([1.0, float("inf"), float("nan"), 2.0])
    assert debug.debug_assert_finite(x, "scene_codes") is x
    assert capsys.readouterr().out == \
        "[anomaly] scene_codes has 2 non-finite values\n"
    debug.debug_assert_finite(torch.ones(3), "fine")
    assert capsys.readouterr().out == ""


def test_timed_cost_analysis_and_trace(tmp_path):
    """``timed`` as tests/test_data.py holds JAX's; ``cost_analysis``'s
    flops equal XLA's for an (8, 16) x (16, 4) matmul; ``trace_context``
    writes a Chrome trace holding its scope's name."""
    dt, res = profiling.timed(lambda x: x * 2, torch.ones(8), iters=3,
                              warmup=1)
    assert dt > 0 and float(res.sum()) == 16
    a, b = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    want = jprof.cost_analysis(lambda x, y: x @ y, jnp.asarray(a),
                               jnp.asarray(b))
    want = want[0] if isinstance(want, list) else want
    got = profiling.cost_analysis(lambda x, y: x @ y, torch.from_numpy(a),
                                  torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 1024
    with profiling.trace_context("fit_step", str(tmp_path)):
        torch.ones(4).sum()
    assert "fit_step" in (tmp_path / "fit_step.json").read_text()
