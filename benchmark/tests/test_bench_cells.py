"""Each cell's traffic driven through the harness at a CPU test's size,
with and without the trace, and the last line it prints."""
import pytest

from benchmark.tests.conftest import run_cell, tiny

CELLS = ["fit_256_bf16", "render_100k_8x512", "drive_8x512_bf16"]


@pytest.mark.parametrize("trace_on", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_last_line(cell, trace_on):
    spec = tiny(cell)
    rc, last, err = run_cell(spec, trace_on)
    assert rc == 0, err[-2000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True, last["checks"]
    assert last["attempted"] >= 1 and last["failed"] == 0
    assert set(last["checks"]) == set(spec.limits)
    for name, c in last["checks"].items():
        assert c["limit"] == spec.limits[name]
    # the checks are the last lines of standard error, one a number
    tail = err.strip().splitlines()[-len(spec.limits):]
    assert all(line.startswith("check ") for line in tail)
    dev = last["device"]
    assert dev["count"] == 1 and "memory_peak_bytes" in dev
    if trace_on:
        assert {"busy_s", "window_s"} <= set(dev) and "breakdown" in last
        for key in ("device_ops", "idle_gaps"):
            assert len(last["breakdown"][key]) <= 10
    else:
        want = {m["name"] for m in spec.end_to_end}
        assert set(last["metrics"]) == want
        for name, m in last["metrics"].items():
            assert m["value"] > 0, name
