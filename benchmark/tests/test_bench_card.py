"""Each cell run on the card for a few seconds, as the benchmark's command
runs it: the result line, correct, and every end-to-end metric."""
import json
import subprocess
import sys

import pytest

from benchmark.harness import core

CELLS = [w["name"] for w in json.loads(
    (core.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=core.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_judged_incorrect(card, cell):
    """The control (the reference a precision step down in the program's
    place) and each planted fault of the cell's kind, at the cell's own
    size, come out not correct under the rule of a run."""
    core.fixed_caches()
    spec = core.Spec.load(cell)
    kind = spec.kind()
    for fault in [None] + sorted(getattr(kind, "FAULTS", {})):
        run = core.Run(spec, 2147483701, 0.0, False, "cuda")
        numbers = kind.control(run, fault)
        judged, missing, correct = core.judge(numbers, spec.limits)
        assert not missing and correct is False, (fault, judged)
