"""What the benchmark loads: no module of JAX or of the JAX package
anywhere in it, and nothing of the program in its reference. Module
names are compared whole by their top-level part: the program's name
begins with the JAX package's."""
import ast
import json
import subprocess
import sys

from benchmark.harness import core

BENCH_DIR = core.ROOT / "benchmark"
JAX_SIDE = {"jax", "jaxlib", "flax", "guassianhand_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not set(_imports(path)) & JAX_SIDE, path
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert "guassianhand_tpu_torch" not in set(_imports(path)), path


def test_loaded_modules():
    """A tiny run of every cell, then every module in the process."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(core.ROOT)!r})
from benchmark.harness import core
from benchmark.tests.conftest import tiny
import benchmark.reference.models.one_shot, benchmark.reference.train.fit
ref_only = sorted({{m.split('.')[0] for m in sys.modules}})
for cell in ("fit_256_bf16", "render_100k_8x512", "drive_8x512_bf16"):
    core.execute(cell, 7, 0.3, True, t_process=time.perf_counter(),
                 device="cpu", spec=tiny(cell))
print(json.dumps({{"ref_only": ref_only,
                  "all": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=core.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(got["all"]) & JAX_SIDE
    assert "guassianhand_tpu_torch" in got["all"]
    assert "guassianhand_tpu_torch" not in got["ref_only"]


def test_no_card_no_result():
    """Without a card the run fails and prints no result line."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fit_256_bf16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=core.ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_jax_loaded_after_the_window_stops_the_result(monkeypatch):
    """A module of JAX loaded as late as a per-layer reader runs fails the
    run, with no result line."""
    import types
    from benchmark.tests.conftest import run_cell, tiny
    spec = tiny("render_100k_8x512")
    reader = spec.reader

    class Late:
        def __init__(self, mod):
            self.mod = mod

        def read(self, reading):
            sys.modules["jax"] = types.ModuleType("jax")
            return self.mod.read(reading)

    monkeypatch.setattr(spec, "reader", lambda name: Late(reader(name)))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        rc, last, err = run_cell(spec, trace_on=True)
    finally:
        sys.modules.pop("jax", None)
    assert rc != 0 and last is None
    assert "jax" in err.splitlines()[-1]
