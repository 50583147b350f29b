"""The benchmark's data files: every cell, configuration, traffic kind,
limit and per-layer reader is found by name, ``BENCHMARK.json`` keeps
the shape its readers expect, and a new cell is added by new files
alone."""
import json
import math
import re
import shutil

import pytest

from benchmark.harness import core
from benchmark.tests.conftest import run_cell, tiny

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec = core.Spec.load(cell)
    kind = spec.kind()
    for fn in ("setup", "window", "check", "counts", "control"):
        assert callable(getattr(kind, fn)), fn
    assert spec.limits and all(math.isfinite(v) for v in spec.limits.values())
    assert spec.end_to_end and spec.per_layer
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in spec.per_layer:
        assert callable(spec.reader(m["name"]).read)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert set(m) - {"workloads"} == KEYS[group], m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
            if group == "end_to_end":
                assert 0.01 <= m["bound"] <= 0.25
                assert m["source"] in ("host_clock", "device_trace")
            else:
                assert m["moves"] in e2e
                moved = next(e for e in BENCH["end_to_end"]
                             if e["name"] == m["moves"])
                assert set(m["workloads"]) <= set(moved.get("workloads",
                                                             CELLS))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_new_cell_by_new_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell with its limits and a per-layer reader, each a new file or a new
    entry of BENCHMARK.json, and the harness runs the new cell and reads
    the new metric without an edit to any file it had."""
    shutil.copytree(core.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    files = tmp_path / "benchmark"
    cfg = json.loads((files / "configs" / "render_100k.json").read_text())
    cfg["scene"]["views"] = 2
    (files / "configs" / "render_2v.json").write_text(json.dumps(cfg))
    traffic = json.loads((files / "traffic" / "render_8x512.json")
                         .read_text())
    traffic["poses"] = 3
    (files / "traffic" / "render_3poses.json").write_text(json.dumps(traffic))
    (files / "limits" / "render_2v.json").write_text(
        (files / "limits" / "render_100k_8x512.json").read_text())
    (files / "metrics" / "calls.render_2v.py").write_text(
        "def read(r):\n    return float(r.layer['calls'])\n")
    bench["configs"].append(dict(bench["configs"][1], name="render_2v",
                                 file="benchmark/configs/render_2v.json"))
    bench["workloads"].append({"name": "render_2v", "config": "render_2v",
                               "traffic": "render_3poses", "chips": 1,
                               "why": "two views"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "render_100k_8x512" in m["workloads"]:
            m["workloads"].append("render_2v")
    bench["per_layer"].append({"name": "calls.render_2v", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "ops/rasterize.py",
                               "moves": "views_per_s",
                               "workloads": ["render_2v"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = tiny("render_2v", root=tmp_path)
    assert spec.config["scene"]["views"] == 2
    rc, last, _ = run_cell(spec)
    assert rc == 0 and last["correct"] and "views_per_s" in last["metrics"]
    rc, last, _ = run_cell(spec, trace_on=True)
    assert rc == 0 and last["metrics"]["calls.render_2v"]["value"] >= 1
