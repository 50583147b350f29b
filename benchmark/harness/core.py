"""One run of one cell: set-up, a measured window, the output check, and
the result line.

Everything that belongs to one cell is found by name. ``BENCHMARK.json``
names the cell's configuration and traffic; the configuration is
``benchmark/configs/<config>.json``; the traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver
module ``benchmark/traffic/<kind>.py``; the limits of the output check are
``benchmark/limits/<workload>.json``; a per-layer metric is read by
``benchmark/metrics/<metric>.py``. A driver module defines

  setup(run) -> state       build, load, warm up; everything before the window
  window(state, run) -> dict  measure until ``run.expired()``, then
                              close the window with ``run.stop()``
  check(state, run) -> {name: value}   the numbers compared, after the window
  counts(state, run, win) -> dict   (traced runs) what the readers count from

``window`` returns ``{"e2e": {metric: value}, "attempted": n, "failed": n,
"layer": {...}}``; the ``layer`` dict and ``counts`` go to the readers.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
# every cache and output the runs write, inside the checkout
CACHE = ROOT / ".bench_cache"
OUT = ROOT / ".bench_out"
FORBIDDEN = ("jax", "jaxlib", "flax", "guassianhand_tpu")


def fixed_caches() -> None:
    """Point the caches a run may fill at fixed directories of the
    checkout (the port builds its kernels into its own ``_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    """A cell as the data files give it."""

    workload: str
    cell: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT

    @staticmethod
    def load(workload: str, root: Path = ROOT) -> "Spec":
        """The cell ``workload`` of ``root/BENCHMARK.json`` and the files
        it names under ``root/benchmark``."""
        bench = read_json(root / "BENCHMARK.json")
        files = root / "benchmark"
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        cell = cells[workload]
        conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
        config = read_json(root / conf["file"])
        traffic = read_json(files / "traffic" / f"{cell['traffic']}.json")

        def here(m):
            return workload in m.get("workloads", [workload])

        limits = read_json(files / "limits" / f"{workload}.json")["limits"]
        return Spec(workload, cell, config, traffic, limits,
                    [m for m in bench["end_to_end"] if here(m)],
                    [m for m in bench["per_layer"] if here(m)], root)

    def kind(self) -> ModuleType:
        k = self.traffic["kind"]
        return load_module(self.root / "benchmark" / "traffic" / f"{k}.py",
                           f"bench_kind_{k}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "benchmark" / "metrics"
                           / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))


class Run:
    """What a driver module gets: the cell, the seed, the device, the
    window's clock and the spans of a traced run."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool,
                 device: str, t_process: Optional[float] = None):
        self.spec = spec
        self.t_process = time.perf_counter() if t_process is None \
            else t_process
        self.config = spec.config
        self.traffic = spec.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.spans: Dict[str, List[float]] = {}
        self._t0 = None
        self._t_end = None
        self.window_s = None

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def start(self) -> None:
        """Opens the window after a synchronise."""
        self.sync()
        self._t0 = time.perf_counter()
        self._t_end = self._t0 + self.seconds

    def expired(self) -> bool:
        return time.perf_counter() >= self._t_end

    def stop(self) -> float:
        """Closes the window after a synchronise; returns its seconds."""
        self.sync()
        self.window_s = time.perf_counter() - self._t0
        return self.window_s

    def mark(self, phase: str) -> None:
        """A ``[setup]`` line on standard error: the seconds since the
        process started at the end of a set-up phase."""
        self.sync()
        print(f"[setup] {phase} {time.perf_counter() - self.t_process!r}",
              file=sys.stderr, flush=True)

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] or None
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def judge(checks: Dict[str, float], limits: Dict[str, float]):
    """(numbers {name: (value, limit)}, names with a limit but no value,
    correct): correct when every limited number was computed, is finite
    and is at most its limit."""
    numbers = {k: (float(v), float(limits[k])) for k, v in checks.items()}
    missing = sorted(set(limits) - set(numbers))
    correct = not missing and all(
        math.isfinite(v) and v <= lim for v, lim in numbers.values())
    return numbers, missing, correct


def host_sample() -> Dict[str, float]:
    """This process's CPU seconds and involuntary context switches, to
    difference over the window."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime,
            "involuntary_switches": float(ru.ru_nivcsw)}


def host_report(before: Dict[str, float], after: Dict[str, float],
                window_s: float) -> str:
    """One ``[host]`` line: the share of the window this process spent on
    a core and its involuntary switches. A host-bound window that reads
    near 1 in slow and fast runs alike ran the same work slower, rather
    than waiting longer."""
    cpu = after["cpu_s"] - before["cpu_s"]
    switches = after["involuntary_switches"] - before["involuntary_switches"]
    return (f"[host] window_s {window_s!r} cpu_share {cpu / window_s!r} "
            f"involuntary_switches {int(switches)} cpus {os.cpu_count()}")


def _number(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            t_process: float, device: Optional[str] = None,
            spec: Optional[Spec] = None) -> int:
    """One run; prints the result line and returns the exit code.
    ``device`` and ``spec`` are the test hook: a CPU device in place of
    the card, and a cell cut to a size a CPU test can hold."""
    spec = spec or Spec.load(workload)
    chips = spec.cell["chips"]
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark: no CUDA device; this benchmark runs on the "
                  "card only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"benchmark: {workload} needs {chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = "cuda"
    run = Run(spec, seed, seconds, trace, device, t_process)
    kind = spec.kind()
    state = kind.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_process
    print(f"[setup] setup_s {setup_s!r}", file=sys.stderr, flush=True)

    prof = None
    if trace:
        from benchmark.harness import trace as tr
        run.seconds = min(seconds, float(spec.traffic["trace_seconds"]))
        prof = tr.Profiler(device)
        prof.__enter__()
    host0 = host_sample()
    run.start()
    win = kind.window(state, run)
    host1 = host_sample()
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                   else 0)
    print(host_report(host0, host1, run.window_s), file=sys.stderr,
          flush=True)

    numbers, missing, correct = judge(kind.check(state, run), spec.limits)

    device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if device != "cpu" else "cpu"),
                   "count": chips, "memory_peak_bytes": int(memory_peak)}
    if device != "cpu":
        device_info["power_limit"] = power_limit()
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        reading = prof.reading(run, win, kind.counts(state, run, win))
        device_info["busy_s"] = reading.busy_s
        device_info["window_s"] = reading.window_s
        for m in spec.per_layer:
            value = spec.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = reading.breakdown()
        reading.log_detail(sys.stderr)
    else:
        for m in spec.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                metrics[m["name"]] = {"value": win["e2e"][m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": correct, "attempted": int(win["attempted"]),
            "failed": int(win["failed"]), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": _number(v), "limit": lim}
                      for k, (v, lim) in numbers.items()}
    for k in missing:
        print(f"check {k}: not computed", file=sys.stderr)
    for k, (v, lim) in numbers.items():
        print(f"check {k} = {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    # last, after the check, the counts and every reader have run
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
