"""The traced window: ``torch.profiler`` over the device's activity,
written out as a Chrome trace, and the reductions the per-layer readers
take from it.

The profiler records the device's kernels, copies and sets and the host's
CUDA runtime calls, and not the host's PyTorch operations: recording those
took about 13,000 events a fit step and halved the steps a second, where
the device's activity alone costs about a third of them (NVIDIA H100, fit
cell). So:

- the window runs from the start of its first ``cudaDeviceSynchronize``
  (the one that opens it) to the end of its last (the one that closes it);
- device intervals are the kernel, memcpy and memset events; ``busy_s`` is
  the length of their union inside the window (averaged over the devices
  used), so overlapping streams count once;
- an idle gap is a stretch of the window that no device interval covers;
  it is named by the innermost CUDA runtime call running at its middle,
  or ``host`` where none runs (Python and PyTorch's host code between
  launches).
"""
from __future__ import annotations

import bisect
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.harness.core import OUT

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = "cuda_runtime"
SYNC = "cudaDeviceSynchronize"
NAME_CHARS = 120


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Profiler:
    def __init__(self, device: str):
        acts = [torch.profiler.ProfilerActivity.CUDA if device != "cpu"
                else torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(None, None, None)

    def reading(self, run, win: dict, counts: dict) -> "Reading":
        os.makedirs(OUT, exist_ok=True)
        # one file a cell, overwritten by its next traced run
        path = OUT / f"{run.spec.workload}.trace.json"
        self._prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return Reading(events, run, win, counts, str(path))


class Reading:
    """What a per-layer reader reads: the window's device intervals and
    kernel times, its host spans, and the driver's counts."""

    def __init__(self, events: List[dict], run, win: dict, counts: dict,
                 trace_path: Optional[str] = None):
        self.layer = {**win.get("layer", {}), **counts}
        self.spans = run.spans
        self.trace_path = trace_path
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in xs if e.get("cat") == RUNTIME
                       and e.get("name") == SYNC)
        if syncs:
            w0, w1 = syncs[0][0], syncs[-1][1]
        else:
            w0, w1 = 0.0, float(run.window_s) * 1e6   # no device in the trace
        self.w0, self.w1 = w0, w1
        self.window_s = (w1 - w0) / 1e6
        per_dev: Dict[int, List[Tuple[float, float]]] = {}
        self.kernels: List[Tuple[str, float]] = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t <= s:
                continue
            dev = int(e.get("args", {}).get("device", 0))
            per_dev.setdefault(dev, []).append((s, t))
            self.kernels.append((e.get("name", "?"), (t - s) / 1e6))
        unions = {d: _union(iv) for d, iv in per_dev.items()}
        n_dev = max(1, run.spec.cell["chips"])
        self.busy_s = sum(e - s for u in unions.values() for s, e in u) \
            / 1e6 / n_dev
        main = unions.get(min(unions)) if unions else []
        self._gaps = self._name_gaps(xs, main)

    def idle_percent(self) -> Optional[float]:
        """100 (1 - busy / window); None where no device interval fell in
        the window."""
        if self.busy_s <= 0 or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, name_part: str) -> float:
        """Device seconds in the window of kernels whose name holds
        ``name_part``."""
        return sum(d for n, d in self.kernels if name_part in n)

    def _name_gaps(self, xs, busy) -> List[Tuple[str, float]]:
        gaps, at = [], self.w0
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.w1:
            gaps.append((at, self.w1))

        def intervals(cat):
            return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e.get("name", "?")) for e in xs
                          if e.get("cat") == cat)

        def innermost(rows, starts, t):
            # the covering row that started last: nested rows start later
            i = bisect.bisect_right(starts, t)
            for row in reversed(rows[max(0, i - 512):i]):
                if row[1] >= t:
                    return row[2]
            return None

        calls = intervals(RUNTIME)
        starts = [r[0] for r in calls]
        named: Dict[str, float] = {}
        for s, e in gaps:
            name = innermost(calls, starts, 0.5 * (s + e)) or "host"
            named[name] = named.get(name, 0.0) + (e - s) / 1e6
        return sorted(named.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> List[Tuple[str, float]]:
        sums: Dict[str, float] = {}
        for n, d in self.kernels:
            sums[n] = sums.get(n, 0.0) + d
        return sorted(sums.items(), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:NAME_CHARS], s]
                               for n, s in self.device_ops()[:10]],
                "idle_gaps": [[n[:NAME_CHARS], s]
                              for n, s in self._gaps[:10]]}

    def log_detail(self, stream) -> None:
        """The ``[breakdown]`` lines: window, busy time, the 25 busiest
        device operations and the 25 longest idle-gap names."""
        print(f"[breakdown] window_s {self.window_s!r} busy_s "
              f"{self.busy_s!r} trace {self.trace_path}", file=stream)
        for n, s in self.device_ops()[:25]:
            print(f"[breakdown] device {s!r} {n[:200]}", file=stream)
        for n, s in self._gaps[:25]:
            print(f"[breakdown] idle {s!r} {n[:200]}", file=stream)
