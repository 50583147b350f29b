"""Tracing and timing helpers (counterpart of ``utils/profiling.py``):
``torch.profiler`` scopes, wall time with the device synchronised, and the
FLOPs of a call counted by ``torch.utils.flop_counter``."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace_context(name: str, trace_dir: Optional[str] = None):
    """A named profiler scope; with ``trace_dir`` the block is also traced
    (host and, where there is a card, device) and written there as a Chrome
    trace, ``{trace_dir}/{name}.json``, viewable in Perfetto."""
    if not trace_dir:
        with torch.profiler.record_function(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


def _synchronize(result) -> None:
    """Waits for the device when any tensor of ``result`` lives on CUDA."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in tree_leaves(result)):
        torch.cuda.synchronize()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """Wall time of ``fn(*args, **kwargs)`` with the device synchronised
    before and after the timed calls. Returns (mean_seconds, last_result)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _synchronize(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _synchronize(result)
    return (time.perf_counter() - t0) / iters, result


def cost_analysis(fn: Callable, *args, **kwargs) -> dict:
    """{"flops": the floating-point operations of one call}, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (a multiply-add is 2)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}
