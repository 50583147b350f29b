"""Shared pieces of the benchmark's tests: the ``card`` marker, cells cut
to a size a CPU test holds, and one run of a cell through the harness.

The tests import the program (``guassianhand_tpu_torch``) to drive it and
the reference beside it; no test here imports JAX. Run them from the root
of the repository: ``python -m pytest benchmark/tests -q``.
"""
import copy
import time
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark.harness import core, trace

TINY_MODEL = {"camera_embed_dim": 32, "pose_embed_dim": 32, "plane_size": 8,
              "token_channels": 32, "backbone_layers": 1, "backbone_heads": 2,
              "backbone_head_dim": 16, "residual_map_hw": [32, 64]}
SEED = 2 ** 31 + 12345
TINY_MESH = {"rings": 6, "ring": 8, "cap_ring": 4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def card():
    """Skips the test where no CUDA device is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def one_thread_and_tmp_out(monkeypatch, tmp_path):
    """One torch thread (several test workers share the CPU), and traces
    written under the test's temporary directory."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(trace, "OUT", tmp_path)
    # a configuration's switches (oneshot.set_env) last for its test only
    monkeypatch.delenv("GH_FLASH_ATTN", raising=False)
    yield
    torch.set_num_threads(threads)


def tiny(workload: str, root=core.ROOT) -> core.Spec:
    """The cell with the model's widths, the mesh and the images cut to a
    CPU test's size; traffic and limits as the chip's."""
    s = core.Spec.load(workload, root)
    s.config = copy.deepcopy(s.config)
    if "experiment" in s.config:
        s.config["experiment"]["model"].update(TINY_MODEL)
    s.config["scene"].update({"mesh": TINY_MESH, "subdivide": 0})
    t = dict(s.traffic, trace_seconds=0.3)
    if "check_range" in t:
        t["check_range"] = 2
    for k in ("height", "width"):
        if k in t:
            t[k] = 32
        if k in s.config["scene"]:
            s.config["scene"][k] = 32
    s.traffic = t
    return s


def run_cell(spec: core.Spec, trace_on: bool = False, seconds: float = 0.5):
    """(exit code, the last line of standard output as a dict or None,
    standard error) of one run on the CPU."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = core.execute(spec.workload, SEED, seconds, trace_on,
                          t_process=time.perf_counter(), device="cpu", spec=spec)
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if lines else None
    return rc, last, err.getvalue()
