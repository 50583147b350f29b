"""Builds the port's CUDA kernels and loads them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface and becomes its own
shared library, compiled with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` (listed in ``.gitignore``). A library may carry flags of its
own after the common ones (``CudaLibrary(flags=...)``): the bf16 flash
attention links libcuda (``-lcuda``, for ``cuTensorMapEncodeTiled``, which
encodes its TMA tensor maps; nvcc finds the stub of libcuda in the
toolkit). A library's file name carries a hash of its source, the
shared headers (``csrc/*.cuh``) and all its flags, so a stale build is never
loaded. ``build_all`` starts one ``nvcc`` per source
at once and waits for all of them. Every
pointer crosses as ``c_void_p``; a launch function returns
``cudaGetLastError()`` and the wrapper raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p   # a pointer or the stream
I = ctypes.c_int
F = ctypes.c_float


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One ``csrc/`` source and the C functions it exports, each with its
    ctypes argument types; every function returns an int error code.
    ``flags``: nvcc flags of this library alone, given after the source
    (libraries to link, include paths)."""

    def __init__(self, source: str, functions: Dict[str, Sequence],
                 flags: Sequence[str] = ()):
        self.source = CSRC / source
        self.functions = functions
        self.flags = tuple(flags)
        self._lib = None

    @property
    def name(self) -> str:
        return self.source.stem

    def path(self) -> Path:
        # the shared headers too: a source may include any of them
        text = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        flags = " ".join((*NVCC_FLAGS, *self.flags))
        digest = hashlib.sha256(text + flags.encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def build(self) -> str:
        """Compile unless this source's library exists; nvcc's output
        (``-Xptxas -v``: registers, shared memory, spills)."""
        return build_all([self])[self.name]

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.path()))
            for fn_name, argtypes in self.functions.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def build_all(libraries: Iterable[CudaLibrary]) -> Dict[str, str]:
    """Compile every library that is not built yet, one ``nvcc`` each, all
    started together. Returns each library's nvcc output ("" if it was
    already built); raises if any compile fails."""
    running = []
    out = {}
    for lib in libraries:
        target = lib.path()
        if target.exists():
            out[lib.name] = ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(lib.source),
               *lib.flags]
        running.append((lib, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for lib, target, tmp, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.source.name}: nvcc failed "
                          f"({proc.returncode}):\n{text}")
            continue
        os.replace(tmp, target)
        out[lib.name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def check_launch(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
