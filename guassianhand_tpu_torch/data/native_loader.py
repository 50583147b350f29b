"""ctypes binding of the native image loader ``native/gh_loader.cpp``
(counterpart of ``data/native_loader.py``), the same shared library the
JAX package loads.

The library is built on first use by ``make -C native`` (a C++17 compiler,
libjpeg and libpng) into ``native/libgh_loader.so``, which git ignores.
``decode_image(path)`` gives (H, W, 3) float32 in [0, 1];
``PrefetchPool`` decodes and masks on native threads. Where the library
cannot be built or loaded, or cannot decode a file, both fall back to PIL
(imported only then), as the JAX package does; where PIL is missing too,
they raise an error that says why the native build failed.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "native")
MAX_HW = 4096
_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def _library() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the loaded library, "") or (None, why it is not there)."""
    so = os.path.join(NATIVE_DIR, "libgh_loader.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                           capture_output=True, text=True)
        except FileNotFoundError:
            return None, "`make` is not installed"
        except subprocess.CalledProcessError as e:
            return None, (f"`make -C {NATIVE_DIR}` failed (a C++ compiler, "
                          f"libjpeg and libpng are needed): "
                          f"{(e.stderr or e.stdout).strip()[-400:]}")
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        return None, f"{so} does not load: {e}"
    i, p, cp = ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
    pi = ctypes.POINTER(ctypes.c_int)
    for name, res, args in (
            ("gh_decode_image", i, [cp, p, i, i, pi, pi]),
            ("gh_pool_create", p, [i]),
            ("gh_pool_destroy", None, [p]),
            ("gh_pool_submit", i, [p, i, cp, cp]),
            ("gh_pool_wait", i, [p, i, p, p, i, i, pi, pi])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib, ""


def native_library() -> Tuple[Optional[ctypes.CDLL], str]:
    """The library, built on the first call: (lib, "") or (None, the
    reason it is missing)."""
    with _LOCK:
        return _library()


def pil_image(reason: Optional[str] = None):
    """``PIL.Image``, imported now; where PIL is not installed, an error
    that says why the native decoder did not serve either (``reason``, by
    default why the library is missing)."""
    try:
        import PIL.Image
    except ImportError:
        if reason is None:
            reason = native_library()[1] or "not asked for"
        raise RuntimeError(f"no image decoder: the native loader is missing "
                           f"({reason}) and PIL is not installed") from None
    return PIL.Image


def decode_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]."""
    lib, reason = native_library()
    if lib is not None:
        buf = np.empty((MAX_HW, MAX_HW, 3), np.float32)
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = lib.gh_decode_image(path.encode(), buf.ctypes.data, MAX_HW,
                                 MAX_HW, ctypes.byref(h), ctypes.byref(w))
        if rc == 0:
            return buf.reshape(-1)[:h.value * w.value * 3].reshape(
                h.value, w.value, 3).copy()
        reason = f"the native decoder returned {rc} for {path}"
    image = pil_image(reason)
    return np.asarray(image.open(path).convert("RGB"), np.float32) / 255.0


class PrefetchPool:
    """Decode and mask images on native threads: ``submit`` returns a
    ticket, ``wait(ticket)`` the (rgb (H, W, 3), mask (H, W)) pair, rgb
    zeroed where the mask (a pixel's value >= 100) is 0. Without the
    library the work is done at ``submit``, through ``decode_image``."""

    def __init__(self, n_threads: int = 4):
        self._lib, self._reason = native_library()
        self._pool = (self._lib.gh_pool_create(n_threads)
                      if self._lib is not None else None)
        self._ticket = 0
        self._done = {}

    def submit(self, img_path: str, mask_path: Optional[str] = None) -> int:
        self._ticket += 1
        t = self._ticket
        if self._pool is not None:
            rc = self._lib.gh_pool_submit(
                self._pool, t, img_path.encode(),
                mask_path.encode() if mask_path else None)
            if rc != 0:
                raise IOError(f"native submit of {img_path} failed ({rc})")
            return t
        img = decode_image(img_path)
        mask = np.ones(img.shape[:2], np.float32)
        if mask_path:
            m = np.asarray(pil_image(self._reason).open(mask_path))
            mask = ((m.mean(-1) if m.ndim == 3 else m) >= 100).astype(
                np.float32)
            img = img * mask[..., None]
        self._done[t] = (img, mask)
        return t

    def wait(self, ticket: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._pool is None:
            return self._done.pop(ticket)
        rgb = np.empty((MAX_HW, MAX_HW, 3), np.float32)
        mask = np.empty((MAX_HW, MAX_HW), np.float32)
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.gh_pool_wait(self._pool, ticket, rgb.ctypes.data,
                                    mask.ctypes.data, MAX_HW, MAX_HW,
                                    ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            raise IOError(f"native sample load failed ({rc})")
        hw = h.value * w.value
        return (rgb.reshape(-1)[:hw * 3].reshape(h.value, w.value, 3).copy(),
                mask.reshape(-1)[:hw].reshape(h.value, w.value).copy())

    def close(self) -> None:
        if self._pool is not None:
            self._lib.gh_pool_destroy(self._pool)
            self._pool = None
