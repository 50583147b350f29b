"""Tile-composite forward: the CUDA kernel and its plain-PyTorch twin.

Replaces ``guassianhand_tpu/ops/rasterize_pallas.py::composite_forward``
(render-only, ``store_cpx=False``). The kernel source is
``csrc/composite_fwd.cu``; its header note gives the design and what bounds
it. It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` (listed in ``.gitignore``) and loaded with ``ctypes``.

``composite_forward`` sends CUDA tensors to the kernel and CPU tensors to
``composite_plain``; nothing falls back from one to the other.
``composite_forward.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from guassianhand_tpu_torch.ops.binning import grid_dims
from guassianhand_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "composite_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

N_ATTR = 9         # per-Gaussian row: x y A B C opacity r g b
NEG_CLAMP = -30.0  # exponent given to masked slots in the twin
# (tiles x pixels x pairs) elements per chunk of the twin
PLAIN_CHUNK_ELEMS = 1 << 24
# fp32 operations of one pixel x pair step of the kernel's loop, read off its
# body in csrc/composite_fwd.cu: a fused multiply-add counts two, as the
# peak FLOP/s counts it, expf one, a comparison one. Each stage runs only for
# the pairs that passed the gate before it.
OPS_EVALUATED = 12   # dx, dy 2; A dx dx + C dy dy 5; power 4; power > 0 1
OPS_PAST_POWER = 4   # expf 1; alpha = min(0.99, opacity e) 2; alpha < 1/255 1
OPS_PAST_ALPHA = 3   # T (1 - alpha) 2; < 1e-4 1
OPS_ACCEPTED = 7     # w = alpha T 1; three colour multiply-adds 6


def pack_attrs(mean2d, conic, color, opacity) -> torch.Tensor:
    """(N, 9) float32 rows [x, y, A, B, C, opacity, r, g, b]."""
    return torch.cat([mean2d, conic, opacity[:, None], color],
                     dim=1).to(torch.float32).contiguous()


def nvcc_command(output: Path):
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o",
            str(output), str(SOURCE)]


def library_path() -> Path:
    """Build output named by the hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcomposite_fwd_{digest}.so"


def build_library() -> str:
    """Compile the kernel unless this source's library exists. Returns
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


@functools.cache
def _library():
    build_library()
    lib = ctypes.CDLL(str(library_path()))
    fn = lib.gh_composite_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(tile_range, pair_gid, attrs, height, width):
    ntx, nty = grid_dims(height, width)
    if attrs.dtype != torch.float32 or attrs.dim() != 2 \
            or attrs.shape[1] != N_ATTR:
        raise ValueError(f"attrs must be (N, {N_ATTR}) float32, got "
                         f"{tuple(attrs.shape)} {attrs.dtype}")
    if tile_range.dtype != torch.int32 or pair_gid.dtype != torch.int32:
        raise ValueError("tile_range and pair_gid must be int32")
    if tile_range.shape != (ntx * nty + 1,):
        raise ValueError(f"tile_range must be ({ntx * nty + 1},) for a "
                         f"{height}x{width} image, got "
                         f"{tuple(tile_range.shape)}")
    if pair_gid.dim() != 1:
        raise ValueError("pair_gid must be 1-D")
    for name, t in (("tile_range", tile_range), ("pair_gid", pair_gid),
                    ("attrs", attrs)):
        if t.device != attrs.device:
            raise ValueError(f"{name} is on {t.device}, attrs on "
                             f"{attrs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ntx, nty


def composite_forward(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                      attrs: torch.Tensor, *, height: int, width: int):
    """Composite the binned pairs of TILE x TILE tiles. ``tile_range``
    (T+1,) int32 and ``pair_gid`` (P,) int32 from
    ``ops/binning.bin_gaussians``; ``attrs`` from ``pack_attrs``. Returns
    (rgb (H, W, 3), final_t (H, W)) float32."""
    ntx, nty = _check(tile_range, pair_gid, attrs, height, width)
    if attrs.device.type == "cpu":
        return composite_plain(tile_range, pair_gid, attrs, height=height,
                               width=width)
    if attrs.device.type != "cuda":
        raise ValueError(f"unsupported device {attrs.device}")
    rgb = torch.empty((height, width, 3), dtype=torch.float32,
                      device=attrs.device)
    final_t = torch.empty((height, width), dtype=torch.float32,
                          device=attrs.device)
    lib = _library()
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream(attrs.device).cuda_stream
        err = lib.gh_composite_forward(
            tile_range.data_ptr(), pair_gid.data_ptr(), attrs.data_ptr(),
            ntx * nty, ntx, height, width, rgb.data_ptr(),
            final_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd_kernel launch failed: CUDA error "
                           f"{err}")
    composite_forward.launches += 1
    return rgb, final_t


composite_forward.launches = 0


def composite_plain(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                    attrs: torch.Tensor, *, height: int, width: int,
                    count_ops: bool = False):
    """The kernel's function in plain PyTorch, for the CPU tests and for
    holding the kernel to on the card.

    Tiles are taken in chunks; each chunk's pairs are padded to its largest
    tile count, and the compositing uses the dense oracle's exclusive and
    inclusive transmittance products and gates (``ops/rasterize_ref.py``).
    Returns (rgb (H, W, 3), final_t (H, W)); with ``count_ops`` also the
    fp32 operations (``OPS_*``) the kernel's sequential rule needs per pixel
    (H, W): for each pixel's pairs up to and including the one that stops
    it, the stages each pair reaches.
    """
    dev = attrs.device
    ntx, nty = grid_dims(height, width)
    num_tiles = ntx * nty
    p = TILE * TILE
    counts = (tile_range[1:] - tile_range[:-1]).to(torch.int64)
    counts_host = counts.tolist()
    out_rgb = torch.zeros((num_tiles, p, 3), dtype=torch.float32, device=dev)
    out_t = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    out_n = torch.zeros((num_tiles, p), dtype=torch.int64, device=dev)
    lane = torch.arange(p, device=dev)
    lx = (lane % TILE).to(torch.float32)
    ly = (lane // TILE).to(torch.float32)

    t0 = 0
    while t0 < num_tiles:
        cmax = counts_host[t0]
        t1 = t0 + 1
        while t1 < num_tiles and \
                (t1 - t0 + 1) * p * max(cmax, counts_host[t1]) \
                <= PLAIN_CHUNK_ELEMS:
            cmax = max(cmax, counts_host[t1])
            t1 += 1
        if cmax > 0:
            tiles = torch.arange(t0, t1, device=dev)
            slot = torch.arange(cmax, device=dev)
            valid = slot[None, :] < counts[t0:t1, None]            # (tc, c)
            idx = tile_range[t0:t1, None].to(torch.int64) + slot[None, :]
            idx = torch.clamp(idx, max=pair_gid.shape[0] - 1)
            a = attrs[pair_gid[idx].to(torch.int64)]              # (tc, c, 9)
            px = ((tiles % ntx) * TILE).to(torch.float32)[:, None] + lx
            py = ((tiles // ntx) * TILE).to(torch.float32)[:, None] + ly
            dx = a[:, None, :, 0] - px[:, :, None]                 # (tc, p, c)
            dy = a[:, None, :, 1] - py[:, :, None]
            ca = a[:, None, :, 2]
            cb = a[:, None, :, 3]
            cc = a[:, None, :, 4]
            op = a[:, None, :, 5]
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            pmask = valid[:, None, :] & (power <= 0.0)
            power_c = torch.where(pmask, power, torch.full_like(power,
                                                                NEG_CLAMP))
            alpha = torch.clamp(op * torch.exp(power_c), max=ALPHA_MAX)
            alpha = torch.where(pmask & (alpha >= ALPHA_MIN), alpha,
                                torch.zeros_like(alpha))
            cp_incl = torch.cumprod(1.0 - alpha, dim=2)
            cp_excl = torch.cat([torch.ones_like(cp_incl[..., :1]),
                                 cp_incl[..., :-1]], dim=2)
            accept = cp_incl >= T_EPS
            w = alpha * cp_excl * accept.to(alpha.dtype)
            out_rgb[t0:t1] = torch.matmul(w, a[:, :, 6:9])
            out_t[t0:t1] = torch.amin(
                torch.where(accept, cp_incl, torch.ones_like(cp_incl)), dim=2)
            if count_ops:
                # accept is a prefix: evaluations run through the first
                # rejected pair, or through the tile's last pair
                n_eval = torch.minimum(accept.sum(dim=2) + 1,
                                       counts[t0:t1, None])
                evaluated = slot < n_eval[..., None]
                lit = alpha > 0.0
                out_n[t0:t1] = (
                    OPS_EVALUATED * n_eval
                    + OPS_PAST_POWER * (evaluated & pmask).sum(dim=2)
                    + OPS_PAST_ALPHA * (evaluated & lit).sum(dim=2)
                    + OPS_ACCEPTED * (accept & lit).sum(dim=2))
        t0 = t1

    def to_image(x):
        c = x.shape[-1]
        x = x.reshape(nty, ntx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
        return x.reshape(nty * TILE, ntx * TILE, c)[:height, :width]

    rgb = to_image(out_rgb)
    final_t = to_image(out_t[..., None])[..., 0]
    if count_ops:
        return rgb, final_t, to_image(out_n[..., None])[..., 0]
    return rgb, final_t
