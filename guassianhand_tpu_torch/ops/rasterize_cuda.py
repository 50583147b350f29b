"""Tile composite, forward and backward: the CUDA kernels and their
plain-PyTorch twins.

- ``composite_forward`` replaces
  ``guassianhand_tpu/ops/rasterize_pallas.py::composite_forward`` (source
  ``csrc/composite_fwd.cu``). Render mode returns (rgb, final_t); training
  mode (``store_contrib``) also returns ``n_contrib``, what the backward
  needs.
- ``composite_backward`` replaces ``composite_backward`` of the same file
  (source ``csrc/composite_bwd.cu``): per-pair gradients of the packed
  attributes.

The header note of each source gives its design and what bounds it. Each
wrapper sends CUDA tensors to its kernel and CPU tensors to its twin
(``composite_plain``, ``composite_backward_plain``); nothing falls back from
one to the other. ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from guassianhand_tpu_torch.ops.binning import grid_dims
from guassianhand_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE
from guassianhand_tpu_torch.ops.cuda_build import (I, P, CudaLibrary,
                                                   check_launch)

N_ATTR = 9         # per-Gaussian row: x y A B C opacity r g b
NEG_CLAMP = -30.0  # exponent given to masked slots in the twins
# (tiles x pixels x pairs) elements per chunk of the twins
PLAIN_CHUNK_ELEMS = 1 << 24
# fp32 operations of one pixel x pair step of the forward kernel's loop, read
# off its body in csrc/composite_fwd.cu: a fused multiply-add counts two, as
# the peak FLOP/s counts it, expf one, a comparison one. Each stage runs only
# for the pairs that passed the gate before it.
OPS_EVALUATED = 12   # dx, dy 2; A dx dx + C dy dy 5; power 4; power > 0 1
OPS_PAST_POWER = 4   # expf 1; alpha = min(0.99, opacity e) 2; alpha < 1/255 1
OPS_PAST_ALPHA = 3   # T (1 - alpha) 2; < 1e-4 1
OPS_ACCEPTED = 7     # w = alpha T 1; three colour multiply-adds 6
# The backward kernel's step (csrc/composite_bwd.cu), for the pairs before
# the pixel's n_contrib: the forward's gates, then for a live pair
# 1 - alpha 1, T / (1 - alpha) 1, w 1, e 5, dalpha 3, r += w e 2,
# dpower 1, d mean 8, d conic 8, d opacity 1, d colour 3, and the 9 adds
# that sum the pair's gradient over the tile's pixels.
OPS_BWD_EVALUATED = 12
OPS_BWD_PAST_POWER = 4
OPS_BWD_LIVE = 43

FORWARD_LIB = CudaLibrary("composite_fwd.cu", {
    "gh_composite_forward": [P, P, P, I, I, I, I, P, P, P, P]})
BACKWARD_LIB = CudaLibrary("composite_bwd.cu", {
    "gh_composite_backward": [P, P, P, I, I, I, I, P, P, P, P, I, P, P]})


def pack_attrs(mean2d, conic, color, opacity) -> torch.Tensor:
    """(N, 9) float32 rows [x, y, A, B, C, opacity, r, g, b]."""
    return torch.cat([mean2d, conic, opacity[:, None], color],
                     dim=1).to(torch.float32).contiguous()


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
    if attrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {attrs.device}")
    return ntx, nty


def _check_image(name, t, shape, dtype, device):
    if t.shape != shape or t.dtype != dtype or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def composite_forward(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                      attrs: torch.Tensor, *, height: int, width: int,
                      store_contrib: bool = False):
    """Composite the binned pairs of TILE x TILE tiles. ``tile_range``
    (T+1,) int32 and ``pair_gid`` (P,) int32 from
    ``ops/binning.bin_gaussians``; ``attrs`` from ``pack_attrs``. Returns
    (rgb (H, W, 3), final_t (H, W)) float32, and with ``store_contrib`` also
    n_contrib (H, W) int32: the count of the tile's pairs up to and including
    the pixel's last composited pair."""
    ntx, nty = _check(tile_range, pair_gid, attrs, height, width)
    if attrs.device.type == "cpu":
        return composite_plain(tile_range, pair_gid, attrs, height=height,
                               width=width, store_contrib=store_contrib)
    dev = attrs.device
    rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    contrib = (torch.empty((height, width), dtype=torch.int32, device=dev)
               if store_contrib else None)
    lib = FORWARD_LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_composite_forward(
            tile_range.data_ptr(), pair_gid.data_ptr(), attrs.data_ptr(),
            ntx * nty, ntx, height, width, rgb.data_ptr(), final_t.data_ptr(),
            None if contrib is None else contrib.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "composite_fwd_kernel")
    composite_forward.launches += 1
    return (rgb, final_t, contrib) if store_contrib else (rgb, final_t)


composite_forward.launches = 0


def composite_backward(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                       attrs: torch.Tensor, grad_rgb: torch.Tensor,
                       grad_t: torch.Tensor, final_t: torch.Tensor,
                       n_contrib: torch.Tensor, *, height: int, width: int):
    """Per-pair gradients (9, P) float32 of the packed attributes, row c
    the component c of every pair in binned order, from dL/drgb (H, W, 3),
    dL/dfinal_t (H, W) and the training-mode forward's final_t and
    n_contrib."""
    ntx, nty = _check(tile_range, pair_gid, attrs, height, width)
    dev = attrs.device
    for name, t, shape, dtype in (
            ("grad_rgb", grad_rgb, (height, width, 3), torch.float32),
            ("grad_t", grad_t, (height, width), torch.float32),
            ("final_t", final_t, (height, width), torch.float32),
            ("n_contrib", n_contrib, (height, width), torch.int32)):
        _check_image(name, t, shape, dtype, dev)
    if dev.type == "cpu":
        return composite_backward_plain(
            tile_range, pair_gid, attrs, grad_rgb, grad_t, final_t,
            n_contrib, height=height, width=width)
    n_pairs = pair_gid.shape[0]
    out = torch.empty((N_ATTR, n_pairs), dtype=torch.float32, device=dev)
    lib = BACKWARD_LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_composite_backward(
            tile_range.data_ptr(), pair_gid.data_ptr(), attrs.data_ptr(),
            ntx * nty, ntx, height, width, grad_rgb.data_ptr(),
            grad_t.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
            n_pairs, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "composite_bwd_kernel")
    composite_backward.launches += 1
    return out


composite_backward.launches = 0


# --- the plain twins ------------------------------------------------------

def _tile_chunks(counts_host, num_tiles):
    """Runs of consecutive tiles [t0, t1) whose pairs, padded to the run's
    largest count cmax, stay within PLAIN_CHUNK_ELEMS elements."""
    p = TILE * TILE
    t0 = 0
    while t0 < num_tiles:
        cmax = counts_host[t0]
        t1 = t0 + 1
        while t1 < num_tiles and \
                (t1 - t0 + 1) * p * max(cmax, counts_host[t1]) \
                <= PLAIN_CHUNK_ELEMS:
            cmax = max(cmax, counts_host[t1])
            t1 += 1
        yield t0, t1, cmax
        t0 = t1


def _chunk_alpha(tile_range, pair_gid, attrs, counts, t0, t1, cmax, ntx):
    """The (tiles, pixels, pairs) evaluation of one chunk, with the kernels'
    operation order and gates. ``alpha`` is 0 where a gate rejects the pair
    or the slot is padding."""
    dev = attrs.device
    lane = torch.arange(TILE * TILE, device=dev)
    tiles = torch.arange(t0, t1, device=dev)
    slot = torch.arange(cmax, device=dev)
    valid = slot[None, :] < counts[t0:t1, None]                    # (tc, c)
    idx = tile_range[t0:t1, None].to(torch.int64) + slot[None, :]
    idx = torch.clamp(idx, max=pair_gid.shape[0] - 1)
    a = attrs[pair_gid[idx].to(torch.int64)]                       # (tc, c, 9)
    px = ((tiles % ntx) * TILE).to(torch.float32)[:, None] \
        + (lane % TILE).to(torch.float32)
    py = ((tiles // ntx) * TILE).to(torch.float32)[:, None] \
        + (lane // TILE).to(torch.float32)
    dx = a[:, None, :, 0] - px[:, :, None]                         # (tc, p, c)
    dy = a[:, None, :, 1] - py[:, :, None]
    ca, cb, cc = a[:, None, :, 2], a[:, None, :, 3], a[:, None, :, 4]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    pmask = valid[:, None, :] & (power <= 0.0)
    exp_power = torch.exp(torch.where(pmask, power,
                                      torch.full_like(power, NEG_CLAMP)))
    alpha_raw = a[:, None, :, 5] * exp_power
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    alpha = torch.where(pmask & (alpha >= ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))
    return {"slot": slot, "valid": valid, "idx": idx, "a": a, "dx": dx,
            "dy": dy, "pmask": pmask, "exp_power": exp_power,
            "alpha_raw": alpha_raw, "alpha": alpha}


def _to_tiles(img: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """(H, W, C) -> (T, TILE * TILE, C), zero beyond the image."""
    h, w, c = img.shape
    pad = img.new_zeros((nty * TILE, ntx * TILE, c))
    pad[:h, :w] = img
    return pad.reshape(nty, TILE, ntx, TILE, c).permute(0, 2, 1, 3, 4) \
        .reshape(nty * ntx, TILE * TILE, c)


def _to_image(x: torch.Tensor, ntx: int, nty: int, height: int,
              width: int) -> torch.Tensor:
    """(T, TILE * TILE, C) -> (H, W, C), contiguous."""
    c = x.shape[-1]
    x = x.reshape(nty, ntx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return x.reshape(nty * TILE, ntx * TILE, c)[:height, :width].contiguous()


def composite_plain(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                    attrs: torch.Tensor, *, height: int, width: int,
                    store_contrib: bool = False, count_ops: bool = False):
    """The forward kernel's function in plain PyTorch, for the CPU tests and
    for holding the kernel to on the card.

    Tiles are taken in chunks; each chunk's pairs are padded to its largest
    tile count, and the compositing uses the dense oracle's exclusive and
    inclusive transmittance products and gates (``ops/rasterize_ref.py``).
    Returns (rgb (H, W, 3), final_t (H, W)), then n_contrib (H, W) int32
    with ``store_contrib``, then with ``count_ops`` the fp32 operations
    (``OPS_*``) the kernel's sequential rule needs per pixel (H, W): for
    each pixel's pairs up to and including the one that stops it, the
    stages each pair reaches.
    """
    dev = attrs.device
    ntx, nty = grid_dims(height, width)
    num_tiles = ntx * nty
    p = TILE * TILE
    counts = (tile_range[1:] - tile_range[:-1]).to(torch.int64)
    out_rgb = torch.zeros((num_tiles, p, 3), dtype=torch.float32, device=dev)
    out_t = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    out_c = torch.zeros((num_tiles, p), dtype=torch.int64, device=dev)
    out_n = torch.zeros((num_tiles, p), dtype=torch.int64, device=dev)

    for t0, t1, cmax in _tile_chunks(counts.tolist(), num_tiles):
        if cmax == 0:
            continue
        ch = _chunk_alpha(tile_range, pair_gid, attrs, counts, t0, t1, cmax,
                          ntx)
        alpha, slot = ch["alpha"], ch["slot"]
        cp_incl = torch.cumprod(1.0 - alpha, dim=2)
        cp_excl = torch.cat([torch.ones_like(cp_incl[..., :1]),
                             cp_incl[..., :-1]], dim=2)
        accept = cp_incl >= T_EPS
        w = alpha * cp_excl * accept.to(alpha.dtype)
        out_rgb[t0:t1] = torch.matmul(w, ch["a"][:, :, 6:9])
        out_t[t0:t1] = torch.amin(
            torch.where(accept, cp_incl, torch.ones_like(cp_incl)), dim=2)
        lit = alpha > 0.0
        if store_contrib:
            out_c[t0:t1] = torch.where(accept & lit, slot + 1,
                                       torch.zeros_like(slot)).amax(dim=2)
        if count_ops:
            # accept is a prefix: evaluations run through the first
            # rejected pair, or through the tile's last pair
            n_eval = torch.minimum(accept.sum(dim=2) + 1, counts[t0:t1, None])
            evaluated = slot < n_eval[..., None]
            out_n[t0:t1] = (
                OPS_EVALUATED * n_eval
                + OPS_PAST_POWER * (evaluated & ch["pmask"]).sum(dim=2)
                + OPS_PAST_ALPHA * (evaluated & lit).sum(dim=2)
                + OPS_ACCEPTED * (accept & lit).sum(dim=2))

    def image(x):
        return _to_image(x[..., None], ntx, nty, height, width)[..., 0]

    out = (_to_image(out_rgb, ntx, nty, height, width), image(out_t))
    if store_contrib:
        out += (image(out_c).to(torch.int32),)
    if count_ops:
        out += (image(out_n),)
    return out


def composite_backward_plain(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                             attrs: torch.Tensor, grad_rgb: torch.Tensor,
                             grad_t: torch.Tensor, final_t: torch.Tensor,
                             n_contrib: torch.Tensor, *, height: int,
                             width: int, count_ops: bool = False):
    """The backward kernel's function in plain PyTorch: the (9, P)
    per-pair gradients. Chunked like ``composite_plain``; a pixel's pairs
    are those before its n_contrib that pass the gates, their transmittance
    comes from prefix products (not the kernel's division) and the suffix
    sums from a reversed cumulative sum. With ``count_ops`` also the fp32
    operations (``OPS_BWD_*``) the kernel spends per pixel (H, W)."""
    dev = attrs.device
    ntx, nty = grid_dims(height, width)
    num_tiles = ntx * nty
    counts = (tile_range[1:] - tile_range[:-1]).to(torch.int64)
    g_rgb = _to_tiles(grad_rgb, ntx, nty)                          # (T, p, 3)
    r0 = _to_tiles((grad_t * final_t)[..., None], ntx, nty)[..., 0]
    n_c = _to_tiles(n_contrib[..., None].to(torch.int64), ntx, nty)[..., 0]
    out = torch.zeros((N_ATTR, pair_gid.shape[0]), dtype=torch.float32,
                      device=dev)
    out_n = torch.zeros((num_tiles, TILE * TILE), dtype=torch.int64,
                        device=dev)

    for t0, t1, cmax in _tile_chunks(counts.tolist(), num_tiles):
        if cmax == 0:
            continue
        ch = _chunk_alpha(tile_range, pair_gid, attrs, counts, t0, t1, cmax,
                          ntx)
        a, dx, dy = ch["a"], ch["dx"], ch["dy"]
        walked = ch["slot"] < n_c[t0:t1, :, None]                  # (tc, p, c)
        live = walked & (ch["alpha"] > 0.0)
        alpha = ch["alpha"] * live.to(torch.float32)
        one_m = 1.0 - alpha
        cp_incl = torch.cumprod(one_m, dim=2)
        t_before = torch.cat([torch.ones_like(cp_incl[..., :1]),
                              cp_incl[..., :-1]], dim=2)
        w = alpha * t_before
        gr = g_rgb[t0:t1]                                          # (tc, p, 3)
        e = torch.matmul(gr, a[:, :, 6:9].transpose(1, 2))         # (tc, p, c)
        we = w * e
        rev = torch.flip(torch.cumsum(torch.flip(we, [2]), dim=2), [2])
        suffix = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])],
                           dim=2)
        r = suffix + r0[t0:t1, :, None]
        dalpha = (e * t_before - r / one_m) * live.to(torch.float32)
        dpower = dalpha * ch["alpha_raw"]
        ca, cb, cc = a[:, None, :, 2], a[:, None, :, 3], a[:, None, :, 4]
        rows = torch.stack([
            (dpower * -(ca * dx + cb * dy)).sum(1),
            (dpower * -(cc * dy + cb * dx)).sum(1),
            (dpower * (-0.5 * dx * dx)).sum(1),
            (dpower * (-dx * dy)).sum(1),
            (dpower * (-0.5 * dy * dy)).sum(1),
            (ch["exp_power"] * dalpha).sum(1)], dim=-1)            # (tc, c, 6)
        dcol = torch.matmul(w.transpose(1, 2), gr)                 # (tc, c, 3)
        rows = torch.cat([rows, dcol], dim=-1)
        valid = ch["valid"]
        out[:, ch["idx"][valid]] = rows[valid].T
        if count_ops:
            out_n[t0:t1] = (
                OPS_BWD_EVALUATED * walked.sum(dim=2)
                + OPS_BWD_PAST_POWER * (walked & ch["pmask"]).sum(dim=2)
                + OPS_BWD_LIVE * live.sum(dim=2))
    if count_ops:
        return out, _to_image(out_n[..., None], ntx, nty, height,
                              width)[..., 0]
    return out
