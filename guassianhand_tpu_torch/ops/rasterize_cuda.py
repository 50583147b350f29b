"""Tile composite, forward and backward: the CUDA kernels and their
plain-PyTorch twins.

- ``composite_forward`` replaces
  ``guassianhand_tpu/ops/rasterize_pallas.py::composite_forward`` (source
  ``csrc/composite_fwd.cu``). Render mode returns (rgb, final_t); training
  mode (``store_contrib``) also returns ``n_contrib``, the chunk
  checkpoints and their slot bases, what the backward needs.
- ``composite_backward`` replaces ``composite_backward`` of the same file
  (source ``csrc/composite_bwd.cu``): per-pair gradients of the packed
  attributes.

The forward takes its work items from a chunk plan (``chunk_plan``, built
on the card by a one-CTA kernel): it cuts every tile of more than
FWD_LIGHT pairs into chunks of FWD_CHUNK pairs at FWD_GROUPS groups of
rows, handing each pixel's running state from chunk to chunk, and keeps
that state (T, r, g, b) every CHUNK pairs inside a tile, the checkpoints;
the backward runs every CHUNK pairs of a tile as its own CTA, starting from
the checkpoint after them, and finds its tile in the forward's checkpoint
slot bases (``checkpoint_slots``). The header note of each source gives its design
and what bounds it. Each wrapper sends CUDA tensors to its
kernel and CPU tensors to its twin (``composite_plain``,
``composite_backward_plain``), which compute the same function, checkpoints
included; nothing falls back from one to the other. ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import dataclasses

import torch

from guassianhand_tpu_torch.ops.binning import grid_dims
from guassianhand_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE
from guassianhand_tpu_torch.ops.cuda_build import (I, P, CudaLibrary,
                                                   check_launch)

N_ATTR = 9         # per-Gaussian row: x y A B C opacity r g b
N_STATE = 4        # a checkpoint: T and the colour composited so far
NEG_CLAMP = -30.0  # exponent given to masked slots in the twins
# Pairs between two checkpoints of the forward, and pairs a work item of
# the backward (csrc/composite_common.cuh::kCheckpoint).
CHUNK = 64
# A work item of the forward: FWD_CHUNK pairs at one of FWD_GROUPS groups
# of a tile's rows (csrc/composite_fwd.cu: kChunk, kGroups); its alphas,
# 64 KB, stay in shared memory, three CTAs an SM.
FWD_CHUNK = 256
FWD_GROUPS = 4
# A tile of at most FWD_LIGHT pairs is one work item of the forward, whole:
# one CTA, a thread a pixel, no hand-off.
FWD_LIGHT = 512
# (tiles x pixels x pairs) elements per chunk of the twins
PLAIN_CHUNK_ELEMS = 1 << 24
# fp32 operations of one pixel x pair step of the composite, read off the
# kernel's arithmetic in csrc/composite_fwd.cu: a fused multiply-add counts
# two, as the peak FLOP/s counts it, expf one, a comparison one. Each stage
# runs only for the pairs that passed the gate before it. They count the
# function's work: the kernel's staging, hand-offs and checkpoints are not
# in them.
OPS_EVALUATED = 12   # dx, dy 2; A dx dx + C dy dy 5; power 4; power > 0 1
OPS_PAST_POWER = 4   # expf 1; alpha = min(0.99, opacity e) 2; alpha < 1/255 1
OPS_PAST_ALPHA = 3   # T (1 - alpha) 2; < 1e-4 1
OPS_ACCEPTED = 7     # w = alpha T 1; three colour multiply-adds 6
# The backward's step (csrc/composite_bwd.cu), for the pairs before the
# pixel's n_contrib: the forward's gates, then for a live pair
# 1 - alpha 1, T / (1 - alpha) 1, w 1, e 5, dalpha 3, r += w e 2,
# dpower 1, d mean 8, d conic 8, d opacity 1, d colour 3, and the 9 adds
# that sum the pair's gradient over the tile's pixels.
OPS_BWD_EVALUATED = 12
OPS_BWD_PAST_POWER = 4
OPS_BWD_LIVE = 43

FORWARD_LIB = CudaLibrary("composite_fwd.cu", {
    "gh_composite_forward": [P, P, P, P, P, P, I, I, I, I, I, I, P, P, P, P,
                             P, P, I, P],
    "gh_composite_plan": [P, I, I, I, I, I, P, P, P, P, P]})
BACKWARD_LIB = CudaLibrary("composite_bwd.cu", {
    "gh_composite_backward": [P, P, P, P, I, I, I, I, I, P, P, P, P, P, P,
                              I, P, P]})


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """The work items of the forward kernel (csrc/composite_fwd.cu).

    A tile of more than FWD_LIGHT pairs is cut: max(1, ceil(count /
    FWD_CHUNK)) chunks, each in FWD_GROUPS pixel groups (of 64 pixels,
    whole rows); a work item is one (tile, chunk, group). A tile of at most
    FWD_LIGHT pairs is one item, (tile, 0, -1). Items are numbered
    round by round: round c holds chunk c of every cut tile with more than
    c chunks, tiles with more chunks first, then in tile order, each tile's
    groups in a row; the whole tiles follow in tile order. ``items[i]`` is
    item i's (tile, chunk, group, 0), for i below ``n_items[0]``.
    ``slot_base`` is ``checkpoint_slots(tile_range)``. ``max_items`` and
    ``max_slots`` are the bounds the host allocates and launches for."""

    items: torch.Tensor         # (max_items, 4) int32
    n_items: torch.Tensor       # (1,) int32
    slot_base: torch.Tensor     # (T + 1,) int32
    max_items: int              # FWD_GROUPS * (T + P // FWD_CHUNK)
    max_slots: int              # P // CHUNK


def chunk_plan(tile_range: torch.Tensor, n_pairs: int) -> ChunkPlan:
    """The forward's chunk plan of binned pairs: ``tile_range`` (T+1,)
    int32 and the pair count ``n_pairs`` (its last entry, known to the
    host), built on the card by one CTA (``csrc/composite_fwd.cu``)
    without a host round trip; ``chunk_plan_plain`` is its twin."""
    if tile_range.device.type == "cpu":
        return chunk_plan_plain(tile_range, n_pairs)
    dev = tile_range.device
    num_tiles = tile_range.shape[0] - 1
    chunk, groups = FWD_CHUNK, FWD_GROUPS
    n_rounds = max(1, -(-n_pairs // chunk))
    max_items = groups * (num_tiles + n_pairs // chunk)
    # one allocation for the items, their count and the kernel's scratch
    # (2 n_rounds + 1 + 3 T ints); the slot bases on their own, since the
    # backward keeps them
    ints = torch.empty(4 * max_items + 2 * n_rounds + 2 + 3 * num_tiles,
                       dtype=torch.int32, device=dev)
    items = ints[:4 * max_items].view(max_items, 4)
    n_items = ints[4 * max_items:4 * max_items + 1]
    scratch = ints[4 * max_items + 1:]
    slot_base = torch.empty(num_tiles + 1, dtype=torch.int32, device=dev)
    lib = FORWARD_LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_composite_plan(
            tile_range.data_ptr(), num_tiles, chunk, groups, FWD_LIGHT,
            n_rounds,
            items.data_ptr(), n_items.data_ptr(), slot_base.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "composite_plan_kernel")
    chunk_plan.launches += 1
    return ChunkPlan(items, n_items, slot_base, max_items, n_pairs // CHUNK)


chunk_plan.launches = 0


def checkpoint_slots(tile_range: torch.Tensor) -> torch.Tensor:
    """(T + 1,) int32: the checkpoint after the first (b + 1) * CHUNK pairs
    of tile t is slot ``[t] + b``, for b below max(1, ceil(count / CHUNK))
    - 1; ``[-1]`` is the number of slots. Tile t's chunks of CHUNK pairs
    are then the backward's work items ``[t] + t`` onwards."""
    counts = (tile_range[1:] - tile_range[:-1]).to(torch.int64)
    ckpt = torch.clamp((counts + CHUNK - 1) // CHUNK, min=1) - 1
    slot_base = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                            device=tile_range.device)
    slot_base[1:] = torch.cumsum(ckpt, 0)
    return slot_base


def chunk_plan_plain(tile_range: torch.Tensor, n_pairs: int) -> ChunkPlan:
    """``chunk_plan`` in plain PyTorch (rows of ``items`` past the item
    count are 0)."""
    dev = tile_range.device
    num_tiles = tile_range.shape[0] - 1
    chunk, groups = FWD_CHUNK, FWD_GROUPS
    max_items = groups * (num_tiles + n_pairs // chunk)
    counts = (tile_range[1:] - tile_range[:-1]).to(torch.int64)
    whole = counts <= FWD_LIGHT
    n_chunks = torch.where(whole, 0, torch.clamp((counts + chunk - 1)
                                                 // chunk, min=1))
    # round c holds the cut tiles of more than c chunks: a prefix of `order`
    n_rounds = max(1, -(-n_pairs // chunk))   # the most chunks a tile has
    hist = torch.zeros(n_rounds + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, n_chunks, torch.ones_like(n_chunks))
    in_round = num_tiles - torch.cumsum(hist, 0)[:n_rounds]
    round_start = torch.cumsum(in_round, 0) - in_round
    order = torch.argsort(n_chunks, descending=True, stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(num_tiles, device=dev))
    # flat index f -> (tile, chunk), tile-major, then its item number
    ends = torch.cumsum(n_chunks, 0)
    f = torch.arange(max_items // groups, device=dev)
    tile = torch.clamp(torch.searchsorted(ends, f, right=True),
                       max=num_tiles - 1)
    chunk_of = f - (ends[tile] - n_chunks[tile])
    item = torch.where(f < ends[-1], round_start[torch.clamp(
        chunk_of, 0, n_rounds - 1)] + rank[tile], max_items // groups)
    cut = torch.zeros((max_items // groups + 1, groups, 4), dtype=torch.int32,
                      device=dev)
    group = torch.arange(groups, device=dev)
    cut[item] = torch.stack(torch.broadcast_tensors(
        tile[:, None], chunk_of[:, None], group[None, :],
        torch.zeros_like(group)[None, :]), -1).to(torch.int32)
    items = cut[:-1].reshape(-1, 4)
    # the whole tiles, one item each, after the cut tiles' items
    n_cut_items = groups * int(ends[-1])
    w = torch.nonzero(whole)[:, 0]
    items[n_cut_items:n_cut_items + w.shape[0]] = torch.stack(
        [w, torch.zeros_like(w), torch.full_like(w, -1),
         torch.zeros_like(w)], 1).to(torch.int32)
    n_items = torch.tensor([n_cut_items + w.shape[0]], dtype=torch.int32,
                           device=dev)
    return ChunkPlan(items.contiguous(), n_items,
                     checkpoint_slots(tile_range), max_items,
                     n_pairs // CHUNK)


def plan_items(plan: ChunkPlan):
    """The plan's work items [(tile, chunk, group), ...] in item order
    (host)."""
    return [tuple(x[:3]) for x in plan.items[:int(plan.n_items)].tolist()]


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
    (rgb (H, W, 3), final_t (H, W)) float32, and with ``store_contrib``
    also n_contrib (H, W) int32 (the count of the tile's pairs up to and
    including the pixel's last composited pair), the checkpoints
    (P // CHUNK, 256, 4) float32 and their slot bases ``slot_base`` (T+1,)
    int32 (``checkpoint_slots``): slot ``slot_base[t] + b`` holds, for each
    pixel of tile t in row-major order, T and the colour composited after
    the tile's first (b + 1) * CHUNK pairs (rows past ``slot_base[-1]`` are
    unused)."""
    ntx, nty = _check(tile_range, pair_gid, attrs, height, width)
    if attrs.device.type == "cpu":
        return composite_plain(tile_range, pair_gid, attrs, height=height,
                               width=width, store_contrib=store_contrib)
    dev = attrs.device
    plan = chunk_plan(tile_range, pair_gid.shape[0])
    rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    contrib = (torch.empty((height, width), dtype=torch.int32, device=dev)
               if store_contrib else None)
    pix = TILE * TILE
    state_f = torch.empty((plan.max_slots, pix, N_STATE), dtype=torch.float32,
                          device=dev)
    # the hand-off words (zeroed by the launch) and each pixel's n_contrib
    # at a checkpoint, in one allocation
    n_sync = 1 + FWD_GROUPS * plan.max_slots
    ints = torch.empty(n_sync + plan.max_slots * pix, dtype=torch.int32,
                       device=dev)
    lib = FORWARD_LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_composite_forward(
            tile_range.data_ptr(), pair_gid.data_ptr(), attrs.data_ptr(),
            plan.items.data_ptr(), plan.n_items.data_ptr(),
            plan.slot_base.data_ptr(), FWD_CHUNK, FWD_GROUPS, plan.max_items,
            ntx, height, width, rgb.data_ptr(), final_t.data_ptr(),
            None if contrib is None else contrib.data_ptr(),
            state_f.data_ptr(), ints[n_sync:].data_ptr(), ints.data_ptr(),
            n_sync, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "composite_fwd_kernel")
    composite_forward.launches += 1
    if store_contrib:
        return rgb, final_t, contrib, state_f, plan.slot_base
    return rgb, final_t


composite_forward.launches = 0


def composite_backward(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                       attrs: torch.Tensor, grad_rgb: torch.Tensor,
                       grad_t: torch.Tensor, rgb: torch.Tensor,
                       final_t: torch.Tensor, n_contrib: torch.Tensor,
                       checkpoints: torch.Tensor, slot_base: torch.Tensor, *,
                       height: int, width: int):
    """Per-pair gradients (9, P) float32 of the packed attributes, row c
    the component c of every pair in binned order, from dL/drgb (H, W, 3),
    dL/dfinal_t (H, W) and what the training-mode forward returned: rgb,
    final_t, n_contrib, the checkpoints and their slot bases."""
    ntx, nty = _check(tile_range, pair_gid, attrs, height, width)
    dev = attrs.device
    n_pairs = pair_gid.shape[0]
    for name, t, shape, dtype in (
            ("grad_rgb", grad_rgb, (height, width, 3), torch.float32),
            ("grad_t", grad_t, (height, width), torch.float32),
            ("rgb", rgb, (height, width, 3), torch.float32),
            ("final_t", final_t, (height, width), torch.float32),
            ("n_contrib", n_contrib, (height, width), torch.int32),
            ("checkpoints", checkpoints,
             (n_pairs // CHUNK, TILE * TILE, N_STATE), torch.float32),
            ("slot_base", slot_base, tile_range.shape, torch.int32)):
        _check_image(name, t, shape, dtype, dev)
    if dev.type == "cpu":
        return composite_backward_plain(
            tile_range, pair_gid, attrs, grad_rgb, grad_t, rgb, final_t,
            n_contrib, checkpoints, slot_base, height=height, width=width)
    num_tiles = ntx * nty
    out = torch.empty((N_ATTR, n_pairs), dtype=torch.float32, device=dev)
    lib = BACKWARD_LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_composite_backward(
            tile_range.data_ptr(), pair_gid.data_ptr(), attrs.data_ptr(),
            slot_base.data_ptr(), num_tiles, num_tiles + n_pairs // CHUNK,
            ntx, height, width, grad_rgb.data_ptr(),
            grad_t.data_ptr(), rgb.data_ptr(), final_t.data_ptr(),
            n_contrib.data_ptr(), checkpoints.data_ptr(), n_pairs,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
    inclusive transmittance products and gates (``ops/rasterize_ref.py``),
    the products taken one fp32 multiply a pair in order, as the kernel
    takes them (``transmittance``).
    Returns (rgb (H, W, 3), final_t (H, W)), then with ``store_contrib``
    n_contrib (H, W) int32, the checkpoints and their slot bases (as
    ``composite_forward``; unused rows 0), then with ``count_ops`` the fp32 operations (``OPS_*``)
    the kernel's sequential rule needs per pixel (H, W): for each pixel's
    pairs up to and including the one that stops it, the stages each pair
    reaches.
    """
    dev = attrs.device
    ntx, nty = grid_dims(height, width)
    num_tiles = ntx * nty
    p = TILE * TILE
    counts = (tile_range[1:] - tile_range[:-1]).to(torch.int64)
    n_chunks = torch.clamp((counts + CHUNK - 1) // CHUNK, min=1)
    slot_base = checkpoint_slots(tile_range)
    out_rgb = torch.zeros((num_tiles, p, 3), dtype=torch.float32, device=dev)
    out_t = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    out_c = torch.zeros((num_tiles, p), dtype=torch.int64, device=dev)
    out_n = torch.zeros((num_tiles, p), dtype=torch.int64, device=dev)
    ckpt = torch.zeros((pair_gid.shape[0] // CHUNK, p, N_STATE),
                       dtype=torch.float32, device=dev)

    for t0, t1, cmax in _tile_chunks(counts.tolist(), num_tiles):
        if cmax == 0:
            continue
        ch = _chunk_alpha(tile_range, pair_gid, attrs, counts, t0, t1, cmax,
                          ntx)
        alpha, slot = ch["alpha"], ch["slot"]
        cp_incl = transmittance(1.0 - alpha)
        cp_excl = torch.cat([torch.ones_like(cp_incl[..., :1]),
                             cp_incl[..., :-1]], dim=2)
        accept = cp_incl >= T_EPS
        w = alpha * cp_excl * accept.to(alpha.dtype)
        out_rgb[t0:t1] = torch.matmul(w, ch["a"][:, :, 6:9])
        t_after = torch.where(accept, cp_incl, torch.ones_like(cp_incl))
        out_t[t0:t1] = torch.amin(t_after, dim=2)
        lit = alpha > 0.0
        if store_contrib:
            out_c[t0:t1] = torch.where(accept & lit, slot + 1,
                                       torch.zeros_like(slot)).amax(dim=2)
            n_bound = int(n_chunks[t0:t1].max()) - 1
            if n_bound > 0:
                _store_checkpoints(ckpt, t_after, w, ch["a"][:, :, 6:9],
                                   n_chunks[t0:t1], slot_base[t0:t1],
                                   n_bound)
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
        out += (image(out_c).to(torch.int32), ckpt, slot_base)
    if count_ops:
        out += (image(out_n),)
    return out


def transmittance(one_minus: torch.Tensor) -> torch.Tensor:
    """The inclusive products of ``one_minus`` (..., c) along its last
    axis, one fp32 multiply a pair in order: the forward kernel's
    recurrence T (1 - alpha), rounded as it rounds. ``torch.cumprod``
    rounds elsewhere (a parallel scan on the card, a float64 running
    product on the CPU), and a pixel whose T falls within rounding of
    T_EPS then stops a few pairs apart from the kernel."""
    g = one_minus.movedim(-1, 0).contiguous()
    out = torch.empty_like(g)
    out[0] = g[0]
    for j in range(1, g.shape[0]):
        torch.mul(out[j - 1], g[j], out=out[j])
    return out.movedim(0, -1)


def _store_checkpoints(ckpt, t_after, w, colors, n_chunks, slot_base,
                       n_bound):
    """Write the checkpoints of a run of tiles: T and the composited colour
    after each boundary b < n_bound of each tile's chunks. ``t_after``
    (tc, p, c) is T after each slot where the pixel still composites and 1
    past its stop, ``w`` its compositing weights, ``colors`` (tc, c, 3)."""
    bound = torch.arange(1, n_bound + 1, device=ckpt.device)      # (s,)
    last = bound * CHUNK - 1               # the last slot before a boundary
    last = torch.minimum(last, torch.full_like(last, t_after.shape[2] - 1))
    t_b = torch.cummin(t_after, dim=2).values[..., last]          # (tc, p, s)
    c_b = torch.cumsum(w[..., None] * colors[:, None], dim=2)[:, :, last]
    state = torch.cat([t_b[..., None], c_b], dim=-1).permute(0, 2, 1, 3)
    used = bound[None, :] < n_chunks[:, None]                     # (tc, s)
    slots = slot_base[:, None].to(torch.int64) + bound[None, :] - 1
    ckpt[slots[used]] = state[used]


def composite_backward_plain(tile_range: torch.Tensor, pair_gid: torch.Tensor,
                             attrs: torch.Tensor, grad_rgb: torch.Tensor,
                             grad_t: torch.Tensor, rgb: torch.Tensor,
                             final_t: torch.Tensor, n_contrib: torch.Tensor,
                             checkpoints=None, slot_base=None, *,
                             height: int, width: int,
                             count_ops: bool = False):
    """The backward kernel's function in plain PyTorch: the (9, P)
    per-pair gradients. Chunked like ``composite_plain``; a pixel's pairs
    are those before its n_contrib that pass the gates, their transmittance
    comes from prefix products (not the kernel's division) and the suffix
    sums from a reversed cumulative sum. With ``checkpoints`` and
    ``slot_base`` (the forward's) every chunk of CHUNK pairs starts as the kernel's does: its prefix
    products from the checkpointed T before it, its suffix sums from
    dL/drgb . (rgb - C) + dL/dT final_t at the checkpoint after it. Without
    them each tile is one undivided walk (``rgb`` is then not read). With
    ``count_ops`` also the fp32 operations (``OPS_BWD_*``) the kernel spends
    per pixel (H, W)."""
    dev = attrs.device
    ntx, nty = grid_dims(height, width)
    num_tiles = ntx * nty
    p = TILE * TILE
    counts = (tile_range[1:] - tile_range[:-1]).to(torch.int64)
    g_rgb = _to_tiles(grad_rgb, ntx, nty)                          # (T, p, 3)
    r0 = _to_tiles((grad_t * final_t)[..., None], ntx, nty)[..., 0]
    n_c = _to_tiles(n_contrib[..., None].to(torch.int64), ntx, nty)[..., 0]
    if checkpoints is not None:
        if slot_base is None:
            raise ValueError("checkpoints need their slot_base")
        n_chunks = torch.clamp((counts + CHUNK - 1) // CHUNK, min=1)
        rgb_t = _to_tiles(rgb, ntx, nty)
    out = torch.zeros((N_ATTR, pair_gid.shape[0]), dtype=torch.float32,
                      device=dev)
    out_n = torch.zeros((num_tiles, p), dtype=torch.int64, device=dev)

    for t0, t1, cmax in _tile_chunks(counts.tolist(), num_tiles):
        if cmax == 0:
            continue
        tc = t1 - t0
        ch = _chunk_alpha(tile_range, pair_gid, attrs, counts, t0, t1, cmax,
                          ntx)
        a, dx, dy = ch["a"], ch["dx"], ch["dy"]
        walked = ch["slot"] < n_c[t0:t1, :, None]                  # (tc, p, c)
        live = walked & (ch["alpha"] > 0.0)
        alpha = ch["alpha"] * live.to(torch.float32)
        one_m = 1.0 - alpha
        gr = g_rgb[t0:t1]                                          # (tc, p, 3)
        e = torch.matmul(gr, a[:, :, 6:9].transpose(1, 2))         # (tc, p, c)
        # the walk in segments of k slots, each with its own start state
        k = CHUNK if checkpoints is not None else cmax
        n_seg = -(-cmax // k)
        pad = n_seg * k - cmax

        def segments(x, fill):
            x = torch.nn.functional.pad(x, (0, pad), value=fill)
            return x.reshape(tc, p, n_seg, k)

        t_start = torch.ones((tc, p, n_seg), device=dev)
        r_end = r0[t0:t1, :, None].expand(tc, p, n_seg).clone()
        if checkpoints is not None and int(n_chunks[t0:t1].max()) > 1:
            seg = torch.arange(n_seg, device=dev)
            base = slot_base[t0:t1, None].to(torch.int64) + seg[None, :]
            nch = n_chunks[t0:t1, None]
            before = (seg[None, :] >= 1) & (seg[None, :] < nch)    # (tc, s)
            after = seg[None, :] < nch - 1
            ck_before = checkpoints[torch.where(before, base - 1, 0)]
            ck_after = checkpoints[torch.where(after, base, 0)]    # (tc,s,p,4)
            t_start = torch.where(before[:, None], ck_before[..., 0]
                                  .transpose(1, 2), t_start)
            c_left = (rgb_t[t0:t1, :, None, :]
                      - ck_after[..., 1:].transpose(1, 2))         # (tc,p,s,3)
            r_end = torch.where(after[:, None],
                                r_end + (gr[:, :, None, :] * c_left).sum(-1),
                                r_end)
        cp_incl = torch.cumprod(segments(one_m, 1.0), dim=3)
        t_excl = torch.cat([torch.ones_like(cp_incl[..., :1]),
                            cp_incl[..., :-1]], dim=3)
        t_before = (t_start[..., None] * t_excl).reshape(tc, p, -1)[..., :cmax]
        w = alpha * t_before
        we = segments(w * e, 0.0)
        rev = torch.flip(torch.cumsum(torch.flip(we, [3]), dim=3), [3])
        suffix = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])],
                           dim=3) + r_end[..., None]
        r = suffix.reshape(tc, p, -1)[..., :cmax]
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
