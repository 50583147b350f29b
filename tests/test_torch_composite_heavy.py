"""K1's and K2's plain twins on heavy tiles, held against the JAX package on
the CPU: a tile cut into several forward chunks, the checkpoints the
forward keeps at every CHUNK pairs, the backward that starts each chunk
from them, and the chunk plan the forward takes its work items from.

The JAX side runs as tests/test_torch_rasterize.py runs it: Pallas in
interpret mode, exact colours, caps that report overflow 0. Tolerances are
tests/test_rasterize.py's: forward atol 2e-5 + rtol 1e-4, per-Gaussian
gradients atol 2e-4 * scale + rtol 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from guassianhand_tpu.ops import binning as jbin
from guassianhand_tpu.ops.rasterize import RasterizeConfig, _composite
from guassianhand_tpu_torch.ops import rasterize_cuda as rc
from guassianhand_tpu_torch.ops.common import T_EPS
from guassianhand_tpu_torch.ops.binning import bin_gaussians
from guassianhand_tpu_torch.ops.segreduce_cuda import segment_reduce_plain
from tests.torch_parity import (RASTER_ATOL, RASTER_RTOL,  # noqa: F401
                                one_torch_thread, to_torch)

JCFG = RasterizeConfig(interpret=True, pack_rgb=False,
                       max_tiles_per_gaussian=16, max_blocks_per_tile=64,
                       pairs_per_gaussian=16.0)
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3
H = W = 32


def heavy_scene_arrays():
    """700 splats on a 32 x 32 canvas, most in its first tile (more than
    FWD_LIGHT pairs there, so the forward cuts it into chunks), faint
    enough that most pixels never stop, and six opaque narrow ones on pixel
    (6, 5) that stop it; random depths, colours and linear cotangents."""
    rng = np.random.RandomState(11)
    n = 700
    mean2d = np.stack([rng.uniform(1, 15, n), rng.uniform(1, 15, n)], 1)
    conic = np.stack([rng.uniform(0.05, 0.4, n), rng.uniform(-0.02, 0.02, n),
                      rng.uniform(0.05, 0.4, n)], 1)
    opacity = rng.uniform(0.02, 0.08, n)
    stop = [30, 200, 300, 420, 500, 610]
    mean2d[stop] = [6.0, 5.0]
    conic[stop] = [4.0, 0.0, 4.0]
    opacity[stop] = 0.8
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return {"mean2d": f32(mean2d), "conic": f32(conic),
            "color": f32(rng.uniform(0, 1, (n, 3))), "opacity": f32(opacity),
            "depth": f32(rng.permutation(n) + 1.0),
            "radius": np.full(n, 6, np.int32), "visible": np.ones(n, bool),
            "grad_rgb": f32(rng.normal(size=(H, W, 3))),
            "grad_t": f32(rng.normal(size=(H, W)))}


@pytest.fixture(scope="module")
def heavy():
    """The scene through JAX's composite (forward and jax.grad of the
    linear loss) and through the port's twins."""
    s = heavy_scene_arrays()
    tile_flat, overflow = jax.jit(lambda m, r, v, o: jbin.enumerate_tiles(
        m, r, v, height=H, width=W, cfg=JCFG.binning(), opacity=o))(
            s["mean2d"], s["radius"], s["visible"], s["opacity"])
    assert int(overflow) == 0

    def loss(mean2d, conic, color, opacity):
        rgb, final_t, _, ovf = _composite(mean2d, conic, color, opacity,
                                          tile_flat, s["depth"], H, W, JCFG)
        return (jnp.sum(rgb * s["grad_rgb"]) + jnp.sum(final_t * s["grad_t"]),
                (rgb, final_t, ovf))

    (_, (rgb_j, t_j, ovf)), grads_j = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
            s["mean2d"], s["conic"], s["color"], s["opacity"])
    assert int(ovf) == 0
    t = {k: to_torch(v) for k, v in s.items()}
    bins = bin_gaussians(t["mean2d"], t["depth"], t["radius"], t["visible"],
                         height=H, width=W, opacity=t["opacity"])
    attrs = rc.pack_attrs(t["mean2d"], t["conic"], t["color"], t["opacity"])
    fwd = rc.composite_forward(bins.tile_range, bins.pair_gid, attrs,
                               height=H, width=W, store_contrib=True)
    return {"s": s, "t": t, "bins": bins, "attrs": attrs, "fwd": fwd,
            "jax": (np.asarray(rgb_j), np.asarray(t_j),
                    [np.asarray(g) for g in grads_j])}


def per_gaussian(bins, pair_rows, n):
    order = torch.argsort(bins.pair_gid, stable=True)
    return segment_reduce_plain(bins.pair_gid[order],
                                pair_rows[:, order].contiguous(), n).numpy()


def test_heavy_tile_twins_match_jax_kernels(heavy):
    """A tile of more than FWD_LIGHT pairs (three forward chunks, eleven
    checkpoints): the forward twin and the checkpointed backward twin
    against JAX's composite_forward and composite_backward."""
    bins, (rgb, final_t, n_contrib, ckpt, slots) = heavy["bins"], heavy["fwd"]
    counts = bins.counts()
    assert int(counts.max()) > rc.FWD_LIGHT
    assert -(-int(counts.max()) // rc.FWD_CHUNK) >= 3
    rgb_j, t_j, grads_j = heavy["jax"]
    np.testing.assert_allclose(rgb.numpy(), rgb_j, atol=RASTER_ATOL,
                               rtol=RASTER_RTOL)
    np.testing.assert_allclose(final_t.numpy(), t_j, atol=RASTER_ATOL,
                               rtol=RASTER_RTOL)
    assert float(final_t[5, 6]) < 1e-3 < float(final_t.max())
    t = heavy["t"]
    rows = rc.composite_backward(bins.tile_range, bins.pair_gid,
                                 heavy["attrs"], t["grad_rgb"], t["grad_t"],
                                 rgb, final_t, n_contrib, ckpt, slots,
                                 height=H, width=W)
    got = per_gaussian(bins, rows, heavy["attrs"].shape[0])
    for cols, want in zip((slice(0, 2), slice(2, 5), slice(6, 9),
                           slice(5, 6)), grads_j):
        want = want.reshape(got[:, cols].shape)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[:, cols], want, atol=GRAD_ATOL * scale,
                                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("build", ["heavy", "chunk_boundary"])
def test_checkpointed_backward_matches_undivided_walk(heavy, build):
    """The backward twin starting every CHUNK pairs from the checkpoints
    against one undivided walk a tile, on the heavy scene and on
    chip_smoke's tile where a pixel stops on a forward chunk boundary."""
    if build == "heavy":
        bins, attrs, t = heavy["bins"], heavy["attrs"], heavy["t"]
        tile_range, pair_gid, h, w = bins.tile_range, bins.pair_gid, H, W
        g_rgb, g_t = t["grad_rgb"], t["grad_t"]
    else:
        inputs = chip_smoke.chunk_boundary_scene(device="cpu")
        tile_range, pair_gid, attrs = (inputs.tile_range, inputs.pair_gid,
                                       inputs.attrs)
        h, w = inputs.height, inputs.width
        rng = np.random.RandomState(4)
        g_rgb = to_torch(rng.normal(size=(h, w, 3)).astype(np.float32))
        g_t = to_torch(rng.normal(size=(h, w)).astype(np.float32))
    rgb, final_t, n_contrib, ckpt, slots = rc.composite_forward(
        tile_range, pair_gid, attrs, height=h, width=w, store_contrib=True)
    args = (tile_range, pair_gid, attrs, g_rgb, g_t, rgb, final_t, n_contrib)
    chunked = rc.composite_backward_plain(*args, ckpt, slots, height=h,
                                          width=w)
    whole = rc.composite_backward_plain(*args, None, height=h, width=w)
    assert int(slots[-1]) >= 10
    scale = whole.abs().amax(dim=1, keepdim=True)
    diff = (chunked - whole).abs()
    assert bool((diff <= GRAD_ATOL * scale + GRAD_RTOL * whole.abs()).all())


def test_checkpoints_hold_the_sequential_walk():
    """Every checkpoint of chip_smoke's chunk-boundary tile against the
    walk written out pair by pair in float32: T after each CHUNK pairs (or
    at the stop), and the colour composited so far."""
    inputs = chip_smoke.chunk_boundary_scene(device="cpu")
    rows = inputs.attrs.numpy()
    _, _, n_contrib, ckpt, _ = rc.composite_forward(
        inputs.tile_range, inputs.pair_gid, inputs.attrs, height=16,
        width=16, store_contrib=True)
    n = rows.shape[0]
    want = np.zeros((n // rc.CHUNK, 256, 4), np.float32)
    for pix in range(256):
        py, px = divmod(pix, 16)
        t, c, stopped = np.float32(1), np.zeros(3, np.float32), False
        for i, (x, y, a, b, cc, o, *col) in enumerate(rows):
            if not stopped:
                dx, dy = x - np.float32(px), y - np.float32(py)
                power = np.float32(-0.5) * (a * dx * dx + cc * dy * dy) \
                    - b * dx * dy
                alpha = min(np.float32(0.99), o * np.exp(power))
                if power <= 0 and alpha >= np.float32(1 / 255):
                    if t * (np.float32(1) - alpha) < np.float32(1e-4):
                        stopped = True
                    else:
                        c = c + np.asarray(col, np.float32) * (alpha * t)
                        t = t * (np.float32(1) - alpha)
            if (i + 1) % rc.CHUNK == 0 and i + 1 < n:
                want[(i + 1) // rc.CHUNK - 1, pix] = [t, *c]
    assert int(n_contrib[9, 5]) == rc.FWD_CHUNK
    np.testing.assert_allclose(ckpt.numpy()[..., 0], want[..., 0], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(ckpt.numpy()[..., 1:], want[..., 1:],
                               atol=RASTER_ATOL, rtol=RASTER_RTOL)


def threshold_alphas(n: int = 45, seed: int = 1):
    """``n + 1`` alphas in [0.1, 0.2] and one last alpha chosen so that T
    after all of them, taken one fp32 multiply a pair in order, falls on
    the other side of T_EPS from ``torch.cumprod``'s T; and the walk's T
    after each pair."""
    rng = np.random.RandomState(seed)
    one, t_eps = np.float32(1), np.float32(T_EPS)
    while True:
        alphas = rng.uniform(0.1, 0.2, n).astype(np.float32)
        t = np.float32(1)
        for a in alphas:
            t = np.float32(t * (one - a))
        last = up = down = np.float32(1 - t_eps / t)
        for _ in range(100):
            walk = np.float32(t * (one - last))
            scan = torch.cumprod(torch.from_numpy(
                one - np.append(alphas, last)), 0)[-1].item()
            if (walk < t_eps) != (scan < t_eps):
                alphas = np.append(alphas, last)
                return alphas, np.cumprod(one - alphas, dtype=np.float32)
            up = np.nextafter(up, one)
            down = np.nextafter(down, np.float32(0))
            last = up if last == down else down


def test_twin_stops_where_the_fp32_walk_stops():
    """A pixel whose T after its last pair lands within rounding of T_EPS
    (Gaussians centred on it, so each alpha is its opacity): the twin's
    n_contrib and final T are those of the walk T (1 - alpha) one fp32
    multiply a pair, the kernel's recurrence, exactly, where
    ``torch.cumprod`` rounds the product across the threshold."""
    alphas, walk = threshold_alphas()
    assert walk[-2] >= T_EPS
    rng = np.random.RandomState(2)
    rows = [[0.0, 0.0, 0.1, 0.0, 0.1, a, *rng.uniform(0, 1, 3)]
            for a in alphas]
    inputs = chip_smoke.pair_rows_inputs(rows, [len(rows)], 16, 16,
                                         device="cpu")
    _, final_t, n_contrib, _, _ = rc.composite_plain(
        inputs.tile_range, inputs.pair_gid, inputs.attrs, height=16,
        width=16, store_contrib=True)
    stopped = walk[-1] < T_EPS
    assert int(n_contrib[0, 0]) == len(alphas) - int(stopped)
    assert float(final_t[0, 0]) == float(walk[-2] if stopped else walk[-1])


def test_chunk_plan_items():
    """The forward's plan of tiles of 0, 600, 5, 513, 512, 1100 and 64
    pairs, item by item (FWD_CHUNK pairs, FWD_GROUPS groups, tiles of at
    most FWD_LIGHT pairs whole, after the cut ones), and its checkpoint
    slot bases: tile t's chunks of CHUNK pairs, which the backward runs one
    CTA each, are items slot_base[t] + t onwards."""
    counts = [0, 600, 5, 513, 512, 1100, 64]
    tile_range = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                              dtype=torch.int32)
    p = int(tile_range[-1])
    plan = rc.chunk_plan(tile_range, p)
    cut = {5: 5, 1: 3, 3: 3}                      # in rank order
    want = [(t, c, k) for c in range(5) for t in cut if cut[t] > c
            for k in range(rc.FWD_GROUPS)]
    want += [(t, 0, -1) for t in (0, 2, 4, 6)]
    assert rc.plan_items(plan) == want
    assert (plan.max_items, plan.max_slots) == (
        rc.FWD_GROUPS * (7 + p // rc.FWD_CHUNK), p // rc.CHUNK)
    assert plan.slot_base.tolist() == [0, 0, 9, 9, 17, 24, 41, 41]
    assert torch.equal(plan.slot_base, rc.checkpoint_slots(tile_range))
    first = [b + t for t, b in enumerate(plan.slot_base.tolist())]
    chunks = [max(1, -(-c // rc.CHUNK)) for c in counts]
    assert np.diff(first).tolist() == chunks


def test_chunk_plan_orders_every_chain():
    """Random tile counts: every (tile, chunk, group) item of the forward's
    plan appears once, chunk c - 1 of a tile comes before chunk c (the
    forward's hand-off waits only on smaller item numbers), and the whole
    tiles come last."""
    rng = np.random.RandomState(0)
    chunk, groups, light = rc.FWD_CHUNK, rc.FWD_GROUPS, rc.FWD_LIGHT
    for trial in range(40):
        counts = rng.choice([0, 3, 64, 65, 300, 512, 513, 900, 2000],
                            size=rng.randint(1, 40))
        tile_range = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                                  dtype=torch.int32)
        plan = rc.chunk_plan(tile_range, int(tile_range[-1]))
        items = rc.plan_items(plan)
        expected = set()
        for t, c in enumerate(counts):
            if c <= light:
                expected.add((t, 0, -1))
            else:
                expected |= {(t, k, q) for k in range(max(1, -(-c // chunk)))
                             for q in range(groups)}
        assert len(items) == len(expected) == len(set(items))
        assert set(items) == expected
        assert len(items) <= plan.max_items
        where = {it: i for i, it in enumerate(items)}
        for (t, c, q), i in where.items():
            if c > 0:
                assert where[(t, c - 1, q)] < i
        whole = [i for (t, c, q), i in where.items() if q < 0]
        cut = [i for (t, c, q), i in where.items() if q >= 0]
        assert not whole or not cut or min(whole) > max(cut)
