"""The PyTorch port's rasterizer stages held against the JAX package on
the CPU: projection, binning, the opacity cull, the dense oracle and K1's
and K2's plain twins (rasterize and rasterize_multiview end to end, with
their gradients, are in tests/test_torch_rasterize_grad.py).

The same numpy inputs go through both. The JAX side runs as its own tests
run it: Pallas in interpret mode, ``pack_rgb=False`` (exact colours), caps
large enough that it reports overflow 0, so its pair set is complete. The
port's composite runs through its plain twins, as every CPU tensor does.

Tolerances: the forward's of tests/test_rasterize.py, atol 2e-5 and rtol
1e-4 (fp32 reassociation of the colour sums; the acceptance gates see the
same values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.ops import binning as jbin
from guassianhand_tpu.ops.projection import project_gaussians as j_project
from guassianhand_tpu.ops.rasterize import RasterizeConfig, _composite
from guassianhand_tpu.ops.rasterize_ref import composite_reference as j_ref
from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.core.gaussians import Gaussians
from guassianhand_tpu_torch.ops import rasterize_cuda
from guassianhand_tpu_torch.ops.binning import bin_gaussians
from guassianhand_tpu_torch.ops.projection import project_gaussians
from guassianhand_tpu_torch.ops.rasterize_cuda import (composite_backward,
                                                       composite_forward,
                                                       pack_attrs)
from guassianhand_tpu_torch.ops.rasterize_ref import composite_reference
from tests.torch_parity import (RASTER_ATOL, RASTER_RTOL,  # noqa: F401
                                one_torch_thread, to_torch)
from tests.utils import make_camera, make_gaussians

JCFG = RasterizeConfig(interpret=True, pack_rgb=False, max_tiles_per_gaussian=16,
                       max_blocks_per_tile=64, pairs_per_gaussian=16.0)


def close(got, want, atol=RASTER_ATOL, rtol=RASTER_RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def port_gaussians(g) -> Gaussians:
    return Gaussians(xyz=to_torch(g.xyz), opacity=to_torch(g.opacity),
                     rotation=to_torch(g.rotation), scaling=to_torch(g.scaling),
                     shs=to_torch(g.shs))


def port_camera(cam, h, w) -> Camera:
    return Camera.from_w2c(np.asarray(cam.w2c), np.asarray(cam.K), h, w,
                           device="cpu")


@pytest.fixture(scope="module")
def scene():
    """300 Gaussians in front of a 64x64 camera, projected by JAX."""
    h = w = 64
    cam = make_camera(h, w)
    g = make_gaussians(300, seed=1)
    proj = jax.jit(j_project)(g.xyz, g.scaling, g.rotation, cam)
    rng = np.random.RandomState(2)
    color = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    tile_flat, overflow = jax.jit(lambda m, r, v, o: jbin.enumerate_tiles(
        m, r, v, height=h, width=w, cfg=JCFG.binning(), opacity=o))(
            proj.mean2d, proj.radius, proj.visible, g.opacity[:, 0])
    assert int(overflow) == 0
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = jax.jit(lambda *a: j_ref(*a, h, w, jnp.asarray(bg)))(
        proj.mean2d, proj.conic, jnp.asarray(color), g.opacity[:, 0],
        proj.depth, proj.radius, proj.visible)
    return {"h": h, "w": w, "cam": cam, "g": g, "color": color, "bg": bg,
            "opacity": np.asarray(g.opacity[:, 0]),
            "mean2d": np.asarray(proj.mean2d), "conic": np.asarray(proj.conic),
            "depth": np.asarray(proj.depth), "radius": np.asarray(proj.radius),
            "visible": np.asarray(proj.visible),
            "tile_flat": np.asarray(tile_flat),
            "ref": [np.asarray(x) for x in ref]}


def test_projection_matches_jax(scene):
    g = scene["g"]
    got = project_gaussians(to_torch(g.xyz), to_torch(g.scaling),
                            to_torch(g.rotation),
                            port_camera(scene["cam"], scene["h"], scene["w"]))
    close(got.mean2d, scene["mean2d"], atol=1e-4, rtol=1e-6)
    close(got.depth, scene["depth"], atol=1e-6, rtol=1e-6)
    close(got.conic, scene["conic"], atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(got.radius.numpy(), scene["radius"])
    np.testing.assert_array_equal(got.visible.numpy(), scene["visible"])


def _jax_bins(scene, cfg=JCFG):
    """The JAX binner's per-tile pair lists (Gaussian ids in depth order)."""
    h, w = scene["h"], scene["w"]
    b = jbin.bin_gaussians(
        jnp.asarray(scene["mean2d"]), jnp.asarray(scene["depth"]),
        jnp.asarray(scene["radius"]), jnp.asarray(scene["visible"]),
        height=h, width=w, cfg=cfg.binning())
    assert int(b.overflow) == 0
    g = cfg.block_size
    gidx = np.asarray(b.pair_gidx).reshape(-1, g)
    tob = np.asarray(b.tile_of_block)
    counts = np.asarray(b.counts)
    tiles = {}
    for blk, t in enumerate(tob):
        if t < len(counts) - 1:
            tiles.setdefault(int(t), []).extend(gidx[blk].tolist())
    return {t: ids[:counts[t]] for t, ids in tiles.items()}, counts[:-1]


def test_binning_pairs_per_tile_match_jax(scene):
    """Without the cull the pair set is the rect enumeration; both binners
    must keep the same pairs per tile, in the same (depth, stable) order."""
    want, want_counts = _jax_bins(scene)
    bins = bin_gaussians(to_torch(scene["mean2d"]), to_torch(scene["depth"]),
                         to_torch(scene["radius"]), to_torch(scene["visible"]),
                         height=scene["h"], width=scene["w"])
    np.testing.assert_array_equal(bins.counts().numpy(), want_counts)
    tr = bins.tile_range.numpy()
    gid = bins.pair_gid.numpy()
    for t, ids in want.items():
        assert gid[tr[t]:tr[t + 1]].tolist() == ids, t


def test_opacity_cull_keeps_pairs_of_jax_binner(scene):
    """With the cull, the per-tile counts equal the JAX enumeration's."""
    h, w = scene["h"], scene["w"]
    tile_flat = scene["tile_flat"]
    ntiles = ((h + 15) // 16) * ((w + 15) // 16)
    want = np.bincount(tile_flat, minlength=ntiles + 1)[:ntiles]
    bins = bin_gaussians(to_torch(scene["mean2d"]), to_torch(scene["depth"]),
                         to_torch(scene["radius"]), to_torch(scene["visible"]),
                         height=h, width=w, opacity=to_torch(scene["opacity"]))
    np.testing.assert_array_equal(bins.counts().numpy(), want)


def test_composite_twin_matches_jax_kernel_and_reference(scene):
    """K1's plain twin against the JAX Pallas composite_forward (interpret
    mode) and against the dense JAX oracle, on the same projected inputs."""
    h, w = scene["h"], scene["w"]
    rgb_j, t_j, _, overflow = jax.jit(
        lambda *a: _composite(*a, h, w, JCFG))(
            *[jnp.asarray(scene[k]) for k in ("mean2d", "conic", "color",
                                              "opacity", "tile_flat",
                                              "depth")])
    assert int(overflow) == 0
    ref_rgb, _, ref_t = scene["ref"]
    ref_rgb = ref_rgb - ref_t[..., None] * scene["bg"]

    mean2d, conic = to_torch(scene["mean2d"]), to_torch(scene["conic"])
    op_t = to_torch(scene["opacity"])
    bins = bin_gaussians(mean2d, to_torch(scene["depth"]),
                         to_torch(scene["radius"]), to_torch(scene["visible"]),
                         height=h, width=w, opacity=op_t)
    rgb, final_t = composite_forward(
        bins.tile_range, bins.pair_gid,
        pack_attrs(mean2d, conic, to_torch(scene["color"]), op_t),
        height=h, width=w)
    assert rasterize_cuda.composite_forward.launches == 0
    for want_rgb, want_t in ((rgb_j, t_j), (ref_rgb, ref_t)):
        close(rgb, want_rgb)
        close(final_t, want_t)
    assert float(1.0 - final_t.min()) > 0.5   # the scene is not empty


def test_composite_twin_counts_the_kernels_operations():
    """count_ops: per pixel, the fp32 operations of each pair step the
    forward and backward kernels' loops take, and the forward's n_contrib,
    against those loops written out, on one tile whose pairs reach every
    gate: conics that are not positive definite (power > 0), faint splats
    (alpha < 1/255) and enough opacity to stop most pixels (T below
    1e-4)."""
    rng = np.random.RandomState(9)
    n = 160
    rows = np.stack([rng.uniform(0, 16, n), rng.uniform(0, 16, n),
                     rng.uniform(0.01, 2.0, n), rng.uniform(-0.4, 0.4, n),
                     rng.uniform(0.01, 2.0, n), rng.uniform(0.2, 0.99, n),
                     *rng.uniform(0, 1, (3, n))], 1).astype(np.float32)
    tile_range = torch.tensor([0, n], dtype=torch.int32)
    pair_gid = torch.arange(n, dtype=torch.int32)
    rgb, final_t, contrib, checkpoints, slot_base, ops = \
        rasterize_cuda.composite_plain(tile_range, pair_gid, to_torch(rows),
                                       height=16, width=16,
                                       store_contrib=True, count_ops=True)
    _, bwd_ops = rasterize_cuda.composite_backward_plain(
        tile_range, pair_gid, to_torch(rows), torch.ones((16, 16, 3)),
        torch.ones((16, 16)), rgb, final_t, contrib, checkpoints, slot_base,
        height=16, width=16, count_ops=True)
    stopped = 0
    for py in range(16):
        for px in range(16):
            t, count, last, gates = np.float32(1.0), 0, 0, []
            for i, (x, y, a, b, c, o, *_) in enumerate(rows):
                count += rasterize_cuda.OPS_EVALUATED
                dx, dy = x - np.float32(px), y - np.float32(py)
                power = np.float32(-0.5) * (a * dx * dx + c * dy * dy) \
                    - b * dx * dy
                if power > 0:
                    gates.append(0)
                    continue
                count += rasterize_cuda.OPS_PAST_POWER
                alpha = min(np.float32(0.99), o * np.exp(power))
                if alpha < np.float32(1 / 255):
                    gates.append(1)
                    continue
                count += rasterize_cuda.OPS_PAST_ALPHA
                if t * (np.float32(1) - alpha) < np.float32(1e-4):
                    stopped += 1
                    break
                count += rasterize_cuda.OPS_ACCEPTED
                t = t * (np.float32(1) - alpha)
                gates.append(2)
                last = i + 1
            assert int(ops[py, px]) == count, (py, px)
            assert float(final_t[py, px]) == pytest.approx(t, rel=1e-4)
            assert int(contrib[py, px]) == last, (py, px)
            gates = gates[:last]
            assert int(bwd_ops[py, px]) == (
                rasterize_cuda.OPS_BWD_EVALUATED * last
                + rasterize_cuda.OPS_BWD_PAST_POWER * sum(
                    k > 0 for k in gates)
                + rasterize_cuda.OPS_BWD_LIVE * gates.count(2)), (py, px)
    assert 0 < stopped < 256


def test_composite_reference_port_matches_jax(scene):
    keys = ("mean2d", "conic", "color", "opacity", "depth", "radius",
            "visible")
    got = composite_reference(*[to_torch(scene[k]) for k in keys],
                              scene["h"], scene["w"], to_torch(scene["bg"]))
    for a, b in zip(got, scene["ref"]):
        close(a, b)


def test_composite_forward_rejects_bad_inputs():
    tr = torch.zeros(5, dtype=torch.int32)
    gid = torch.zeros(0, dtype=torch.int32)
    attrs = torch.zeros((3, 9))
    with pytest.raises(ValueError, match="float32"):
        composite_forward(tr, gid, attrs.double(), height=32, width=32)
    with pytest.raises(ValueError, match="tile_range"):
        composite_forward(tr[:4], gid, attrs, height=32, width=32)
    with pytest.raises(ValueError, match="unsupported device"):
        composite_forward(tr.to("meta"), gid.to("meta"), attrs.to("meta"),
                          height=32, width=32)
    rgb, final_t = composite_forward(tr, gid, attrs, height=32, width=32)
    assert rgb.abs().max() == 0 and final_t.min() == 1


def test_composite_backward_rejects_bad_inputs():
    tr = torch.tensor([0, 0, 0, 0, 0], dtype=torch.int32)
    gid = torch.zeros(0, dtype=torch.int32)
    attrs = torch.zeros((3, 9))
    img = (torch.zeros((32, 32, 3)), torch.zeros((32, 32)),
           torch.zeros((32, 32, 3)), torch.ones((32, 32)),
           torch.zeros((32, 32), dtype=torch.int32), torch.zeros((0, 256, 4)),
           torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="n_contrib"):
        composite_backward(tr, gid, attrs, *img[:4], img[4].long(), *img[5:],
                           height=32, width=32)
    with pytest.raises(ValueError, match="grad_rgb"):
        composite_backward(tr, gid, attrs, img[0][:, :16], *img[1:],
                           height=32, width=32)
    assert composite_backward(tr, gid, attrs, *img, height=32,
                              width=32).shape == (9, 0)
