"""rasterize and rasterize_multiview of the PyTorch port held against the
JAX package on the CPU, end to end: forward, and the gradients with respect
to xyz, scaling, rotation, opacity and shs, with the sorted-segment
reduction's twin against the JAX Pallas reduction.

The JAX side runs as its own tests run it (tests/test_torch_rasterize.py,
``JCFG``): Pallas in interpret mode, exact colours, overflow 0. The port's
composite runs through its plain twins: the forward's, the backward's and
the sorted-segment reduction's.

Tolerances: the forward's of tests/test_rasterize.py, atol 2e-5 and rtol
1e-4 (fp32 reassociation of the colour sums); gradients at atol 2e-4 *
scale + rtol 2e-3, scale the largest |gradient| of the array, as
tests/test_rasterize.py holds gradients (the backward's transmittances and
suffix sums are taken in another order than JAX's, and the per-Gaussian
sums cancel).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.core.gaussians import Gaussians as JGaussians
from guassianhand_tpu.ops.rasterize import rasterize as j_rasterize
from guassianhand_tpu.ops.rasterize import rasterize_multiview as j_multiview
from guassianhand_tpu.ops.segreduce_pallas import \
    segment_reduce_sorted as j_segment_reduce
from guassianhand_tpu_torch.core.gaussians import Gaussians
from guassianhand_tpu_torch.ops.projection import project_gaussians
from guassianhand_tpu_torch.ops.rasterize import (_colors, rasterize,
                                                  rasterize_multiview,
                                                  render_gaussians)
from guassianhand_tpu_torch.ops.rasterize_ref import composite_reference
from guassianhand_tpu_torch.ops.segreduce_cuda import (segment_reduce_plain,
                                                       segment_reduce_sorted)
from tests.test_torch_rasterize import (JCFG, close, port_camera,
                                        port_gaussians)
from tests.torch_parity import one_torch_thread, to_torch  # noqa: F401
from tests.utils import make_camera, make_gaussians

GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3


LEAVES = ("xyz", "scaling", "rotation", "opacity", "shs")


def jax_leaves(g):
    return (g.xyz, g.scaling, g.rotation, g.opacity, g.shs)


def bench_loss(rgb, mask, target):
    """bench.py::main's loss; |x| has the same gradient in both packages
    away from 0, and no pixel here equals its target."""
    return abs(rgb - target).mean() + (mask ** 2).mean()


def bench_target(*shape):
    return np.random.RandomState(8).uniform(0, 1, (*shape, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def jax_raster_grad(h, w, sh_degree=None, multiview=False):
    """jax.jit of the bench loss over the JAX raster (Pallas interpret
    mode, JCFG) and its gradients with respect to LEAVES, with the raster's
    outputs as aux; ``multiview`` stacks the views of (w2cs, Ks) through
    rasterize_multiview. Gaussians, cameras, background and target are
    arguments, so the forward and the gradient tests of one shape share one
    compilation."""
    kw = {"use_rgb": True} if sh_degree is None else {"sh_degree": sh_degree}

    def loss(leaves, valid, cams, bg, target):
        g = JGaussians(**dict(zip(LEAVES, leaves)), valid=valid)
        if multiview:
            out = j_multiview(g, *cams, height=h, width=w, background=bg,
                              config=JCFG, **kw)
        else:
            out = j_rasterize(g, cams, height=h, width=w, background=bg,
                              config=JCFG, **kw)
        return bench_loss(out["comp_rgb"], out["comp_mask"], target), out

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def jax_raster(g, cams, bg, target, sh_degree=None, multiview=False):
    """The JAX raster's outputs and the bench loss's gradients; the image
    size is the target's. Asserts overflow 0."""
    h, w = target.shape[-3:-1]
    (_, out), grads = jax_raster_grad(h, w, sh_degree, multiview)(
        jax_leaves(g), g.valid, cams, jnp.asarray(bg), jnp.asarray(target))
    assert int(out["overflow"]) == 0
    return out, grads


@pytest.mark.parametrize("hw,sh_degree", [((64, 64), None), ((60, 100), 3)])
def test_rasterize_matches_jax(hw, sh_degree):
    """The whole forward with a background: precomputed RGB at 64x64, and
    SH colours at 100x60, which 16-px tiles do not divide."""
    h, w = hw
    use_rgb = sh_degree is None
    kw = {"use_rgb": True} if use_rgb else {"sh_degree": sh_degree}
    cam = make_camera(h, w)
    g = make_gaussians(300, seed=3, sh_degree=0 if use_rgb else sh_degree)
    bg = np.array([0.2, 0.5, 0.1], np.float32)
    want, _ = jax_raster(g, cam, bg, bench_target(h, w), sh_degree)
    got = rasterize(port_gaussians(g), port_camera(cam, h, w), height=h,
                    width=w, background=to_torch(bg), **kw)
    for k in ("comp_rgb", "comp_mask", "final_t", "radii"):
        close(got[k], want[k])
    assert got["n_pairs"] == int(want["n_pairs"])
    assert got["overflow"] == 0
    by_matrices = render_gaussians(
        port_gaussians(g), np.asarray(cam.w2c), np.asarray(cam.K), height=h,
        width=w, background=to_torch(bg), **kw)
    torch.testing.assert_close(by_matrices["comp_rgb"], got["comp_rgb"],
                               atol=0, rtol=0)


def orbit_views(cam, angles):
    """(w2cs, Ks) of ``cam`` turned by each angle about the y axis."""
    w2c0 = np.asarray(cam.w2c)
    w2cs = np.stack([w2c0 @ np.array(
        [[np.cos(a), 0, np.sin(a), 0], [0, 1, 0, 0],
         [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]], np.float32)
        for a in angles])
    return w2cs, np.stack([np.asarray(cam.K)] * len(angles))


def test_rasterize_multiview_matches_jax():
    """Three views of a 40-row image (not tile aligned) on one stacked
    canvas, with validity-masked slots and a background."""
    h, w = 40, 48
    cam = make_camera(h, w)
    g = make_gaussians(200, seed=5)
    rng = np.random.RandomState(6)
    valid = (rng.uniform(size=200) > 0.3).astype(np.float32)
    w2cs, Ks = orbit_views(cam, (0.0, 0.3, 0.6))
    bg = np.array([0.3, 0.3, 0.6], np.float32)
    gj = dataclasses.replace(g, valid=jnp.asarray(valid))
    want, _ = jax_raster(gj, (jnp.asarray(w2cs), jnp.asarray(Ks)), bg,
                         bench_target(3, h, w), multiview=True)
    gt = dataclasses.replace(port_gaussians(g), valid=to_torch(valid))
    got = rasterize_multiview(gt, to_torch(w2cs), to_torch(Ks), height=h,
                              width=w, background=to_torch(bg), use_rgb=True)
    for k in ("comp_rgb", "comp_mask", "final_t"):
        close(got[k], want[k])
    assert got["n_pairs"] == int(want["n_pairs"])


def grads_close(got, want, what=""):
    for name, g, w in zip(LEAVES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.isfinite(g).all(), (what, name)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL * scale,
                                   rtol=GRAD_RTOL, err_msg=f"{what} {name}")


def torch_leaves(g):
    return [to_torch(x).requires_grad_() for x in jax_leaves(g)]


def behind_camera(g, n_behind=20):
    """``g`` with its first Gaussians behind the camera or inside the near
    plane (camera-space z <= 0.2), which the projection culls."""
    xyz = np.asarray(g.xyz).copy()
    xyz[:n_behind, 2] = np.linspace(-3.5, -2.35, n_behind)
    return dataclasses.replace(g, xyz=jnp.asarray(xyz))


@pytest.mark.parametrize("hw,sh_degree", [((64, 64), None), ((60, 100), 3)])
def test_rasterize_gradients_match_jax_and_oracle(hw, sh_degree):
    """Gradients of the bench loss with respect to xyz, scaling, rotation,
    opacity and shs: the port (forward, backward and reduction twins)
    against jax.grad through the JAX Pallas path and against autograd
    through the port's dense oracle. Precomputed RGB at 64x64, SH colours
    at 100x60; 20 Gaussians sit behind the camera and must get finite
    (zero) gradients."""
    h, w = hw
    use_rgb = sh_degree is None
    kw = {"use_rgb": True} if use_rgb else {"sh_degree": sh_degree}
    cam = make_camera(h, w)
    g = behind_camera(make_gaussians(300, seed=7, sh_degree=0 if use_rgb
                                     else sh_degree))
    bg = np.array([0.2, 0.5, 0.1], np.float32)
    target = bench_target(h, w)
    _, want = jax_raster(g, cam, bg, target, sh_degree)
    leaves = torch_leaves(g)
    tcam = port_camera(cam, h, w)
    out = rasterize(Gaussians(*[leaves[i] for i in (0, 3, 2, 1, 4)]), tcam,
                    height=h, width=w, background=to_torch(bg), **kw)
    got = torch.autograd.grad(bench_loss(out["comp_rgb"], out["comp_mask"],
                                         to_torch(target)), leaves)
    grads_close(got, want, "vs jax")
    assert float(got[0][:20].abs().max()) == 0.0

    xyz, scaling, rotation, opacity, shs = oracle = torch_leaves(g)
    proj = project_gaussians(xyz, scaling, rotation, tcam)
    color = _colors(Gaussians(xyz, opacity, rotation, scaling, shs), tcam,
                    sh_degree or 0, use_rgb)
    rgb, mask, _ = composite_reference(
        proj.mean2d, proj.conic, color, opacity[:, 0], proj.depth,
        proj.radius, proj.visible, h, w, to_torch(bg))
    want_oracle = torch.autograd.grad(
        bench_loss(rgb, mask, to_torch(target)), oracle)
    grads_close(got, want_oracle, "vs oracle")


def test_rasterize_multiview_gradients_match_jax():
    """Three views of a 40x48 image stacked on one canvas (one composite
    and one backward for all), with validity-masked slots and a
    background: the gradients against jax.grad through the JAX multi-view
    raster."""
    h, w = 40, 48
    cam = make_camera(h, w)
    g = make_gaussians(200, seed=9)
    valid = (np.random.RandomState(10).uniform(size=200) > 0.3).astype(
        np.float32)
    w2cs, Ks = orbit_views(cam, (0.0, 0.4, 0.8))
    bg = np.array([0.3, 0.3, 0.6], np.float32)
    target = bench_target(3, h, w)
    _, want = jax_raster(dataclasses.replace(g, valid=jnp.asarray(valid)),
                         (jnp.asarray(w2cs), jnp.asarray(Ks)), bg, target,
                         multiview=True)
    leaves = torch_leaves(g)
    gt = Gaussians(*[leaves[i] for i in (0, 3, 2, 1, 4)],
                   valid=to_torch(valid))
    out = rasterize_multiview(gt, to_torch(w2cs), to_torch(Ks), height=h,
                              width=w, background=to_torch(bg), use_rgb=True)
    got = torch.autograd.grad(bench_loss(out["comp_rgb"], out["comp_mask"],
                                         to_torch(target)), leaves)
    grads_close(got, want, "multiview")


def test_alpha_clamp_passes_gradient_straight_through():
    """One wide Gaussian of opacity 0.999 centred on a 32x32 image: at the
    four central pixels alpha = 0.999 exp(power) > 0.99 is clamped, and the
    loss reads only those pixels. The opacity gradient is then non-zero
    only under the straight-through rule of the CUDA reference and of both
    packages' backward kernels; the dense oracle had a clamp whose gradient
    is 0 there."""
    h = w = 32
    cam = make_camera(h, w)
    g = make_gaussians(1, seed=12)
    g = dataclasses.replace(
        g, xyz=jnp.zeros((1, 3)), opacity=jnp.full((1, 1), 0.999),
        scaling=jnp.full((1, 3), 0.9), rotation=jnp.asarray([[1.0, 0, 0, 0]]))

    def centre(rgb):
        return rgb[15:17, 15:17].sum()

    def j_loss(*leaves):
        out = j_rasterize(dataclasses.replace(g, **dict(zip(LEAVES, leaves))),
                          cam, height=h, width=w, use_rgb=True, config=JCFG)
        return centre(out["comp_rgb"])

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3, 4)))(*jax_leaves(g))
    leaves = torch_leaves(g)
    out = rasterize(Gaussians(*[leaves[i] for i in (0, 3, 2, 1, 4)]),
                    port_camera(cam, h, w), height=h, width=w, use_rgb=True)
    got = torch.autograd.grad(centre(out["comp_rgb"]), leaves)
    assert abs(float(got[3])) > 1e-3
    grads_close(got, want, "clamp")

    xyz, scaling, rotation, opacity, shs = oracle = torch_leaves(g)
    proj = project_gaussians(xyz, scaling, rotation, port_camera(cam, h, w))
    # power at the central pixels, -0.25 A, is above log(0.99 / 0.999)
    assert float(proj.conic[0, 0].detach()) * 0.25 < np.log(0.999 / 0.99)
    rgb, _, _ = composite_reference(
        proj.mean2d, proj.conic, shs[:, 0], opacity[:, 0], proj.depth,
        proj.radius, proj.visible, h, w, torch.zeros(3))
    grads_close(got, torch.autograd.grad(centre(rgb), oracle), "oracle")


def test_segment_reduce_twin_matches_jax():
    """K3's twin and wrapper against the JAX Pallas sorted-segment
    reduction (interpret mode) and ``segment_sum``: 9 rows, ascending ids
    with empty segments and trash ids >= n, at 1e-5 (fp32 sums in another
    order)."""
    rng = np.random.RandomState(13)
    n, pp = 300, 1500
    ids = np.sort(rng.choice(np.arange(n + 40), pp)).astype(np.int32)
    ids[ids % 7 == 3] += 1                     # leave some segments empty
    ids = np.sort(ids)
    vals = rng.normal(size=(9, pp)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda i, v: j_segment_reduce(i, v, n, interpret=True))(ids, vals))
    want_sum = np.asarray(jax.ops.segment_sum(vals.T, ids, num_segments=n))
    assert (np.bincount(ids, minlength=n)[:n] == 0).any() and ids.max() >= n
    got = segment_reduce_sorted(to_torch(ids), to_torch(vals), n)
    assert got.shape == (n, 9)
    close(got, want, atol=1e-5, rtol=1e-5)
    close(got, want_sum, atol=1e-5, rtol=1e-5)
    close(segment_reduce_plain(to_torch(ids[:0]), to_torch(vals[:, :0]), n),
          np.zeros((n, 9)), atol=0, rtol=0)
