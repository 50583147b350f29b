"""The port's fused projection (K4) with a view axis, and the sorted-segment
reduction (K3) read through a permutation, held against the JAX package on
the CPU.

- K4's twins under a stack of V = 3 cameras, one of which culls every
  Gaussian, against ``jax.vmap`` of ``project_gaussians_pallas
  (interpret=True)`` (as ``ops/rasterize.py`` batches the views) and the
  adjoint against ``jax.grad`` of that vmapped forward; the stacked twins
  against the single-camera twins to the bit (the kernel rounds as they
  do); ``rasterize_multiview`` over 2 views on the ``"pallas"`` route
  against ``"xla"``.
- K3's twin with ``order`` against ``segreduce_pallas.segment_reduce_sorted
  (interpret=True)`` on the ids sorted as JAX sorts them (a key-value sort
  carrying the value rows), with empty leading, interior and trailing
  segments and ids >= n; P = 0 and n = 0 against a numpy sum.

Tolerances, each with its reason:
- forward: tests/test_torch_projection.py's (mean2d rtol 1e-5 atol 1e-4,
  depth 1e-6, conic rtol 1e-4 atol 1e-5 on visible rows; a radius one apart
  only where JAX's value before the ceil is within 4 ulp of an integer;
  ``visible`` apart only where det has cancelled), view by view;
- adjoint: rtol 2e-4 + atol 2e-5 * scale, tests/test_projection_pallas.py's
  gradient tolerance, on the Gaussians visible in every view that sees
  them (a row's gradient sums its views);
- stacked against single-camera twins: equal, the same operations on the
  same values;
- rasterize pallas against xla: tests/test_projection_pallas.py's end-to-end
  tolerance (value rtol 1e-5, gradient rtol 1e-3 + atol 1e-4 * scale);
- segment sums: atol 1e-6, rtol 1e-5 (fp32 sums of up to a few hundred
  terms in another order: JAX's unstable sort, the twin's stable order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.core.camera import Camera as JCamera
from guassianhand_tpu.ops import projection_pallas as jpp
from guassianhand_tpu.ops.segreduce_pallas import \
    segment_reduce_sorted as j_segment_reduce
from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.ops import projection_cuda as pc
from guassianhand_tpu_torch.ops.rasterize import (RasterizeConfig,
                                                  rasterize_multiview)
from guassianhand_tpu_torch.ops.segreduce_cuda import (segment_reduce_plain,
                                                       segment_reduce_sorted)
from tests.test_torch_projection import GRAD_ATOL, GRAD_RTOL
from tests.test_torch_rasterize import port_gaussians
from tests.torch_parity import one_torch_thread, to_torch  # noqa: F401
from tests.utils import make_camera, make_gaussians

H, W, N, V = 128, 160, 300, 3


def cameras():
    """(w2cs (V, 4, 4), Ks (V, 3, 3)) as numpy: the test camera, the same
    turned 0.3 rad about y, and one moved past the scene, so that every
    Gaussian lies behind it."""
    cam = make_camera(H, W)
    w2c, K = np.asarray(cam.w2c), np.asarray(cam.K)
    turned = w2c.copy()
    a = 0.3
    turned[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]]
    behind = w2c.copy()
    behind[2, 3] = -w2c[2, 3]
    return np.stack([w2c, turned, behind]), np.stack([K] * V)


def scene():
    g = make_gaussians(N, seed=4, scale_range=(0.002, 0.05))
    arrays = tuple(np.asarray(a, np.float32)
                   for a in (g.xyz, g.scaling, g.rotation))
    w2cs, Ks = cameras()
    consts = torch.stack([pc.camera_consts(Camera.from_w2c(w, k, H, W))
                          for w, k in zip(w2cs, Ks)])
    return arrays, w2cs, Ks, consts


def jax_cam(w2c, K):
    return JCamera.from_w2c(w2c, K, H, W)


@jax.jit
def jax_views(xyz, scaling, rotation, w2cs, Ks):
    """jax.vmap over the views of JAX's fused projection in interpret mode,
    with 3 sqrt(lambda_max) before its ceil and whether det cancelled."""
    def one(w2c, K):
        cam = jax_cam(w2c, K)
        p = jpp.project_gaussians_pallas(xyz, scaling, rotation, cam,
                                         interpret=True)
        cols = [xyz[:, i] for i in range(3)] \
            + [scaling[:, i] for i in range(3)] \
            + [rotation[:, i] for i in range(4)]
        f = jpp._fwd_math(jpp._camera_consts(cam, 0.01, 1000.0), *cols)
        mid = 0.5 * (f["a"] + f["c"])
        disc = jnp.sqrt(jnp.maximum(0.1, mid * mid - f["det"]))
        pre = 3.0 * jnp.sqrt(jnp.maximum(mid + disc, 0.0))
        cancelled = jnp.abs(f["det"]) <= 1e-4 * f["a"] * f["c"]
        return (p.mean2d, p.depth, p.conic, p.radius, p.visible, pre,
                cancelled)
    return jax.vmap(one)(w2cs, Ks)


def test_view_axis_twin_matches_jax_vmap():
    """The forward twin under (V, 30) constants against JAX's vmapped fused
    projection, view by view; the third view culls every Gaussian."""
    arrays, w2cs, Ks, consts = scene()
    m2, depth, conic, radius, visible, pre, cancelled = (
        np.asarray(x) for x in jax_views(*arrays, w2cs, Ks))
    got = pc.project_forward(*(to_torch(a) for a in arrays), consts)
    assert [tuple(t.shape) for t in got] == [
        (V, N, 2), (V, N), (V, N, 3), (V, N), (V, N)]
    g_m2, g_depth, g_conic, g_radius, g_vis = (t.numpy() for t in got)
    assert visible[0].all() and visible[1].sum() > N // 2
    assert not visible[2].any() and not g_vis[2].any()
    assert (g_radius[2] == 0).all()
    for v in range(V):
        flipped = g_vis[v] != visible[v]
        assert np.all(cancelled[v][flipped]), (v, np.nonzero(flipped))
        vis = visible[v] & ~cancelled[v]
        np.testing.assert_allclose(g_m2[v][vis], m2[v][vis], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(g_depth[v], depth[v], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(g_conic[v][vis], conic[v][vis], rtol=1e-4,
                                   atol=1e-5)
        diff = (g_radius[v] - radius[v])[vis]
        p = pre[v][vis]
        apart = diff != 0
        near = np.abs(p - np.round(p)) <= 4 * np.spacing(np.abs(p))
        assert np.all(np.abs(diff[apart]) == 1) and np.all(near[apart])


def test_view_axis_adjoint_matches_jax_grad():
    """The adjoint twin under (V, 30) constants, cotangents (V, N, 2) and
    (V, N, 3), against jax.grad of the vmapped forward: the gradients of
    xyz, scaling and rotation summed over the views."""
    arrays, w2cs, Ks, consts = scene()
    vis = np.asarray(jax_views(*arrays, w2cs, Ks)[4])
    rng = np.random.RandomState(6)
    cm = (rng.normal(size=(V, N, 2)) * vis[..., None]).astype(np.float32)
    cc = (rng.normal(size=(V, N, 3)) * vis[..., None]).astype(np.float32)

    def f(xyz, scaling, rotation):
        def one(w2c, K):
            p = jpp.project_gaussians_pallas(xyz, scaling, rotation,
                                             jax_cam(w2c, K), interpret=True)
            return p.mean2d, p.conic
        m2, conic = jax.vmap(one)(w2cs, Ks)
        return jnp.sum(m2 * cm) + jnp.sum(conic * cc)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*arrays)
    got = pc.project_backward(*(to_torch(a) for a in arrays), consts,
                              to_torch(cm), to_torch(cc))
    rows = vis.any(axis=0)
    assert rows.sum() > N // 2
    for name, a, b in zip(("xyz", "scaling", "rotation"), got, want):
        a, b = a.numpy()[rows], np.asarray(b)[rows]
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_stacked_twins_equal_single_camera_twins():
    """Under (V, 30) constants the twins give each view's single-camera
    outputs to the bit, and the adjoint their gradients added in view
    order; a wrong cotangent shape raises."""
    arrays, _, _, consts = scene()
    rows = [to_torch(a) for a in arrays]
    stacked = pc.project_plain(*rows, consts)
    rng = np.random.RandomState(7)
    cm = to_torch(rng.normal(size=(V, N, 2)).astype(np.float32))
    cc = to_torch(rng.normal(size=(V, N, 3)).astype(np.float32))
    grads = pc.project_adjoint_plain(*rows, consts, cm, cc)
    total = None
    for v in range(V):
        for a, b in zip(stacked, pc.project_plain(*rows, consts[v])):
            assert torch.equal(a[v], b)
        g = pc.project_adjoint_plain(*rows, consts[v], cm[v], cc[v])
        total = g if total is None else [t + x for t, x in zip(total, g)]
    for a, b in zip(grads, total):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pc.project_backward(*rows, consts, cm[0], cc)


def test_multiview_rasterize_pallas_matches_xla():
    """rasterize_multiview over 2 views with projection_impl="pallas" (one
    stacked projection) against "xla" (a projection a view): the images and
    the xyz gradient."""
    g = make_gaussians(600, seed=2, scale_range=(0.002, 0.05))
    w2cs, Ks = cameras()
    w2cs, Ks = to_torch(w2cs[:2]), to_torch(Ks[:2])

    def run(impl):
        gs = port_gaussians(g)
        xyz = gs.xyz.requires_grad_()
        out = rasterize_multiview(
            dataclasses.replace(gs, xyz=xyz), w2cs, Ks, height=H, width=W,
            use_rgb=True, config=RasterizeConfig(projection_impl=impl))
        v = out["comp_rgb"].mean() + out["comp_mask"].mean()
        (gr,) = torch.autograd.grad(v, [xyz])
        return out["comp_rgb"].detach().numpy(), gr.numpy()

    rgb_a, gra = run("xla")
    rgb_b, grb = run("pallas")
    assert rgb_a.shape == (2, H, W, 3)
    np.testing.assert_allclose(rgb_b, rgb_a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grb, gra, rtol=1e-3,
                               atol=1e-4 * (np.abs(gra).max() + 1e-9))


def jax_sorted(ids, vals):
    """The pairs sorted as ops/rasterize.py sorts them before its
    reduction: one key-value sort carrying the value rows."""
    out = jax.lax.sort((jnp.asarray(ids), *jnp.asarray(vals)), num_keys=1,
                       is_stable=False)
    return np.asarray(out[0]), np.stack([np.asarray(x) for x in out[1:]])


def test_permuted_segment_reduce_matches_jax():
    """segment_reduce_sorted(ids, vals, n, order=order) on unsorted pair
    ids and their stable order against JAX's Pallas reduction (interpret
    mode) of the same pairs sorted the JAX way: empty leading, interior and
    trailing segments, ids >= n. P = 0 and n = 0 against a numpy sum."""
    rng = np.random.RandomState(17)
    n, pp = 400, 2000
    sorted_ids = np.sort(rng.randint(20, n + 30, pp))
    sorted_ids[sorted_ids % 9 == 4] += 1       # empty interior segments
    sorted_ids = np.sort(sorted_ids[sorted_ids != n - 1]).astype(np.int32)
    pp = len(sorted_ids)
    ids = sorted_ids[rng.permutation(pp)]
    vals = rng.normal(size=(9, pp)).astype(np.float32)
    counts = np.bincount(ids, minlength=n + 40)[:n]
    assert counts[:20].sum() == 0 and counts[-1] == 0 and ids.max() >= n
    assert (counts[20:-1] == 0).any()
    j_ids, j_vals = jax_sorted(ids, vals)
    want = np.asarray(jax.jit(
        lambda i, v: j_segment_reduce(i, v, n, interpret=True))(j_ids, j_vals))
    order = torch.argsort(to_torch(ids), stable=True).to(torch.int32)
    got = segment_reduce_sorted(to_torch(ids), to_torch(vals), n, order=order)
    assert got.shape == (n, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    # without order, on the sorted pairs: the same sums in the same order
    srt = order.long()
    assert torch.equal(segment_reduce_sorted(
        to_torch(ids)[srt].contiguous(), to_torch(vals)[:, srt].contiguous(),
        n), got)
    with pytest.raises(ValueError):
        segment_reduce_sorted(to_torch(ids), to_torch(vals), n,
                              order=order.long())
    empty = np.zeros(0, np.int32)
    for ids_e, vals_e, n_e in ((empty, np.zeros((9, 0), np.float32), n),
                               (ids, vals, 0)):
        want_e = np.zeros((n_e, 9), np.float32)
        np.add.at(want_e, ids_e[ids_e < n_e], vals_e.T[ids_e < n_e])
        got_e = segment_reduce_plain(
            to_torch(ids_e), to_torch(vals_e), n_e,
            order=torch.argsort(to_torch(ids_e), stable=True).to(torch.int32))
        np.testing.assert_array_equal(got_e.numpy(), want_e)
