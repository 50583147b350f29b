"""The port's fused projection (K4, ``ops/projection_cuda.py``) held
against the JAX package on the CPU: the forward twin against
``project_gaussians_pallas(interpret=True)``, the adjoint twin against
``jax.grad`` of it and against torch autograd of the forward twin, the edge
rows of ``chip_smoke.projection_edge_scene``, and ``rasterize`` with
``projection_impl="pallas"`` against ``"xla"``.

Tolerances, each with its reason:
- forward: those of tests/test_projection_pallas.py (mean2d rtol 1e-5 atol
  1e-4, depth 1e-6, conic rtol 1e-4 atol 1e-5) on visible rows, ``visible``
  equal. The twin follows the JAX kernel op for op, but XLA on the CPU may
  round a step apart; a radius may then differ by exactly 1, and only where
  JAX's value before the ceil lies within 4 ulp of an integer. ``visible``
  may differ only where det = a c - b^2 keeps fewer than 4 of fp32's 7
  digits (|det| <= 1e-4 a c; the edge scene's huge scales): a, b and c are
  sums of products of 1e6-sized terms that XLA and PyTorch round apart by
  a few parts in 1e6, so the sign of such a det is rounding, and so are
  the conic and the gradients of such a row, which are compared nowhere;
- adjoint against JAX: rtol 2e-4 + atol 2e-5 * scale, the gradient
  tolerance of tests/test_projection_pallas.py; against autograd of the
  twin: the same (autograd sums the chain in its own order);
- rasterize pallas against xla: tests/test_projection_pallas.py's end-to-end
  tolerance (value rtol 1e-5, gradient rtol 1e-3 + atol 1e-4 * scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import projection_edge_scene
from guassianhand_tpu.core.camera import Camera as JCamera
from guassianhand_tpu.ops import projection_pallas as jpp
from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.ops import projection_cuda as pc
from guassianhand_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from tests.test_torch_rasterize import port_gaussians
from tests.torch_parity import one_torch_thread, to_torch  # noqa: F401
from tests.utils import make_camera, make_gaussians

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def scene(n, seed):
    """tests/test_projection_pallas.py's scene: (JAX camera, JAX Gaussians,
    the port's camera)."""
    cam = make_camera(128, 160)
    g = make_gaussians(n, seed=seed, scale_range=(0.002, 0.05))
    return cam, g, port_camera(cam)


def port_camera(cam):
    return Camera.from_w2c(np.asarray(cam.w2c), np.asarray(cam.K),
                           int(cam.height), int(cam.width))


def edge_scene():
    xyz, scaling, rotation, w2c, K, h, w = projection_edge_scene()
    return (JCamera.from_w2c(w2c, K, h, w), (xyz, scaling, rotation),
            Camera.from_w2c(w2c, K, h, w))


@jax.jit
def jax_forward(xyz, scaling, rotation, cam):
    """JAX's fused projection in interpret mode, 3 sqrt(lambda_max) before
    its ceil, recomputed from _fwd_math's a, c and det, and whether det
    lost its sign to cancellation."""
    p = jpp.project_gaussians_pallas(xyz, scaling, rotation, cam,
                                     interpret=True)
    cs = jpp._camera_consts(cam, 0.01, 1000.0)
    cols = [xyz[:, i] for i in range(3)] + [scaling[:, i] for i in range(3)] \
        + [rotation[:, i] for i in range(4)]
    f = jpp._fwd_math(cs, *cols)
    mid = 0.5 * (f["a"] + f["c"])
    disc = jnp.sqrt(jnp.maximum(0.1, mid * mid - f["det"]))
    pre = 3.0 * jnp.sqrt(jnp.maximum(mid + disc, 0.0))
    cancelled = jnp.abs(f["det"]) <= 1e-4 * f["a"] * f["c"]
    return (p.mean2d, p.depth, p.conic, p.radius, p.visible, pre, cs,
            cancelled)


def jax_adjoint(xyz, scaling, rotation, cam, cm, cc):
    def f(a, b, c):
        p = jpp.project_gaussians_pallas(a, b, c, cam, interpret=True)
        return jnp.sum(p.mean2d * cm) + jnp.sum(p.conic * cc)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(xyz, scaling, rotation)


def check_forward(arrays, jcam, tcam):
    """The twin's forward against JAX's; returns the counts of radii one
    apart at a near-integer value and of visibilities apart at a cancelled
    det."""
    xyz, scaling, rotation = (np.asarray(a, np.float32) for a in arrays)
    m2, depth, conic, radius, visible, pre, jcs, cancelled = (
        np.asarray(x) for x in jax_forward(xyz, scaling, rotation, jcam))
    cs = pc.camera_consts(tcam)
    np.testing.assert_allclose(cs.numpy(), jcs, rtol=1e-6, atol=1e-6)
    p = pc.project_gaussians_pallas(to_torch(xyz), to_torch(scaling),
                                    to_torch(rotation), tcam)
    flipped = p.visible.numpy() != visible
    assert np.all(cancelled[flipped]), np.nonzero(flipped)
    vis = visible & ~cancelled
    np.testing.assert_allclose(p.mean2d.numpy()[vis], m2[vis], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(p.depth.numpy(), depth, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.conic.numpy()[vis], conic[vis], rtol=1e-4,
                               atol=1e-5)
    diff = (p.radius.numpy() - radius)[vis]
    pre = pre[vis]
    apart = diff != 0
    near = np.abs(pre - np.round(pre)) <= 4 * np.spacing(np.abs(pre))
    assert np.all(np.abs(diff[apart]) == 1), diff[apart]
    assert np.all(near[apart]), pre[apart]
    assert not p.radius.requires_grad
    return int(apart.sum()), int(flipped.sum())


@pytest.mark.parametrize("n,seed", [(3000, 0), (1500, 3)])
def test_forward_twin_matches_jax_pallas(n, seed):
    cam, g, tcam = scene(n, seed)
    apart, flipped = check_forward((g.xyz, g.scaling, g.rotation), cam, tcam)
    assert flipped == 0
    print(f"radii one apart at a near-integer value: {apart} of {n}")


def cotangents(n, vis, seed=0):
    rng = np.random.RandomState(seed)
    cm = (rng.normal(size=(n, 2)) * vis[:, None]).astype(np.float32)
    cc = (rng.normal(size=(n, 3)) * vis[:, None]).astype(np.float32)
    return cm, cc


def test_adjoint_twin_matches_jax_grad():
    """The hand-derived adjoint against jax.grad of JAX's fused projection
    (whose backward is JAX's adjoint kernel), visible rows."""
    cam, g, tcam = scene(1500, 3)
    vis = np.asarray(jax_forward(g.xyz, g.scaling, g.rotation, cam)[4])
    cm, cc = cotangents(1500, vis)
    want = jax_adjoint(g.xyz, g.scaling, g.rotation, cam, cm, cc)
    got = pc.project_backward(
        to_torch(g.xyz), to_torch(g.scaling), to_torch(g.rotation),
        pc.camera_consts(tcam), to_torch(cm), to_torch(cc))
    for name, a, b in zip(("xyz", "scaling", "rotation"), got, want):
        a, b = a.numpy()[vis], np.asarray(b)[vis]
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_adjoint_twin_matches_autograd_of_forward_twin():
    """project_adjoint_plain against torch autograd through
    project_plain's own ops, at all rows of the test scene and the edge
    scene: equal within tolerance on visible rows, exactly 0 elsewhere."""
    _, g, tcam = scene(1500, 3)
    for arrays, tcam in (((g.xyz, g.scaling, g.rotation), tcam),
                         edge_scene()[1:]):
        leaves = [to_torch(a).requires_grad_() for a in arrays]
        cs = pc.camera_consts(tcam)
        m2, _, conic, _, vis = pc.project_plain(*leaves, cs)
        cm, cc = (to_torch(c) for c in cotangents(len(vis), vis.numpy(), 1))
        want = torch.autograd.grad(
            (m2 * cm).sum() + (conic * cc).sum(), leaves)
        got = pc.project_adjoint_plain(*(t.detach() for t in leaves), cs,
                                       cm, cc)
        v = vis.numpy()
        for name, a, b in zip(("xyz", "scaling", "rotation"), got, want):
            a, b = a.numpy(), b.numpy()
            assert np.all(a[~v] == 0.0), name
            scale = np.abs(b[v]).max() + 1e-6
            np.testing.assert_allclose(a[v], b[v], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * scale, err_msg=name)


def test_edge_rows_match_jax():
    """Near-plane rows, rows past the 1.3 tan(fov / 2) clamp on both sides
    of both axes, det <= 0 from one huge scale, quaternions far from unit
    norm, and radii placed at integers: the forward against JAX, and the
    adjoint against JAX's on visible rows and 0 on the rest."""
    jcam, arrays, tcam = edge_scene()
    f = pc._fwd_math(pc.camera_consts(tcam),
                     *pc._columns(*(to_torch(a) for a in arrays)))
    in_front = f["in_front"].numpy()
    cs = pc.camera_consts(tcam)
    assert (~in_front).any() and ((f["det"] <= 0).numpy() & in_front).any()
    for r, lim in ((f["rx"], cs[26]), (f["ry"], cs[27])):
        assert (r > lim).any() and (r < -lim).any()
    apart, flipped = check_forward(arrays, jcam, tcam)
    print(f"edge scene: radii one apart at a near-integer value: {apart}, "
          f"visibility apart at a cancelled det: {flipped}")
    jout = jax_forward(*arrays, jcam)
    vis, cancelled = np.asarray(jout[4]), np.asarray(jout[7])
    vis_t = pc.project_plain(*(to_torch(a) for a in arrays),
                             pc.camera_consts(tcam))[4].numpy()
    cm, cc = cotangents(len(vis), np.ones_like(vis), 2)
    want = jax_adjoint(*arrays, jcam, cm, cc)
    got = pc.project_backward(*(to_torch(a) for a in arrays),
                              pc.camera_consts(tcam), to_torch(cm),
                              to_torch(cc))
    both = vis & vis_t & ~cancelled
    for name, a, b in zip(("xyz", "scaling", "rotation"), got, want):
        a, b = a.numpy(), np.asarray(b)
        # JAX's gradient of the row on the camera plane (z_cam = 0, where
        # 1 / (w + 1e-7) is 1e7) comes out NaN on the CPU; the twin's is 0
        assert np.all(a[~vis_t] == 0.0), name
        scale = np.abs(b[both]).max() + 1e-6
        np.testing.assert_allclose(a[both], b[both], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_rasterize_with_pallas_projection_matches_xla():
    """tests/test_projection_pallas.py's third test on the port: the image
    and the xyz gradient of rasterize with projection_impl="pallas" against
    "xla"."""
    cam, g, tcam = scene(800, 1)
    base = RasterizeConfig(projection_impl="xla")
    pall = dataclasses.replace(base, projection_impl="pallas")

    def run(cfg):
        gs = port_gaussians(g)
        xyz = gs.xyz.requires_grad_()
        out = rasterize(dataclasses.replace(gs, xyz=xyz), tcam, height=128,
                        width=160, use_rgb=True, config=cfg)
        v = out["comp_rgb"].mean() + out["comp_mask"].mean()
        (gr,) = torch.autograd.grad(v, [xyz])
        return v.detach().numpy(), gr.numpy()

    va, gra = run(base)
    vb, grb = run(pall)
    np.testing.assert_allclose(vb, va, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grb, gra, rtol=1e-3,
                               atol=1e-4 * (np.abs(gra).max() + 1e-9))
    with pytest.raises(ValueError):
        RasterizeConfig(projection_impl="triton")
