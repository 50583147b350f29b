"""Fused EWA projection: the CUDA kernels and their plain-PyTorch twins
(counterpart of ``ops/projection_pallas.py``).

``project_gaussians_pallas`` replaces
``guassianhand_tpu/ops/projection_pallas.py::project_gaussians_pallas``: the
whole preprocess (world to camera, pinhole projection, the clamped EWA
Jacobian, quaternion to rotation, conic and radius) as one kernel a
direction, with the hand-derived adjoint as the backward of the
``ProjectGaussians`` autograd Function. ``RasterizeConfig.projection_impl =
"pallas"`` routes ``ops/rasterize.py`` here; the default ``"xla"`` keeps
``ops/projection.py``. The kernel source is ``csrc/projection.cu``, whose
header note gives its design and what bounds it.

Every function takes one camera or a stack of V: ``consts`` is (30,) or
(V, 30) (``camera_consts``), and the forward's outputs and the adjoint's
cotangents then carry a leading view axis, as ``jax.vmap`` of the JAX
function gives them. The kernels do all V views in one launch; the adjoint
sums the views' gradients in view order.

The twins (``project_plain``, ``project_adjoint_plain``) are the scalar form
of the JAX kernels' math, op for op: ``c * inv_det`` and not ``c / det``,
``rsqrt`` normalisation of the quaternion, every sum in the JAX
expression's order; a stack of cameras broadcasts each constant over the
views, and the adjoint adds the views one after the other, as the kernel
does. ``ops/projection.py`` computes the same function in another order and
so rounds differently. The kernels round every operation as these twins
do, so on the card radius and ``visible`` come out equal.

The wrappers ``project_forward`` and ``project_backward`` send CUDA tensors
to the kernels and CPU tensors to the twins; nothing falls back from one to
the other. ``<wrapper>.launches`` counts kernel launches. Depth gets no
gradient (the composite only sorts by it), and radius and ``visible`` are
not differentiable, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.ops.cuda_build import (I, P, CudaLibrary,
                                                   check_launch)
from guassianhand_tpu_torch.ops.projection import (COV_DILATION, NEAR_CULL_Z,
                                                   Projected)

LIB = CudaLibrary("projection.cu", {
    "gh_project_forward": [P, P, P, P, I, I, P, P, P, P, P, P],
    "gh_project_backward": [P, P, P, P, P, P, I, I, P, P, P, P]})
N_CONSTS = 30
# the adjoint keeps every view's constants in 48 KB of shared memory
MAX_VIEWS = 48 * 1024 // (4 * N_CONSTS)


def camera_consts(camera: Camera, znear: float = 0.01,
                  zfar: float = 1000.0) -> torch.Tensor:
    """Every per-camera scalar of the kernels in one (30,) float32 tensor
    on the camera's device: R (9), t (3), rows 0, 1 and 3 of the full
    projection (12), fx, fy, 1.3 tan(fov_x / 2), 1.3 tan(fov_y / 2), W, H.
    The kernels and the twins read the same tensor, so they see the same
    bits of the 4x4 product."""
    R = camera.w2c[:3, :3]
    t = camera.w2c[:3, 3]
    fp = camera.full_projection(znear, zfar)
    tan_x, tan_y = camera.tan_half_fov()
    dev = camera.w2c.device
    wh = torch.tensor([float(camera.width), float(camera.height)],
                      dtype=torch.float32, device=dev)
    return torch.cat([
        R.reshape(9), t.reshape(3), fp[0, :4], fp[1, :4], fp[3, :4],
        torch.stack([camera.fx, camera.fy, 1.3 * tan_x, 1.3 * tan_y]), wh,
    ]).to(torch.float32).contiguous()


def _per_constant(consts: torch.Tensor) -> torch.Tensor:
    """``consts`` indexed by constant: (30,) as it is, (V, 30) as (30, V, 1),
    so that each constant broadcasts over the views against (N,) rows."""
    return consts if consts.dim() == 1 else consts.T[:, :, None]


def _fwd_math(cs, x, y, z, sx, sy, sz, qr, qx, qy, qz):
    """``projection_pallas._fwd_math`` in PyTorch, op for op, on (N,)
    vectors; ``cs`` is ``_per_constant`` of the ``camera_consts`` tensor,
    and every value is (N,) for one camera or (V, N) for a stack."""
    R00, R01, R02 = cs[0], cs[1], cs[2]
    R10, R11, R12 = cs[3], cs[4], cs[5]
    R20, R21, R22 = cs[6], cs[7], cs[8]
    t0, t1, t2 = cs[9], cs[10], cs[11]
    F00, F01, F02, F03 = cs[12], cs[13], cs[14], cs[15]
    F10, F11, F12, F13 = cs[16], cs[17], cs[18], cs[19]
    F30, F31, F32, F33 = cs[20], cs[21], cs[22], cs[23]
    fx, fy, limx, limy, W, H = (cs[24], cs[25], cs[26], cs[27], cs[28],
                                cs[29])

    pcx = R00 * x + R01 * y + R02 * z + t0
    pcy = R10 * x + R11 * y + R12 * z + t1
    tz = R20 * x + R21 * y + R22 * z + t2
    in_front = tz > NEAR_CULL_Z
    tzs = torch.where(in_front, tz, 1.0)

    hx = F00 * x + F01 * y + F02 * z + F03
    hy = F10 * x + F11 * y + F12 * z + F13
    hw = F30 * x + F31 * y + F32 * z + F33
    pw = torch.reciprocal(hw + 1e-7)
    m2x = (hx * pw + 1.0) * 0.5 * W - 0.5
    m2y = (hy * pw + 1.0) * 0.5 * H - 0.5

    rx = pcx / tzs
    ry = pcy / tzs
    txtz = torch.minimum(torch.maximum(rx, -limx), limx)
    tytz = torch.minimum(torch.maximum(ry, -limy), limy)
    tx = txtz * tzs
    ty = tytz * tzs

    inv_z = torch.reciprocal(tzs)
    inv_z2 = inv_z * inv_z
    k0 = fx * inv_z
    k2x = fx * tx * inv_z2
    k1 = fy * inv_z
    k2y = fy * ty * inv_z2
    c00 = k0 * R00 - k2x * R20
    c01 = k0 * R01 - k2x * R21
    c02 = k0 * R02 - k2x * R22
    c10 = k1 * R10 - k2y * R20
    c11 = k1 * R11 - k2y * R21
    c12 = k1 * R12 - k2y * R22

    qnorm = torch.rsqrt(qr * qr + qx * qx + qy * qy + qz * qz)
    r, xq, yq, zq = qr * qnorm, qx * qnorm, qy * qnorm, qz * qnorm
    m00 = 1 - 2 * (yq * yq + zq * zq)
    m01 = 2 * (xq * yq - r * zq)
    m02 = 2 * (xq * zq + r * yq)
    m10 = 2 * (xq * yq + r * zq)
    m11 = 1 - 2 * (xq * xq + zq * zq)
    m12 = 2 * (yq * zq - r * xq)
    m20 = 2 * (xq * zq - r * yq)
    m21 = 2 * (yq * zq + r * xq)
    m22 = 1 - 2 * (xq * xq + yq * yq)

    w00 = m00 * c00 + m10 * c01 + m20 * c02
    w01 = m01 * c00 + m11 * c01 + m21 * c02
    w02 = m02 * c00 + m12 * c01 + m22 * c02
    w10 = m00 * c10 + m10 * c11 + m20 * c12
    w11 = m01 * c10 + m11 * c11 + m21 * c12
    w12 = m02 * c10 + m12 * c11 + m22 * c12
    u0, u1, u2 = sx * w00, sy * w01, sz * w02
    v0, v1, v2 = sx * w10, sy * w11, sz * w12

    a = u0 * u0 + u1 * u1 + u2 * u2 + COV_DILATION
    b = u0 * v0 + u1 * v1 + u2 * v2
    c = v0 * v0 + v1 * v1 + v2 * v2 + COV_DILATION

    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    inv_det = torch.reciprocal(det_safe)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(mid + disc, min=0.0)))
    visible = in_front & det_ok & (radius > 0.0)
    radius = torch.where(visible, radius, 0.0)

    return dict(tz=tz, in_front=in_front, hx=hx, hy=hy, pw=pw, m2x=m2x,
                m2y=m2y, rx=rx, ry=ry, tx=tx, ty=ty, inv_z=inv_z,
                inv_z2=inv_z2, c0=(c00, c01, c02), c1=(c10, c11, c12),
                qn=(r, xq, yq, zq), qnorm=qnorm,
                m=(m00, m01, m02, m10, m11, m12, m20, m21, m22),
                w0=(w00, w01, w02), w1=(w10, w11, w12),
                u=(u0, u1, u2), v=(v0, v1, v2), a=a, b=b, c=c, det=det,
                inv_det=inv_det, radius=radius,
                visible=visible)


def _columns(xyz, scaling, rotation):
    return (xyz[:, 0], xyz[:, 1], xyz[:, 2], scaling[:, 0], scaling[:, 1],
            scaling[:, 2], rotation[:, 0], rotation[:, 1], rotation[:, 2],
            rotation[:, 3])


def project_plain(xyz, scaling, rotation, consts):
    """The forward kernel's function in plain PyTorch: (mean2d (N, 2),
    depth (N,), conic (N, 3), radius (N,), visible (N,) bool) for consts
    (30,), each with a leading view axis V for consts (V, 30)."""
    f = _fwd_math(_per_constant(consts), *_columns(xyz, scaling, rotation))
    inv_det = f["inv_det"]
    return (torch.stack([f["m2x"], f["m2y"]], dim=-1), f["tz"],
            torch.stack([f["c"] * inv_det, -f["b"] * inv_det,
                         f["a"] * inv_det], dim=-1),
            f["radius"], f["visible"])


def project_adjoint_plain(xyz, scaling, rotation, consts, g_mean2d,
                          g_conic):
    """``projection_pallas._proj_bwd_kernel`` in PyTorch, op for op: the
    gradients of xyz (N, 3), scaling (N, 3) and rotation (N, 4) from those
    of mean2d (N, 2) and conic (N, 3). Rows that are not visible get 0.
    With consts (V, 30) the cotangents are (V, N, 2) and (V, N, 3), and
    the views' gradients are added in view order."""
    cs = _per_constant(consts)
    x, y, z, sx, sy, sz, qr, qx, qy, qz = _columns(xyz, scaling, rotation)
    f = _fwd_math(cs, x, y, z, sx, sy, sz, qr, qx, qy, qz)
    R00, R01, R02 = cs[0], cs[1], cs[2]
    R10, R11, R12 = cs[3], cs[4], cs[5]
    R20, R21, R22 = cs[6], cs[7], cs[8]
    F00, F01, F02 = cs[12], cs[13], cs[14]
    F10, F11, F12 = cs[16], cs[17], cs[18]
    F30, F31, F32 = cs[20], cs[21], cs[22]
    fx, fy, limx, limy, W, H = (cs[24], cs[25], cs[26], cs[27], cs[28],
                                cs[29])

    live = f["visible"].to(torch.float32)
    ga = g_conic[..., 0] * live
    gb = g_conic[..., 1] * live
    gc = g_conic[..., 2] * live
    gmx = g_mean2d[..., 0] * live
    gmy = g_mean2d[..., 1] * live

    # conic = (c, -b, a) / det
    inv_det = f["inv_det"]
    a, b, c = f["a"], f["b"], f["c"]
    g_c = ga * inv_det
    g_b = -gb * inv_det
    g_a = gc * inv_det
    g_det = -(ga * c - gb * b + gc * a) * inv_det * inv_det
    g_a = g_a + g_det * c
    g_c = g_c + g_det * a
    g_b = g_b - 2.0 * g_det * b

    # a = sum u^2 + d; b = sum u v; c = sum v^2 + d
    u0, u1, u2 = f["u"]
    v0, v1, v2 = f["v"]
    gu0 = 2.0 * g_a * u0 + g_b * v0
    gu1 = 2.0 * g_a * u1 + g_b * v1
    gu2 = 2.0 * g_a * u2 + g_b * v2
    gv0 = 2.0 * g_c * v0 + g_b * u0
    gv1 = 2.0 * g_c * v1 + g_b * u1
    gv2 = 2.0 * g_c * v2 + g_b * u2

    # u_j = s_j w0_j; v_j = s_j w1_j
    w00, w01, w02 = f["w0"]
    w10, w11, w12 = f["w1"]
    gsx = gu0 * w00 + gv0 * w10
    gsy = gu1 * w01 + gv1 * w11
    gsz = gu2 * w02 + gv2 * w12
    gw00, gw01, gw02 = gu0 * sx, gu1 * sy, gu2 * sz
    gw10, gw11, gw12 = gv0 * sx, gv1 * sy, gv2 * sz

    # w0_j = sum_i m_ij c0_i; w1_j = sum_i m_ij c1_i
    c00, c01, c02 = f["c0"]
    c10, c11, c12 = f["c1"]
    gm00 = gw00 * c00 + gw10 * c10
    gm01 = gw01 * c00 + gw11 * c10
    gm02 = gw02 * c00 + gw12 * c10
    gm10 = gw00 * c01 + gw10 * c11
    gm11 = gw01 * c01 + gw11 * c11
    gm12 = gw02 * c01 + gw12 * c11
    gm20 = gw00 * c02 + gw10 * c12
    gm21 = gw01 * c02 + gw11 * c12
    gm22 = gw02 * c02 + gw12 * c12
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = f["m"]
    gc00 = gw00 * m00 + gw01 * m01 + gw02 * m02
    gc01 = gw00 * m10 + gw01 * m11 + gw02 * m12
    gc02 = gw00 * m20 + gw01 * m21 + gw02 * m22
    gc10 = gw10 * m00 + gw11 * m01 + gw12 * m02
    gc11 = gw10 * m10 + gw11 * m11 + gw12 * m12
    gc12 = gw10 * m20 + gw11 * m21 + gw12 * m22

    # the quaternion chain: m <- normalised (r, xq, yq, zq) <- raw q
    r, xq, yq, zq = f["qn"]
    g_r = 2.0 * (-gm01 * zq + gm02 * yq + gm10 * zq - gm12 * xq
                 - gm20 * yq + gm21 * xq)
    g_x = 2.0 * (gm01 * yq + gm02 * zq + gm10 * yq - gm12 * r
                 + gm20 * zq + gm21 * r) - 4.0 * xq * (gm11 + gm22)
    g_y = 2.0 * (gm01 * xq + gm02 * r + gm10 * xq + gm12 * zq
                 - gm20 * r + gm21 * zq) - 4.0 * yq * (gm00 + gm22)
    g_z = 2.0 * (-gm01 * r + gm02 * xq + gm10 * r + gm12 * yq
                 + gm20 * xq + gm21 * yq) - 4.0 * zq * (gm00 + gm11)
    # qn = q rsqrt(|q|^2): g_q = (g_qn - qn <qn, g_qn>) qnorm
    dot = r * g_r + xq * g_x + yq * g_y + zq * g_z
    qnorm = f["qnorm"]
    gqr = (g_r - r * dot) * qnorm
    gqx = (g_x - xq * dot) * qnorm
    gqy = (g_y - yq * dot) * qnorm
    gqz = (g_z - zq * dot) * qnorm

    # c0_i = fx inv_z R0_i - fx tx inv_z2 R2_i (c1 with fy, ty, R1)
    inv_z, inv_z2 = f["inv_z"], f["inv_z2"]
    tx, ty = f["tx"], f["ty"]
    s0 = gc00 * R00 + gc01 * R01 + gc02 * R02
    s2x = gc00 * R20 + gc01 * R21 + gc02 * R22
    s1 = gc10 * R10 + gc11 * R11 + gc12 * R12
    s2y = gc10 * R20 + gc11 * R21 + gc12 * R22
    g_invz = fx * s0 + fy * s1
    g_tx = -fx * inv_z2 * s2x
    g_ty = -fy * inv_z2 * s2y
    g_invz2 = -fx * tx * s2x - fy * ty * s2y
    g_invz = g_invz + 2.0 * inv_z * g_invz2
    g_tzs = -inv_z2 * g_invz

    # tx = clip(pcx / tzs, +-limx) tzs: the identity inside the clamp,
    # sign limx tzs outside it
    clx = torch.abs(f["rx"]) > limx
    cly = torch.abs(f["ry"]) > limy
    g_pcx = torch.where(clx, 0.0, g_tx)
    g_pcy = torch.where(cly, 0.0, g_ty)
    g_tzs = (g_tzs + torch.where(clx, torch.sign(f["rx"]) * limx * g_tx, 0.0)
             + torch.where(cly, torch.sign(f["ry"]) * limy * g_ty, 0.0))

    # the mean2d chain
    pw = f["pw"]
    g_ndcx = gmx * 0.5 * W
    g_ndcy = gmy * 0.5 * H
    g_hx = g_ndcx * pw
    g_hy = g_ndcy * pw
    g_pw = g_ndcx * f["hx"] + g_ndcy * f["hy"]
    g_hw = -pw * pw * g_pw

    # tzs = where(in_front, tz, 1): culled rows are not visible (live 0)
    g_tz = torch.where(f["in_front"], g_tzs, 0.0)

    gx = (R00 * g_pcx + R10 * g_pcy + R20 * g_tz
          + F00 * g_hx + F10 * g_hy + F30 * g_hw)
    gy = (R01 * g_pcx + R11 * g_pcy + R21 * g_tz
          + F01 * g_hx + F11 * g_hy + F31 * g_hw)
    gz = (R02 * g_pcx + R12 * g_pcy + R22 * g_tz
          + F02 * g_hx + F12 * g_hy + F32 * g_hw)
    grads = (torch.stack([gx, gy, gz], dim=-1),
             torch.stack([gsx, gsy, gsz], dim=-1),
             torch.stack([gqr, gqx, gqy, gqz], dim=-1))
    if consts.dim() == 1:
        return grads
    return tuple(_sum_views(g) for g in grads)


def _sum_views(g: torch.Tensor) -> torch.Tensor:
    """(V, N, C) -> (N, C), the views added one after the other, as the
    adjoint kernel adds them."""
    total = g[0]
    for v in range(1, g.shape[0]):
        total = total + g[v]
    return total


def _check(consts, rows, cotangents=None):
    """The number of views (None for a single camera's (30,) consts) and of
    rows; raises on what the kernels do not take. ``rows`` and
    ``cotangents`` map a name to (tensor, columns): rows are (N, columns),
    cotangents carry the view axis of ``consts`` before it."""
    dev = consts.device
    if consts.dtype != torch.float32 or not consts.is_contiguous() \
            or consts.dim() not in (1, 2) or consts.shape[-1] != N_CONSTS:
        raise ValueError(f"consts must be a contiguous ({N_CONSTS},) or "
                         f"(V, {N_CONSTS}) float32 tensor, got "
                         f"{tuple(consts.shape)} {consts.dtype}")
    views = consts.shape[0] if consts.dim() == 2 else None
    if views is not None and not 1 <= views <= MAX_VIEWS:
        raise ValueError(f"{views} views: the kernels take 1 to {MAX_VIEWS}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    lead = () if views is None else (views,)
    n = None
    for name, (t, cols), shape in (
            [(k, v, ("N", v[1])) for k, v in rows.items()]
            + [(k, v, lead + ("N", v[1]))
               for k, v in (cotangents or {}).items()]):
        if t.dim() != len(shape) or t.shape[-1] != cols \
                or tuple(t.shape[:-2]) != shape[:-2] \
                or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, consts on {dev}")
        if n is not None and t.shape[-2] != n:
            raise ValueError(f"{name} has {t.shape[-2]} rows, not {n}")
        n = t.shape[-2]
    return views, n


def project_forward(xyz, scaling, rotation, consts):
    """(mean2d (N, 2), depth (N,), conic (N, 3), radius (N,), visible (N,)
    bool) of xyz (N, 3), scaling (N, 3) and rotation (N, 4) float32, under
    ``camera_consts`` (30,); under a stack (V, 30) each output has a leading
    view axis, all views from one launch."""
    views, n = _check(consts, {"xyz": (xyz, 3), "scaling": (scaling, 3),
                               "rotation": (rotation, 4)})
    if consts.device.type == "cpu":
        return project_plain(xyz, scaling, rotation, consts)
    dev = consts.device
    lead = () if views is None else (views,)
    xyz, scaling, rotation = (t.contiguous() for t in (xyz, scaling, rotation))
    mean2d = torch.empty(lead + (n, 2), dtype=torch.float32, device=dev)
    depth = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    conic = torch.empty(lead + (n, 3), dtype=torch.float32, device=dev)
    radius = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    visible = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_project_forward(
            xyz.data_ptr(), scaling.data_ptr(), rotation.data_ptr(),
            consts.data_ptr(), n, views or 1, mean2d.data_ptr(),
            depth.data_ptr(), conic.data_ptr(), radius.data_ptr(),
            visible.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "project_fwd_kernel")
    project_forward.launches += 1
    return mean2d, depth, conic, radius, visible


project_forward.launches = 0


def project_backward(xyz, scaling, rotation, consts, g_mean2d, g_conic):
    """The adjoint: (g_xyz (N, 3), g_scaling (N, 3), g_rotation (N, 4))
    from g_mean2d (N, 2) and g_conic (N, 3), or from (V, N, 2) and
    (V, N, 3) under consts (V, 30), summed over the views in view order; a
    view where a row is not visible adds 0."""
    views, n = _check(consts, {"xyz": (xyz, 3), "scaling": (scaling, 3),
                               "rotation": (rotation, 4)},
                      {"g_mean2d": (g_mean2d, 2), "g_conic": (g_conic, 3)})
    if consts.device.type == "cpu":
        return project_adjoint_plain(xyz, scaling, rotation, consts,
                                     g_mean2d, g_conic)
    dev = consts.device
    ins = [t.contiguous() for t in (xyz, scaling, rotation, consts, g_mean2d,
                                    g_conic)]
    g_xyz = torch.empty((n, 3), dtype=torch.float32, device=dev)
    g_scaling = torch.empty((n, 3), dtype=torch.float32, device=dev)
    g_rotation = torch.empty((n, 4), dtype=torch.float32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.gh_project_backward(
            *(t.data_ptr() for t in ins), n, views or 1, g_xyz.data_ptr(),
            g_scaling.data_ptr(), g_rotation.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "project_bwd_kernel")
    project_backward.launches += 1
    return g_xyz, g_scaling, g_rotation


project_backward.launches = 0


class ProjectGaussians(torch.autograd.Function):
    """(mean2d, depth, conic, radius, visible) of (xyz, scaling, rotation)
    under ``consts`` (30,) or (V, 30); the backward is the hand-derived
    adjoint, which zeroes the rows that are not visible and sums the views.
    Depth gets no gradient; radius and ``visible`` are not
    differentiable."""

    @staticmethod
    def forward(ctx, xyz, scaling, rotation, consts):
        out = project_forward(xyz, scaling, rotation, consts)
        ctx.save_for_backward(xyz, scaling, rotation, consts)
        ctx.mark_non_differentiable(out[3], out[4])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_mean2d, _g_depth, g_conic, _g_radius, _g_visible):
        xyz, scaling, rotation, consts = ctx.saved_tensors
        # an output with no gradient arrives as zeros (materialize_grads)
        g_xyz, g_scaling, g_rotation = project_backward(
            xyz, scaling, rotation, consts, g_mean2d.contiguous(),
            g_conic.contiguous())
        return g_xyz, g_scaling, g_rotation, None


def project_gaussians_pallas(xyz: torch.Tensor, scaling: torch.Tensor,
                             rotation: torch.Tensor,
                             camera: Union[Camera, Sequence[Camera]], *,
                             scale_modifier: float = 1.0, znear: float = 0.01,
                             zfar: float = 1000.0) -> Projected:
    """The fused-kernel projection, ``ops/projection.project_gaussians``'
    signature and result for one camera; for a sequence of V cameras every
    field has a leading view axis, from one launch each way."""
    if isinstance(camera, Camera):
        consts = camera_consts(camera, znear, zfar)
    else:
        consts = torch.stack([camera_consts(c, znear, zfar) for c in camera])
    s = scaling * scale_modifier if scale_modifier != 1.0 else scaling
    mean2d, depth, conic, radius, visible = ProjectGaussians.apply(
        xyz, s, rotation, consts)
    return Projected(mean2d=mean2d, depth=depth, conic=conic, radius=radius,
                     visible=visible)
