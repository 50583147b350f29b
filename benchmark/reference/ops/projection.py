"""Per-Gaussian projection: screen means, EWA 2D covariance, conics, radii
(a frozen copy of the program's ``ops/projection.py``; the standard 3DGS
preprocess).

- near-plane cull at z <= 0.2;
- Jacobian clamp at 1.3 * tan(fov / 2);
- +0.3 px covariance dilation;
- radius = ceil(3 * sqrt(max eigenvalue));
- pixel centres: pix = (ndc + 1) * 0.5 * size - 0.5.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.core.camera import Camera
from benchmark.reference.core.transforms import normalize_quat

NEAR_CULL_Z = 0.2
COV_DILATION = 0.3


@dataclasses.dataclass(frozen=True)
class Projected:
    mean2d: torch.Tensor   # (N, 2) pixel coordinates
    depth: torch.Tensor    # (N,) camera-space z
    conic: torch.Tensor    # (N, 3) inverse 2D covariance (A, B, C)
    radius: torch.Tensor   # (N,) 3-sigma pixel radius, 0 when culled
    visible: torch.Tensor  # (N,) bool


def project_gaussians(xyz: torch.Tensor, scaling: torch.Tensor,
                      rotation: torch.Tensor, camera: Camera, *,
                      scale_modifier: float = 1.0, znear: float = 0.01,
                      zfar: float = 1000.0) -> Projected:
    n = xyz.shape[0]
    R = camera.w2c[:3, :3]
    t = camera.w2c[:3, 3]

    p_cam = xyz @ R.T + t
    tz = p_cam[:, 2]
    in_front = tz > NEAR_CULL_Z
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    full_proj = camera.full_projection(znear, zfar)
    p_hom = torch.cat([xyz, torch.ones((n, 1), dtype=xyz.dtype,
                                       device=xyz.device)], dim=1) @ full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :2] * p_w[:, None]
    W = float(camera.width)
    H = float(camera.height)
    mean2d = torch.stack([(ndc[:, 0] + 1.0) * 0.5 * W - 0.5,
                          (ndc[:, 1] + 1.0) * 0.5 * H - 0.5], dim=1)

    # EWA 2D covariance J W Sigma W^T J^T with clamped view-space x/y, in the
    # scalar-component form of the reference.
    fx, fy = camera.fx, camera.fy
    tan_x, tan_y = camera.tan_half_fov()
    lim_x = 1.3 * tan_x
    lim_y = 1.3 * tan_y
    txtz = torch.clamp(p_cam[:, 0] / tz_safe, -lim_x, lim_x)
    tytz = torch.clamp(p_cam[:, 1] / tz_safe, -lim_y, lim_y)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    c0 = (fx * inv_z)[:, None] * R[0][None, :] \
        - (fx * tx * inv_z2)[:, None] * R[2][None, :]
    c1 = (fy * inv_z)[:, None] * R[1][None, :] \
        - (fy * ty * inv_z2)[:, None] * R[2][None, :]

    qn = normalize_quat(rotation)
    r, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    s = scaling * scale_modifier
    m00 = 1 - 2 * (y * y + z * z)
    m01 = 2 * (x * y - r * z)
    m02 = 2 * (x * z + r * y)
    m10 = 2 * (x * y + r * z)
    m11 = 1 - 2 * (x * x + z * z)
    m12 = 2 * (y * z - r * x)
    m20 = 2 * (x * z - r * y)
    m21 = 2 * (y * z + r * x)
    m22 = 1 - 2 * (x * x + y * y)

    def mt_dot(cv):
        u0 = s[:, 0] * (m00 * cv[:, 0] + m10 * cv[:, 1] + m20 * cv[:, 2])
        u1 = s[:, 1] * (m01 * cv[:, 0] + m11 * cv[:, 1] + m21 * cv[:, 2])
        u2 = s[:, 2] * (m02 * cv[:, 0] + m12 * cv[:, 1] + m22 * cv[:, 2])
        return u0, u1, u2

    u0, u1, u2 = mt_dot(c0)
    v0, v1, v2 = mt_dot(c1)
    a = u0 * u0 + u1 * u1 + u2 * u2 + COV_DILATION
    b = u0 * v0 + u1 * v1 + u2 * v2
    c = v0 * v0 + v1 * v1 + v2 * v2 + COV_DILATION

    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda_max = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda_max, min=0.0)))

    visible = in_front & det_ok & (radius > 0.0)
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    return Projected(mean2d=mean2d, depth=tz, conic=conic,
                     radius=radius.detach(), visible=visible)
