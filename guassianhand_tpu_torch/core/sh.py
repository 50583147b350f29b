"""Real spherical harmonics -> RGB, degrees 0..3 (counterpart of
``core/sh.py``; constants of the INRIA rasterizer's computeColorFromSH)."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def eval_sh(degree: int, shs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """shs (..., K, 3), dirs (..., 3) unit view directions -> (..., 3)
    colours after the +0.5 shift and the clamp at 0."""
    result = C0 * shs[..., 0, :]
    if degree > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * shs[..., 1, :] + C1 * z * shs[..., 2, :]
                  - C1 * x * shs[..., 3, :])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * shs[..., 4, :]
                      + C2[1] * yz * shs[..., 5, :]
                      + C2[2] * (2.0 * zz - xx - yy) * shs[..., 6, :]
                      + C2[3] * xz * shs[..., 7, :]
                      + C2[4] * (xx - yy) * shs[..., 8, :])
            if degree > 2:
                result = (result
                          + C3[0] * y * (3.0 * xx - yy) * shs[..., 9, :]
                          + C3[1] * xy * z * shs[..., 10, :]
                          + C3[2] * y * (4.0 * zz - xx - yy) * shs[..., 11, :]
                          + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                          * shs[..., 12, :]
                          + C3[4] * x * (4.0 * zz - xx - yy) * shs[..., 13, :]
                          + C3[5] * z * (xx - yy) * shs[..., 14, :]
                          + C3[6] * x * (xx - 3.0 * yy) * shs[..., 15, :])
    return torch.clamp(result + 0.5, min=0.0)
