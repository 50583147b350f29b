"""Camera math (a frozen copy of the program's ``core/camera.py``).

- world-to-camera ``w2c`` is a (4, 4) row-major matrix, ``p_cam = w2c @ p_h``;
- OpenCV intrinsics ``K``; the GL projection is the K-aware variant with
  znear/zfar 0.01/1000.
"""
from __future__ import annotations

import dataclasses

import torch


def intrinsic_to_fov(K: torch.Tensor, w, h):
    """tan(fov/2) per axis from the intrinsics: w / (2 fx), h / (2 fy)."""
    return w / (2.0 * K[..., 0, 0]), h / (2.0 * K[..., 1, 1])


def projection_matrix_from_K(K: torch.Tensor, h: float, w: float,
                             znear: float = 0.01,
                             zfar: float = 1000.0) -> torch.Tensor:
    """GL-style (4, 4) projection from OpenCV K."""
    fx, fy, cx, cy, s = K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[0, 1]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = [
        torch.stack([2 * fx / w, 2 * s / w, -1 + 2 * cx / w, zero]),
        torch.stack([zero, 2 * fy / h, -1 + 2 * cy / h, zero]),
        torch.stack([zero, zero, (zfar + znear) / (zfar - znear) * one,
                     -2 * zfar * znear / (zfar - znear) * one]),
        torch.stack([zero, zero, one, zero]),
    ]
    return torch.stack(rows)


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view: ``w2c`` (4, 4) and ``K`` (3, 3) float32 tensors on the
    render device, image size as Python ints."""

    w2c: torch.Tensor
    K: torch.Tensor
    height: int
    width: int

    @staticmethod
    def from_w2c(w2c, K, height: int, width: int, device=None) -> "Camera":
        w2c = torch.as_tensor(w2c, dtype=torch.float32, device=device)
        K = torch.as_tensor(K, dtype=torch.float32, device=w2c.device)
        return Camera(w2c=w2c, K=K[..., :3, :3], height=int(height),
                      width=int(width))

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    def tan_half_fov(self):
        return intrinsic_to_fov(self.K, float(self.width), float(self.height))

    def camera_center(self) -> torch.Tensor:
        """Camera position in world coordinates: -R^T t."""
        return -(self.w2c[:3, :3].T @ self.w2c[:3, 3])

    def full_projection(self, znear: float = 0.01,
                        zfar: float = 1000.0) -> torch.Tensor:
        """(4, 4) world -> clip matrix: proj @ w2c."""
        P = projection_matrix_from_K(self.K, float(self.height),
                                     float(self.width), znear, zfar)
        return P @ self.w2c
