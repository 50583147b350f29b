"""Quaternion and rotation utilities (a frozen copy of the program's
``core/transforms.py``)."""
from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def rodrigues(rvec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True)
    axis = rvec / torch.clamp(theta, min=eps)
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                    dim=-1).reshape(*rvec.shape[:-1], 3, 3)
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
