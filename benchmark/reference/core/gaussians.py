"""Gaussian primitive container (a frozen copy of the program's
``core/gaussians.py``).

A static-capacity buffer plus an optional ``valid`` mask: padding slots keep
their place and get opacity 0 through ``effective_opacity``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Gaussians:
    """xyz (N, 3); opacity (N, 1) in [0, 1]; rotation (N, 4) wxyz;
    scaling (N, 3) > 0; shs (N, K, 3) SH coefficients or (N, 1, 3) RGB;
    valid optional (N,) mask."""

    xyz: torch.Tensor
    opacity: torch.Tensor
    rotation: torch.Tensor
    scaling: torch.Tensor
    shs: torch.Tensor
    valid: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.xyz.shape[0]

    def effective_opacity(self) -> torch.Tensor:
        """Opacity with padding slots zeroed."""
        if self.valid is None:
            return self.opacity
        return self.opacity * self.valid.to(self.opacity.dtype)[..., None]
