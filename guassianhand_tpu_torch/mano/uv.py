"""Packed two-hand UV atlas helpers (counterpart of the parts of
``mano/uv.py`` the render path uses). Right-hand UVs occupy
[0, .5] x [0, .5], left-hand UVs [.5, 1] x [0, .5]."""
from __future__ import annotations

import numpy as np
import torch


def synthetic_uv_atlas(vertices: np.ndarray, right: bool = True) -> np.ndarray:
    """Per-vertex UV when no MANO atlas is at hand: a planar xz projection
    into the hand's half of the packed atlas."""
    v = np.asarray(vertices)
    mn = v.min(0)
    ext = np.maximum(v.max(0) - mn, 1e-6)
    u = (v[:, 0] - mn[0]) / ext[0] * 0.5
    w = (v[:, 1] - mn[1]) / ext[1] * 0.5
    if not right:
        u = u + 0.5
    return np.stack([u, w], axis=1).astype(np.float32)


def normalize_uv(uv: torch.Tensor) -> torch.Tensor:
    """Packed-atlas uv -> [-1, 1]^2: u by 1, v by 0.5."""
    return torch.stack([2.0 * uv[..., 0] - 1.0,
                        2.0 * (uv[..., 1] / 0.5) - 1.0], dim=-1)
