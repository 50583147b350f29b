"""The turntable orbit of cameras (the program's ``data/rays.py``, cut to
``orbit_cameras``; numpy, host-side)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def orbit_cameras(center: np.ndarray, radius: float, K: np.ndarray,
                  n_views: int = 60, elevation_deg: float = 0.0,
                  up=(0.0, -1.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """360-degree turntable around ``center``: (w2cs (N, 4, 4), Ks (N, 3, 3))."""
    up = np.asarray(up, np.float64)
    el = np.radians(elevation_deg)
    w2cs = []
    for k in range(n_views):
        az = 2 * np.pi * k / n_views
        cam_pos = center + radius * np.array(
            [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
        fwd = center - cam_pos
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=0)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ cam_pos
        w2cs.append(w2c)
    Ks = np.broadcast_to(K, (n_views, 3, 3)).copy()
    return np.asarray(w2cs, np.float32), Ks.astype(np.float32)
