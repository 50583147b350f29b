"""Rays, their box bounds and camera paths (counterpart of
``data/rays.py``; numpy, host-side): pinhole rays in world space, the ray
and axis-aligned box intersection, the mask of pixels whose ray crosses a
box (the evaluation's ``mask_at_box``), a point cloud's padded box, and the
turntable orbit."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def get_rays(h: int, w: int, K: np.ndarray, R: np.ndarray, t: np.ndarray):
    """Pinhole rays in world space: (ray_o (H, W, 3), ray_d (H, W, 3))."""
    rays_o = -np.dot(R.T, t).ravel()
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = np.dot(pixel_camera - t.ravel(), R)
    rays_d = pixel_world - rays_o[None, None]
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o, rays_d


def get_near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray,
                 boffset=(-0.01, 0.01)):
    """Rays (N, 3) against the box ``bounds`` (2, 3) grown by ``boffset``:
    (near, far) of the rays that cross two of its faces, and the mask of
    those rays (N,)."""
    bounds = bounds + np.array([boffset[0], boffset[1]])[:, None]
    ray_d = ray_d.copy()
    ray_d[np.abs(ray_d) < 1e-5] = 1e-5
    nominator = bounds[None] - ray_o[:, None]
    d_intersect = (nominator / ray_d[:, None]).reshape(-1, 6)
    p_intersect = d_intersect[..., None] * ray_d[:, None] + ray_o[:, None]
    min_x, min_y, min_z, max_x, max_y, max_z = bounds.ravel()
    eps = 1e-6
    ok = ((p_intersect[..., 0] >= min_x - eps)
          & (p_intersect[..., 0] <= max_x + eps)
          & (p_intersect[..., 1] >= min_y - eps)
          & (p_intersect[..., 1] <= max_y + eps)
          & (p_intersect[..., 2] >= min_z - eps)
          & (p_intersect[..., 2] <= max_z + eps))
    mask_at_box = ok.sum(-1) == 2
    p_intervals = p_intersect[mask_at_box][ok[mask_at_box]].reshape(-1, 2, 3)
    ro = ray_o[mask_at_box]
    rd = ray_d[mask_at_box]
    norm = np.linalg.norm(rd, axis=1)
    d0 = np.linalg.norm(p_intervals[:, 0] - ro, axis=1) / norm
    d1 = np.linalg.norm(p_intervals[:, 1] - ro, axis=1) / norm
    return np.minimum(d0, d1), np.maximum(d0, d1), mask_at_box


def get_mask_at_box(bounds, K, R, t, h, w):
    """(mask (H, W) of the pixels whose ray crosses the box, the nearest
    near, the farthest far); (mask, 0, 1) when no ray does."""
    ray_o, ray_d = get_rays(h, w, K, R, t)
    near, far, mask = get_near_far(
        bounds, ray_o.reshape(-1, 3).astype(np.float32),
        ray_d.reshape(-1, 3).astype(np.float32))
    if near.size == 0:
        return mask.reshape(h, w), 0.0, 1.0
    return mask.reshape(h, w), float(near.min()), float(far.max())


def bounds_from_points(points: np.ndarray, pad: float = 0.05) -> np.ndarray:
    """The points' axis-aligned box grown by ``pad``: (2, 3) min, max."""
    return np.stack([points.min(0) - pad, points.max(0) + pad], axis=0)


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
