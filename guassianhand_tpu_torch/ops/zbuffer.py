"""Point z-buffer and feature fetch (counterpart of ``ops/zbuffer.py``, the
reference's PyTorch3D point rasterizer): a scatter-min depth test over
pixel ids, the winner chosen as the JAX package chooses it (the largest
index among the points whose depth equals the pixel's), and the bilinear
fetch of per-point features from an image-aligned map."""
from __future__ import annotations

import torch

from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.ops.grid_sample import grid_sample_2d


def project_points(points: torch.Tensor, camera: Camera):
    """(N, 3) world -> (pixel xy (N, 2), depth (N,), in front (N,) bool)."""
    p_cam = points @ camera.w2c[:3, :3].T + camera.w2c[:3, 3]
    z = p_cam[:, 2]
    in_front = z > 1e-6
    z_safe = torch.where(in_front, z, 1.0)
    K = camera.K
    x = K[0, 0] * p_cam[:, 0] / z_safe + K[0, 2]
    y = K[1, 1] * p_cam[:, 1] / z_safe + K[1, 2]
    return torch.stack([x, y], dim=1), z, in_front


def rasterize_points(points: torch.Tensor, camera: Camera, height: int,
                     width: int):
    """The nearest point of each pixel. Returns (point index (H, W) int64,
    -1 where empty; depth (H, W), 0 where empty)."""
    xy, z, in_front = project_points(points, camera)
    # clamped first: a float beyond int range has no defined conversion
    xi = torch.round(xy[:, 0].clamp(-1.0, width)).to(torch.int64)
    yi = torch.round(xy[:, 1].clamp(-1.0, height)).to(torch.int64)
    ok = in_front & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    hw = height * width
    pix = torch.where(ok, yi * width + xi, hw)   # hw: the sentinel slot
    depth = torch.full((hw + 1,), float("inf"), device=points.device)
    depth = depth.scatter_reduce(0, pix, torch.where(ok, z, float("inf")),
                                 "amin")
    won = ok & (z <= depth[pix])
    idx = torch.full((hw + 1,), -1, dtype=torch.int64, device=points.device)
    idx = idx.scatter_reduce(0, torch.where(won, pix, hw),
                             torch.arange(points.shape[0],
                                          device=points.device), "amax")
    depth = depth[:-1]
    return (idx[:-1].reshape(height, width),
            torch.where(torch.isinf(depth), 0.0, depth).reshape(height,
                                                                width))


def fetch_image_features(points: torch.Tensor, camera: Camera,
                         feature_map: torch.Tensor) -> torch.Tensor:
    """Bilinear per-point fetch from feature_map (H, W, C) -> (N, C); 0 for
    points behind the camera."""
    h, w, _ = feature_map.shape
    xy, _, in_front = project_points(points, camera)
    uv = torch.stack([xy[:, 0] / (w - 1) * 2 - 1, xy[:, 1] / (h - 1) * 2 - 1],
                     dim=1)
    feats = grid_sample_2d(feature_map.permute(2, 0, 1), uv)
    return feats * in_front[:, None]
