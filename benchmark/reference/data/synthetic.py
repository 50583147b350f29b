"""Synthetic two-hand scenes (a frozen copy of the program's
``data/synthetic.py``, its hands the benchmark's MANO-topology mesh of
``mano/model.py`` in place of the program's strip): posed by LBS,
edge-subdivided, with packed UV atlas coordinates and the kNN interaction
mask, and on request a "ground-truth" image rendered from a fixed Gaussian
decoration of the mesh, the target of a one-shot fit."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.core.camera import Camera
from benchmark.reference.core.gaussians import Gaussians
from benchmark.reference.mano.lbs import ManoModel, lbs
from benchmark.reference.mano.model import hand_mesh, mano_model
from benchmark.reference.mano.uv import synthetic_uv_atlas
from benchmark.reference.ops.knn import interaction_mask
from benchmark.reference.ops.rasterize import RasterizeConfig, rasterize
from benchmark.reference.ops.subdivision import (build_subdivision_plans,
                                                    subdivide_n)


@dataclasses.dataclass
class SyntheticHandScene:
    model_r: ManoModel
    model_l: ManoModel
    plans_r: tuple
    plans_l: tuple
    uv_r: np.ndarray   # (Vr_sub, 2) packed atlas
    uv_l: np.ndarray
    height: int
    width: int
    K: np.ndarray
    w2c: np.ndarray
    device: torch.device

    @staticmethod
    def build(mesh: dict, subdivide: int = 1, height: int = 128,
              width: int = 128, seed: int = 0,
              device=None) -> "SyntheticHandScene":
        """Both hands of ``hand_mesh(**mesh)``, the right one drawn from
        ``seed`` and the left from ``seed + 1``."""
        device = torch.device(device or "cuda")
        model_r = mano_model(hand_mesh(**mesh, seed=seed), device)
        model_l = mano_model(hand_mesh(**mesh, seed=seed + 1), device)
        n = model_r.v_template.shape[0]
        plans_r = build_subdivision_plans(model_r.faces, n, subdivide)
        plans_l = build_subdivision_plans(model_l.faces, n, subdivide)

        def sub_uv(uv, plans):
            for plan in plans:
                e = plan.edges
                uv = np.concatenate([uv, 0.5 * (uv[e[:, 0]] + uv[e[:, 1]])])
            return uv

        uv_r = sub_uv(synthetic_uv_atlas(model_r.v_template.cpu().numpy(),
                                         True), plans_r)
        uv_l = sub_uv(synthetic_uv_atlas(model_l.v_template.cpu().numpy(),
                                         False), plans_l)
        f = 0.9 * width
        K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                     np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 0.6
        return SyntheticHandScene(model_r, model_l, plans_r, plans_l, uv_r,
                                  uv_l, height, width, K, w2c, device)

    @property
    def n_points(self) -> int:
        return self.uv_r.shape[0] + self.uv_l.shape[0]

    def pose_points(self, pose_r: torch.Tensor, pose_l: torch.Tensor,
                    separation: float = 0.08) -> torch.Tensor:
        """Posed (N, 3) subdivided vertices, [right, left]; the left hand is
        mirrored and shifted by ``separation`` in +x (0.08 overlaps the
        hands: about every point interacts)."""
        betas = torch.zeros(10, device=self.device)
        vr, _ = lbs(self.model_r, betas, pose_r)
        vl, _ = lbs(self.model_l, betas, pose_l)
        vl = vl * torch.tensor([-1.0, 1.0, 1.0], device=self.device) \
            + torch.tensor([separation, 0.0, 0.0], device=self.device)
        return torch.cat([subdivide_n(vr, self.plans_r),
                          subdivide_n(vl, self.plans_l)], dim=0)

    def vert_uv(self) -> torch.Tensor:
        return torch.as_tensor(np.concatenate([self.uv_r, self.uv_l]),
                               dtype=torch.float32, device=self.device)

    def decoration_gaussians(self, points: torch.Tensor,
                             seed: int = 0) -> Gaussians:
        """Fixed "ground-truth" Gaussians on the mesh, about 2 px across at
        the scene's focal length, with seeded colours."""
        n = points.shape[0]
        dev = points.device
        rng = np.random.RandomState(seed)
        colors = torch.as_tensor(rng.uniform(0.2, 1.0, (n, 1, 3)),
                                 dtype=torch.float32, device=dev)
        sigma = 2.0 * 0.6 / (0.9 * self.width)
        return Gaussians(
            xyz=points, opacity=torch.full((n, 1), 0.9, device=dev),
            rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]],
                                  device=dev).expand(n, 4).contiguous(),
            scaling=torch.full((n, 3), sigma, device=dev), shs=colors)

    @torch.no_grad()
    def render_target(self, points: torch.Tensor,
                      raster: Optional[RasterizeConfig] = None,
                      seed: int = 0):
        """(rgb (H, W, 3), mask (H, W)) of the decoration Gaussians from the
        scene's camera."""
        cam = Camera.from_w2c(self.w2c, self.K, self.height, self.width,
                              device=self.device)
        out = rasterize(self.decoration_gaussians(points, seed), cam,
                        height=self.height, width=self.width, use_rgb=True,
                        config=raster or RasterizeConfig())
        return out["comp_rgb"], out["comp_mask"]


def synthetic_batch(scene: SyntheticHandScene, seed: int = 0,
                    pose_scale: float = 0.3,
                    raster: Optional[RasterizeConfig] = None,
                    with_target: bool = False,
                    separation: float = 0.08) -> Dict[str, torch.Tensor]:
    """A model-ready batch (B=1) for the pose drawn from ``seed``; with
    ``with_target`` also target_rgb (1, H, W, 3) and target_mask (1, H, W)
    from ``render_target``. The default leaves the target out, which the
    render path does not need (the JAX function renders it unless told
    not to)."""
    dev = scene.device
    rng = np.random.RandomState(seed)
    pose_r = torch.as_tensor(rng.uniform(-pose_scale, pose_scale, 48),
                             dtype=torch.float32, device=dev)
    pose_l = torch.as_tensor(rng.uniform(-pose_scale, pose_scale, 48),
                             dtype=torch.float32, device=dev)
    tpose = torch.zeros(48, device=dev)
    points = scene.pose_points(pose_r, pose_l, separation=separation)
    points_t = scene.pose_points(tpose, tpose, separation=separation)
    inter = interaction_mask(points, points_t,
                             k=min(100, points.shape[0] // 4))

    K = torch.as_tensor(scene.K, device=dev)
    w2c = torch.as_tensor(scene.w2c, device=dev)
    K_normed = K.clone()
    K_normed[0] /= scene.width
    K_normed[1] /= scene.height
    batch = {
        "points": points[None],
        "points_tar": points[None],
        "vert_uv": scene.vert_uv()[None],
        "inter_mask": inter[None],
        "mano_pose": torch.cat([pose_r, pose_l])[None],
        "c2w": torch.linalg.inv(w2c)[None],
        "intrinsic_normed": K_normed[None],
        "w2c_render": w2c[None, None],
        "K_render": K[None, None],
        "background": torch.zeros((1, 3), device=dev),
    }
    if with_target:
        rgb, mask = scene.render_target(points, raster)
        batch["target_rgb"] = rgb[None]
        batch["target_mask"] = mask[None]
    return batch
