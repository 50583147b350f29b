"""Turntable renders of a one-shot avatar (counterpart of
``cli/render_360.py``): the config's model with seeded weights, or a
fitted or edited one from a checkpoint of the port (``--ckpt``, as the
fit and edit CLIs write them), the synthetic two-hand scene in one pose,
orbit views; PNG frames, ``turntable.gif`` and ``turntable.mp4`` (a GIF
where imageio has no ffmpeg plugin).

  python -m guassianhand_tpu_torch.cli.render_360 --views 8 [--out frames/] \
      [--ckpt run/ckpts/last.ckpt] [--config configs/one_shot.yaml] \
      [key.sub=value ...]

As in the JAX package, the config decides the model and the scene: the
model is the config's (the default ``ExperimentConfig``'s without
``--config``), seeded with ``seed``, and the scene is the one the fit and
edit CLIs fit on, ``data.height`` x ``data.width`` with
``min(data.edge_subdivide, 1)`` subdivisions, posed from ``seed``.
``--height``, ``--width``, ``--subdivide`` and ``--seed`` override them.
The frames go to ``<out_dir>/<expname>/video`` unless ``--out``. Each call
to the model renders ``--views_per_call`` views of the pose in one stacked
multi-view raster. Runs on ``cuda`` unless ``--device cpu``.
``configs/one_shot.yaml`` builds a bf16 feature pipeline
(``model.compute_dtype``); the run prints the type the model computes in,
and the config snapshot it writes beside the frames records it as
``compute_dtype_effective``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from guassianhand_tpu_torch.config import (ExperimentConfig,
                                           compute_dtype_line, load_config,
                                           save_config_snapshot)
from guassianhand_tpu_torch.data.rays import orbit_cameras
from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                   synthetic_batch)
from guassianhand_tpu_torch.models.one_shot import (OneShotAvatarModel,
                                                    build_model, no_tf32)
from guassianhand_tpu_torch.train.checkpoints import load_checkpoint
from guassianhand_tpu_torch.utils.saving import (save_gif, save_video,
                                                 save_video_frames)

ORBIT_RADIUS = 0.6


def turntable_scene(cfg: ExperimentConfig, height: Optional[int] = None,
                    width: Optional[int] = None,
                    subdivide: Optional[int] = None,
                    seed: Optional[int] = None, device: str = "cuda"):
    """(scene, batch, seed) of the config's turntable, each of ``height``,
    ``width``, ``subdivide`` and ``seed`` overriding the config's where
    given."""
    seed = cfg.seed if seed is None else seed
    scene = SyntheticHandScene.build(
        n_vertices=778,
        subdivide=(min(cfg.data.edge_subdivide, 1) if subdivide is None
                   else subdivide),
        height=cfg.data.height if height is None else height,
        width=cfg.data.width if width is None else width, device=device)
    return scene, synthetic_batch(scene, seed=seed), seed


def orbit_batch(scene: SyntheticHandScene, batch: Dict[str, torch.Tensor],
                first_view: int, n_views: int,
                total_views: int) -> Dict[str, torch.Tensor]:
    """``batch`` with views first_view .. first_view + n_views - 1 of a
    ``total_views`` orbit around the posed points' centre."""
    center = batch["points"][0].mean(0).cpu().numpy().astype(np.float64)
    w2cs, Ks = orbit_cameras(center, radius=ORBIT_RADIUS, K=scene.K,
                             n_views=total_views)
    sl = slice(first_view, first_view + n_views)
    dev = batch["points"].device
    return {**batch,
            "w2c_render": torch.as_tensor(w2cs[sl], device=dev)[None],
            "K_render": torch.as_tensor(Ks[sl], device=dev)[None]}


@torch.inference_mode()
def render_request(model: OneShotAvatarModel, batch: Dict[str, torch.Tensor],
                   height: int, width: int) -> Dict[str, torch.Tensor]:
    """One request: every view in ``batch`` rendered by one model call."""
    with no_tf32():
        return model(batch, height, width)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("guassianhand-tpu-torch 360 render")
    parser.add_argument("--views", type=int, default=60)
    parser.add_argument("--views_per_call", type=int, default=4)
    parser.add_argument("--out", default=None,
                        help="the frames' directory (default "
                             "<out_dir>/<expname>/video)")
    parser.add_argument("--seed", type=int, default=None,
                        help="the pose and the weights (default: seed)")
    parser.add_argument("--height", type=int, default=None,
                        help="default: data.height")
    parser.add_argument("--width", type=int, default=None,
                        help="default: data.width")
    parser.add_argument("--subdivide", type=int, default=None,
                        help="default: min(data.edge_subdivide, 1)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--synthetic", action="store_true", default=True,
                        help="the synthetic two-hand scene (always; "
                             "accepted as the JAX CLI accepts it)")
    parser.add_argument("--config", default=None,
                        help="a YAML config whose model section builds the "
                             "model")
    parser.add_argument("--ckpt", default=None,
                        help="a checkpoint of the port whose parameters the "
                             "model takes (its config must build the same "
                             "model)")
    args, extras = parser.parse_known_args(argv)
    if args.ckpt and not os.path.exists(args.ckpt):
        parser.error(f"--ckpt {args.ckpt} does not exist")
    cfg = load_config(args.config, extras)
    out_dir = args.out or os.path.join(cfg.out_dir, cfg.expname, "video")
    print(compute_dtype_line(cfg.model))
    save_config_snapshot(cfg, out_dir)

    scene, batch, seed = turntable_scene(cfg, args.height, args.width,
                                         args.subdivide, args.seed,
                                         args.device)
    height, width = scene.height, scene.width
    model = build_model(cfg.model, seed=seed, device=args.device)
    if args.ckpt:
        load_checkpoint(args.ckpt, model)
    frames = []
    for first in range(0, args.views, args.views_per_call):
        n = min(args.views_per_call, args.views - first)
        out = render_request(model, orbit_batch(scene, batch, first, n,
                                                args.views), height, width)
        frames.extend(out["comp_rgb"][0].cpu().numpy())
    paths = save_video_frames(out_dir, frames)
    gif = save_gif(os.path.join(out_dir, "turntable.gif"), frames)
    video = save_video(os.path.join(out_dir, "turntable.mp4"), frames)
    print(json.dumps({"frames": len(paths), "out": out_dir, "gif": gif,
                      "video": video, "n_points": scene.n_points}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
