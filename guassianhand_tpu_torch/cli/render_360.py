"""Turntable renders of a one-shot avatar (counterpart of
``cli/render_360.py``): a full-width model with seeded weights, or a
fitted or edited one from a checkpoint of the port (``--ckpt``, as the
fit and edit CLIs write them), the synthetic two-hand scene in one pose,
orbit views, PNG frames.

  python -m guassianhand_tpu_torch.cli.render_360 --views 8 --out frames/ \
      [--ckpt run/ckpts/last.ckpt] [--config configs/one_shot.yaml] \
      [key.sub=value ...]

Each call to the model renders ``--views_per_call`` views of the pose in one
stacked multi-view raster. Runs on ``cuda`` unless ``--device cpu``. The
model is ``MODEL_CONFIG`` unless a config file or ``model.*`` overrides are
given; ``configs/one_shot.yaml`` builds a bf16 feature pipeline
(``model.compute_dtype``). The run prints the type the model computes in,
and the config snapshot it writes beside the frames records it as
``compute_dtype_effective``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from guassianhand_tpu_torch.config import (ExperimentConfig,
                                           compute_dtype_line, load_config,
                                           save_config_snapshot)
from guassianhand_tpu_torch.data.rays import orbit_cameras
from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                   synthetic_batch)
from guassianhand_tpu_torch.models.one_shot import (OneShotAvatarModel,
                                                    OneShotConfig, build_model,
                                                    no_tf32)
from guassianhand_tpu_torch.train.checkpoints import load_checkpoint
from guassianhand_tpu_torch.utils.saving import save_video_frames

ORBIT_RADIUS = 0.6
# configs/one_shot.yaml's model at its published widths, in fp32 (the yaml
# itself asks for the bf16 feature pipeline)
MODEL_CONFIG = OneShotConfig(narrow_color_b=True)


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
    parser.add_argument("--out", default="EXPERIMENTS/render_360_torch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--subdivide", type=int, default=2)
    parser.add_argument("--device", default="cuda")
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
    cfg = (load_config(args.config, extras) if args.config or extras
           else ExperimentConfig(model=MODEL_CONFIG))
    print(compute_dtype_line(cfg.model))
    save_config_snapshot(cfg, args.out)

    scene = SyntheticHandScene.build(n_vertices=778, subdivide=args.subdivide,
                                     height=args.height, width=args.width,
                                     device=args.device)
    batch = synthetic_batch(scene, seed=args.seed)
    model = build_model(cfg.model, seed=args.seed, device=args.device)
    if args.ckpt:
        load_checkpoint(args.ckpt, model)
    frames = []
    for first in range(0, args.views, args.views_per_call):
        n = min(args.views_per_call, args.views - first)
        out = render_request(model, orbit_batch(scene, batch, first, n,
                                                args.views),
                             args.height, args.width)
        frames.extend(out["comp_rgb"][0].cpu().numpy())
    paths = save_video_frames(args.out, frames)
    print(json.dumps({"frames": len(paths), "out": args.out,
                      "n_points": scene.n_points}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
