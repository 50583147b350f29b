"""One-shot avatar fitting CLI (counterpart of ``cli/fit_one_shot.py``, its
fitting branch on the synthetic two-hand scene).

  python -m guassianhand_tpu_torch.cli.fit_one_shot --synthetic \\
      [--steps N] [--height H] [--width W] [--device cpu] [key.sub=value ...]

Builds the scene and its target image, a model with seeded weights (or the
``pretrained`` checkpoint), and fits its per-identity parameters. Resumes
from the run's latest checkpoint, logs metrics to ``metrics.jsonl``, writes
prediction/target PNGs every 10 steps under ``vis/`` and a checkpoint at the
end, all under ``<out_dir>/<expname>``. Runs on ``cuda`` unless
``--device cpu``. Evaluation (``--run_val``), the InterHand2.6M data path,
the texture-edit fit and the PLY export are not ported yet, and are
refused. ``model.compute_dtype`` takes effect (``configs/one_shot.yaml``
fits with a bf16 feature pipeline); the run prints the type the model
computes in, and its config snapshot records it as
``compute_dtype_effective``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import torch

from guassianhand_tpu_torch.config import (compute_dtype_line, load_config,
                                           save_config_snapshot)
from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                   synthetic_batch)
from guassianhand_tpu_torch.models.one_shot import build_model, no_tf32
from guassianhand_tpu_torch.train import checkpoints as ckpt_lib
from guassianhand_tpu_torch.train.fit import (attach_static_features,
                                              make_fit_step, make_optimizer)
from guassianhand_tpu_torch.train.vgg import VGGLoss
from guassianhand_tpu_torch.utils.logging import RunLogger
from guassianhand_tpu_torch.utils.saving import save_image


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("guassianhand-tpu-torch one-shot fitting")
    parser.add_argument("--config", default=None)
    parser.add_argument("--run_val", action="store_true",
                        help="evaluation: not ported yet")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=None,
                        help="override total fit steps")
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args, extras = parser.parse_known_args(argv)
    if args.run_val:
        parser.error("--run_val (evaluation) is not ported yet")

    cfg = load_config(args.config, extras)
    if not (args.synthetic or cfg.data.dataset == "synthetic"):
        parser.error("only the synthetic scene is ported yet: pass "
                     "--synthetic (the InterHand2.6M path is not)")
    if cfg.edit.enabled or cfg.data.edit:
        parser.error("the texture-edit fit (edit.enabled, data.edit) is not "
                     "ported yet")
    print(compute_dtype_line(cfg.model))
    run_dir = os.path.join(cfg.out_dir, cfg.expname)
    save_config_snapshot(cfg, run_dir)
    hw_h = args.height or cfg.data.height
    hw_w = args.width or cfg.data.width

    scene = SyntheticHandScene.build(
        n_vertices=778, subdivide=min(cfg.data.edge_subdivide, 1),
        height=hw_h, width=hw_w, device=args.device)
    batch = synthetic_batch(scene, seed=cfg.seed,
                            raster=cfg.model.renderer.raster, with_target=True)
    model = build_model(cfg.model, seed=cfg.seed, device=args.device)
    if cfg.pretrained and os.path.exists(cfg.pretrained):
        ckpt_lib.load_checkpoint(cfg.pretrained, model)
        print(f"loaded pretrained weights from {cfg.pretrained}")

    vgg = None
    if cfg.fit.weights.vgg > 0:
        vgg = VGGLoss(cfg.vgg_weights).to(args.device)
        if not vgg.pretrained:
            print("VGG19 weights unavailable; the perceptual term is off")
            vgg = None

    fit_cfg = cfg.fit
    if args.steps:
        fit_cfg = dataclasses.replace(fit_cfg, epochs=1,
                                      steps_per_epoch=args.steps)
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    ckpt_dir = os.path.join(run_dir, "ckpts")
    last = ckpt_lib.latest_checkpoint(ckpt_dir) if cfg.resume else None
    start = 0
    if last:
        start = ckpt_lib.load_checkpoint(last, model, optimizer, scheduler)
        print(f"resumed from {last} at step {start}")
    step_fn = make_fit_step(model, vgg, optimizer, scheduler, fit_cfg,
                            height=hw_h, width=hw_w)
    if fit_cfg.static_prefix_cache:
        batch = attach_static_features(model, batch)

    n_steps = fit_cfg.epochs * fit_cfg.steps_per_epoch
    vis = os.path.join(run_dir, "vis")
    with contextlib.closing(RunLogger(run_dir)) as logger:
        for i in range(start, n_steps):
            loss, err = step_fn(batch)
            if i % 10 == 0 or i == n_steps - 1:
                logger.log(i, {"loss": loss, **err})
                with torch.no_grad(), no_tf32():
                    out = model(batch, hw_h, hw_w)
                save_image(os.path.join(vis, f"step{i:04d}_pred.png"),
                           out["comp_rgb"][0, 0].cpu().numpy())
                save_image(os.path.join(vis, f"step{i:04d}_ref.png"),
                           batch["target_rgb"][0].cpu().numpy())
    ckpt_lib.save_checkpoint(
        os.path.join(ckpt_dir, f"model-{n_steps:05d}.ckpt"), model,
        optimizer, scheduler, n_steps)
    print(f"fit done; artifacts in {run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
