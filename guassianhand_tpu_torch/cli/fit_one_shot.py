"""One-shot avatar fitting and evaluation CLI (counterpart of
``cli/fit_one_shot.py``).

  python -m guassianhand_tpu_torch.cli.fit_one_shot [--config cfg.yaml]
      [--synthetic] [--run_val [--val_frames N] [--no_images]] [--steps N]
      [--height H] [--width W] [--subdivide S] [--device cpu]
      [key.sub=value ...]

The data is the synthetic two-hand scene with ``--synthetic`` or
``data.dataset: synthetic`` (the default), subdivided
``min(data.edge_subdivide, 1)`` times as in the JAX package unless
``--subdivide`` says otherwise (2 gives the 15,404 points of InterHand2.6M's
meshes at ``edge_subdivide: 2``), else InterHand2.6M
(``data/interhand.py``, from ``data.data_root``, ``data.annot_path`` and
the MANO pickles of ``data.mano_models_path``). The model has seeded
weights, over which the ``pretrained`` checkpoint is loaded where it is
given (strict=False: ``train/checkpoints.load_params_partial``).

A fit trains the per-identity parameters on one frame (the synthetic
scene's target, or InterHand2.6M's one-shot frame of the train split): it
resumes from the run's latest checkpoint, logs metrics to
``metrics.jsonl``, writes prediction/target PNGs every 10 steps under
``vis/``, a checkpoint at the end and the fitted Gaussians as
``3dgs/fitted.ply``.

``--run_val`` evaluates the run's latest checkpoint instead (the seeded or
pretrained weights where there is none): on InterHand2.6M over every frame
of the test split's ``data.pose_sequence`` (14 for ``oneshot_reg_i``),
the prediction masked by the frame's ``bbox_mask``; on the synthetic scene
over ``--val_frames`` frames, each a pose of its own seed. It scores PSNR,
MSE and SSIM (on the bounding box of the frame's ``mask_at_box`` where the
frame has one), LPIPS only with real AlexNet weights (``lpips_weights`` or
``$GH_LPIPS_WEIGHTS``), and writes their means with the frame count,
throughput, the card's peak bytes and the weights' provenance to
``test_metrics.yml``; per-frame PNGs under ``images/`` unless
``--no_images``. Everything goes under ``<out_dir>/<expname>``. Runs on
``cuda`` unless ``--device cpu``.

As in the JAX package this CLI does not read the ``edit`` section: an edit
config fits (or evaluates) as any other, with ``data.edit``,
``data.image_path`` and ``data.mask_path`` choosing InterHand2.6M's edit
frame and target; the edit fit is ``cli/edit.py``. ``model.compute_dtype``
takes effect (``configs/one_shot.yaml`` fits with a bf16 feature
pipeline); the run prints the type the model computes in, and its config
snapshot records it as ``compute_dtype_effective``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from guassianhand_tpu_torch.config import (compute_dtype_line, load_config,
                                           save_config_snapshot)
from guassianhand_tpu_torch.data.interhand import (InterHandConfig,
                                                   InterHandDataset)
from guassianhand_tpu_torch.data.rays import (bounds_from_points,
                                              get_mask_at_box)
from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                   synthetic_batch)
from guassianhand_tpu_torch.models.one_shot import build_model, no_tf32
from guassianhand_tpu_torch.train import checkpoints as ckpt_lib
from guassianhand_tpu_torch.train.fit import (FitConfig,
                                              attach_static_features,
                                              make_fit_step, make_optimizer)
from guassianhand_tpu_torch.train.lpips import LPIPS, lpips_from_01
from guassianhand_tpu_torch.train.metrics import bbox_crop, psnr, ssim
from guassianhand_tpu_torch.train.vgg import VGGLoss
from guassianhand_tpu_torch.utils.logging import RunLogger
from guassianhand_tpu_torch.utils.saving import Saver


def interhand_dataset(cfg, split: str, device, height: int,
                      width: int) -> InterHandDataset:
    """The config's InterHand2.6M split on ``device``, its images resized
    to ``height`` x ``width`` (the run's, which ``--height`` / ``--width``
    override)."""
    d = cfg.data
    return InterHandDataset(InterHandConfig(
        data_root=d.data_root, annot_path=d.annot_path, split=split,
        pose_sequence=d.pose_sequence, edge_subdivide=d.edge_subdivide,
        mask_sa=d.mask_sa, render_mask=d.render_mask, height=height,
        width=width, mano_models_path=d.mano_models_path,
        mano_uv_path=d.mano_uv_path, color_jitter=d.color_jitter,
        use_native_loader=d.use_native_loader, edit=d.edit,
        image_path=d.image_path, mask_path=d.mask_path), device=device)


def eval_batches(scene: SyntheticHandScene, cfg, frames: int):
    """The evaluation's frames: with one, the fit's own batch; with more,
    frame i the pose of seed ``cfg.seed + i`` with its ``mask_at_box``
    (the pixels whose rays cross the posed points' padded box)."""
    raster = cfg.model.renderer.raster
    if frames <= 1:
        yield synthetic_batch(scene, seed=cfg.seed, raster=raster,
                              with_target=True)
        return
    w2c = np.asarray(scene.w2c)
    for i in range(frames):
        b = synthetic_batch(scene, seed=cfg.seed + i, raster=raster,
                            with_target=True)
        mab, _, _ = get_mask_at_box(
            bounds_from_points(b["points"][0].cpu().numpy()), scene.K,
            w2c[:3, :3], w2c[:3, 3], scene.height, scene.width)
        b["mask_at_box"] = mab
        yield b


def evaluate(model, frames, cfg, args, saver: Saver, vgg_pretrained: bool,
             hw_h: int, hw_w: int) -> dict:
    """The mean metrics over the batches ``frames``, written to
    ``test_metrics.yml`` (the keys of the JAX package's file)."""
    import yaml
    lpips_metric = LPIPS(cfg.lpips_weights).to(args.device)
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    results = []
    t0 = time.perf_counter()
    for i, batch in enumerate(frames):
        with torch.inference_mode(), no_tf32():
            pred = model(batch, hw_h, hw_w)["comp_rgb"][0, 0]
            tgt = batch["target_rgb"][0]
            if "bbox_mask" in batch:
                pred = pred * torch.as_tensor(batch["bbox_mask"] > 0,
                                              device=pred.device)[..., None]
            scores = {"psnr": float(psnr(pred, tgt)),
                      "mse": float(((pred - tgt) ** 2).mean())}
            if "mask_at_box" in batch:
                scores["ssim"] = float(ssim(
                    bbox_crop(pred, batch["mask_at_box"]),
                    bbox_crop(tgt, batch["mask_at_box"])))
            else:
                scores["ssim"] = float(ssim(pred, tgt))
            if lpips_metric.pretrained:
                # scored on uint8-quantised images, as the reference scores
                # reloaded PNGs
                pq = torch.round(pred.clamp(0, 1) * 255.0) / 255.0
                tq = torch.round(tgt.clamp(0, 1) * 255.0) / 255.0
                scores["lpips"] = float(lpips_from_01(
                    lpips_metric, pq[None], tq[None]))
        results.append(scores)
        if i % 50 == 0:
            print(f"[eval] frame {i}: psnr {scores['psnr']:.2f} "
                  f"({time.perf_counter() - t0:.0f}s elapsed)", flush=True)
        if not args.no_images:
            saver.save_rgb(f"images/frame{i:04d}_pred.png", pred.cpu().numpy())
            saver.save_rgb(f"images/frame{i:04d}_gt.png", tgt.cpu().numpy())
    wall_s = time.perf_counter() - t0
    mean = {k: float(np.mean([r[k] for r in results])) for k in results[0]}
    mean["eval_frames"] = len(results)
    mean["eval_wall_s"] = round(wall_s, 2)
    mean["eval_frames_per_s"] = round(len(results) / max(wall_s, 1e-9), 3)
    if on_card:
        mean["device_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    mean["weights_provenance"] = {
        "vgg19": "pretrained" if vgg_pretrained else "absent_or_random",
        "lpips_alex": "pretrained" if lpips_metric.pretrained else
                      "absent (lpips omitted)"}
    out_path = saver.path("test_metrics.yml")
    with open(out_path, "w") as f:
        yaml.safe_dump(mean, f)
    print("results:", mean, "->", out_path)
    return mean


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("guassianhand-tpu-torch one-shot fitting")
    parser.add_argument("--config", default=None)
    parser.add_argument("--run_val", action="store_true",
                        help="evaluate the run's latest checkpoint")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=None,
                        help="override total fit steps")
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--subdivide", type=int, default=None,
                        help="the synthetic scene's subdivisions (default "
                             "min(data.edge_subdivide, 1))")
    parser.add_argument("--val_frames", type=int, default=1,
                        help="with --run_val: evaluate this many pose-varied "
                             "frames")
    parser.add_argument("--no_images", action="store_true",
                        help="with --run_val: write no per-frame PNGs")
    parser.add_argument("--device", default="cuda")
    args, extras = parser.parse_known_args(argv)
    if args.run_val:
        try:
            import yaml  # noqa: F401
        except ImportError:
            parser.error("--run_val writes test_metrics.yml with the yaml "
                         "package, which is not installed")

    cfg = load_config(args.config, extras)
    if cfg.edit.enabled or cfg.data.edit:
        print("this CLI does not read the edit settings (edit.*; data.edit "
              "only picks InterHand2.6M's edit frame), as in the JAX "
              "package; the edit fit is guassianhand_tpu_torch.cli.edit")
    print(compute_dtype_line(cfg.model))
    hw_h = args.height or cfg.data.height
    hw_w = args.width or cfg.data.width

    # the data first: a run whose data is missing writes nothing
    if args.synthetic or cfg.data.dataset == "synthetic":
        scene = SyntheticHandScene.build(
            n_vertices=778,
            subdivide=(min(cfg.data.edge_subdivide, 1)
                       if args.subdivide is None else args.subdivide),
            height=hw_h, width=hw_w, device=args.device)

        def fit_batch():
            return synthetic_batch(scene, seed=cfg.seed,
                                   raster=cfg.model.renderer.raster,
                                   with_target=True)

        def frames():
            return eval_batches(scene, cfg, args.val_frames)
    else:
        dataset = interhand_dataset(cfg, "test" if args.run_val else "train",
                                    args.device, hw_h, hw_w)

        def fit_batch():
            return dataset.load_sample(0)

        def frames():
            return (dataset.load_sample(i) for i in range(len(dataset)))
    run_dir = os.path.join(cfg.out_dir, cfg.expname)
    save_config_snapshot(cfg, run_dir)
    saver = Saver(run_dir)
    model = build_model(cfg.model, seed=cfg.seed, device=args.device)
    if cfg.pretrained and os.path.exists(cfg.pretrained):
        ckpt_lib.load_params_partial(cfg.pretrained, model)
        print(f"loaded pretrained weights from {cfg.pretrained}")

    vgg = None
    if cfg.fit.weights.vgg > 0:
        vgg = VGGLoss(cfg.vgg_weights).to(args.device)
        if not vgg.pretrained:
            print("VGG19 weights unavailable; the perceptual term is off")
            vgg = None

    ckpt_dir = os.path.join(run_dir, "ckpts")
    last = ckpt_lib.latest_checkpoint(ckpt_dir) if cfg.resume else None
    if args.run_val:
        if last:
            ckpt_lib.load_checkpoint(last, model)
            print(f"evaluating checkpoint {last}")
        evaluate(model, frames(), cfg, args, saver, vgg is not None, hw_h,
                 hw_w)
        return 0

    batch = fit_batch()
    fit_cfg = cfg.fit
    if args.steps:
        # as the JAX package: a fit of --steps steps on the default
        # schedule (milestones, gamma, accumulation and the prefix cache
        # back to their defaults), the config's lr and loss weights kept
        fit_cfg = FitConfig(lr=fit_cfg.lr, epochs=1,
                            steps_per_epoch=args.steps,
                            weights=fit_cfg.weights)
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    start = 0
    if last:
        start = ckpt_lib.load_checkpoint(last, model, optimizer, scheduler)
        print(f"resumed from {last} at step {start}")
    step_fn = make_fit_step(model, vgg, optimizer, scheduler, fit_cfg,
                            height=hw_h, width=hw_w)
    if fit_cfg.static_prefix_cache:
        batch = attach_static_features(model, batch)

    n_steps = fit_cfg.epochs * fit_cfg.steps_per_epoch
    with contextlib.closing(RunLogger(run_dir)) as logger:
        for i in range(start, n_steps):
            loss, err = step_fn(batch)
            if i % 10 == 0 or i == n_steps - 1:
                logger.log(i, {"loss": loss, **err})
                with torch.no_grad(), no_tf32():
                    out = model(batch, hw_h, hw_w)
                saver.save_rgb(f"vis/step{i:04d}_pred.png",
                               out["comp_rgb"][0, 0].cpu().numpy())
                saver.save_rgb(f"vis/step{i:04d}_ref.png",
                               batch["target_rgb"][0].cpu().numpy())
    ckpt_lib.save_checkpoint(
        os.path.join(ckpt_dir, f"model-{n_steps:05d}.ckpt"), model,
        optimizer, scheduler, n_steps)
    with torch.no_grad(), no_tf32():
        out = model(batch, hw_h, hw_w)
    saver.save_ply("3dgs/fitted.ply", out["3dgs"][0])
    print(f"fit done; artifacts in {run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
