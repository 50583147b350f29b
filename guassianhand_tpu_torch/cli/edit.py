"""Texture-edit fit (counterpart of ``cli/edit.py``): fit the per-identity
appearance parameters to an edit image, such as a painted texture, with
the renderer's edit semantics, then keep the edited avatar:

  python -m guassianhand_tpu_torch.cli.edit [--config cfg.yaml]
      [--image edit.png] [--mask mask.png] [--left-only] [--duplication]
      [--steps 1000] [--ckpt fitted.ckpt] [--identity I] [--device cpu]
      [key.sub=value ...]

As in the JAX package: lr 0.001, max(1, steps // 100) epochs of
min(100, steps) steps, no perceptual term, the identity plane taken from
the codebook's entry ``--identity`` when given, and ``EditConfig(enabled,
--left-only, --duplication)`` (the config's ``edit`` section is not read).
The scene is the synthetic two hands subdivided min(data.edge_subdivide, 1)
times; the target is ``--image`` (and ``--mask``) or, without one, the
scene's own render. ``--ckpt`` is a checkpoint of the port's own
(``train/checkpoints.py``), for instance a one-shot fit's. Every 50 steps
and at the last the edited render goes to ``vis/editNNNN.png``, and the
parameters to ``ckpts/edit.ckpt`` at the end, all under
``<out_dir>/<expname>_edit``. Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from guassianhand_tpu_torch.config import compute_dtype_line, load_config
from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                   synthetic_batch)
from guassianhand_tpu_torch.models.one_shot import (OneShotAvatarModel,
                                                    build_model, no_tf32)
from guassianhand_tpu_torch.render.renderer import EditConfig
from guassianhand_tpu_torch.train import checkpoints as ckpt_lib
from guassianhand_tpu_torch.train.fit import (FitConfig,
                                              attach_static_features,
                                              make_fit_step, make_optimizer)
from guassianhand_tpu_torch.train.losses import LossWeights
from guassianhand_tpu_torch.utils.saving import Saver

EDIT_LR = 0.001


def edit_fit_config(steps: int) -> FitConfig:
    """The edit schedule for ``steps`` steps (the reference's 10 epochs of
    100 steps at 1000)."""
    return FitConfig(lr=EDIT_LR, epochs=max(1, steps // 100),
                     steps_per_epoch=min(100, steps),
                     weights=LossWeights(vgg=0.0))


def make_edit_step(model: OneShotAvatarModel, batch: Dict, fit_cfg: FitConfig,
                   edit: EditConfig, identity: Optional[int], *, height: int,
                   width: int):
    """The edit fit's step on ``batch`` (with its target): (step, the batch
    with the fit-constant prefix attached, the forward's options, the
    optimiser, its schedule). ``step(batch) -> (loss, err)`` as
    ``train/fit.py::make_fit_step``'s."""
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    forward_kw = {"edit": edit, "identity_from_book": identity}
    step = make_fit_step(model, None, optimizer, scheduler, fit_cfg,
                         height=height, width=width, forward_kw=forward_kw)
    if fit_cfg.static_prefix_cache:
        batch = attach_static_features(model, batch)
    return step, batch, forward_kw, optimizer, scheduler


def load_target(path: str, height: int, width: int) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] from an image file, resized with PIL
    (imported only where the size differs), as the JAX CLI resizes."""
    from guassianhand_tpu_torch.data.native_loader import decode_image
    img = decode_image(path)
    if img.shape[:2] != (height, width):
        import PIL.Image
        img = np.asarray(PIL.Image.fromarray(
            (img * 255).astype(np.uint8)).resize((width, height)),
            np.float32) / 255.0
    return img


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("guassianhand-tpu-torch texture edit")
    parser.add_argument("--config", default=None)
    parser.add_argument("--image", default=None,
                        help="edit target image (the scene's render if "
                             "omitted)")
    parser.add_argument("--mask", default=None)
    parser.add_argument("--left-only", action="store_true")
    parser.add_argument("--duplication", action="store_true")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--ckpt", default=None,
                        help="a checkpoint of the port to start from")
    parser.add_argument("--identity", type=int, default=None,
                        help="identity index in the codebook")
    parser.add_argument("--device", default="cuda")
    args, extras = parser.parse_known_args(argv)
    if args.ckpt and not os.path.exists(args.ckpt):
        parser.error(f"--ckpt {args.ckpt} does not exist")

    cfg = load_config(args.config, extras)
    print(compute_dtype_line(cfg.model))
    hw_h, hw_w = cfg.data.height, cfg.data.width
    saver = Saver(os.path.join(cfg.out_dir, cfg.expname + "_edit"))
    edit = EditConfig(enabled=True, edit_left_only=args.left_only,
                      duplication=args.duplication)

    scene = SyntheticHandScene.build(
        n_vertices=778, subdivide=min(cfg.data.edge_subdivide, 1),
        height=hw_h, width=hw_w, device=args.device)
    batch = synthetic_batch(scene, seed=cfg.seed,
                            raster=cfg.model.renderer.raster, with_target=True)
    if args.image:
        img = load_target(args.image, hw_h, hw_w)
        batch["target_rgb"] = torch.as_tensor(img, device=args.device)[None]
        if args.mask:
            m = load_target(args.mask, hw_h, hw_w).mean(-1)
            batch["target_mask"] = torch.as_tensor(
                (m > 0.4).astype(np.float32), device=args.device)[None]

    model = build_model(cfg.model, seed=cfg.seed, device=args.device)
    if args.ckpt:
        ckpt_lib.load_checkpoint(args.ckpt, model)
        print(f"starting from {args.ckpt}")
    fit_cfg = edit_fit_config(args.steps)
    step, batch, forward_kw, optimizer, scheduler = make_edit_step(
        model, batch, fit_cfg, edit, args.identity, height=hw_h, width=hw_w)
    n_steps = fit_cfg.epochs * fit_cfg.steps_per_epoch
    for i in range(n_steps):
        loss, _ = step(batch)
        if i % 50 == 0 or i == n_steps - 1:
            print(f"edit step {i}/{n_steps} loss={float(loss):.5f}")
            with torch.no_grad(), no_tf32():
                out = model(batch, hw_h, hw_w, **forward_kw)
            saver.save_rgb(f"vis/edit{i:04d}.png",
                           out["comp_rgb"][0, 0].cpu().numpy())
    ckpt_lib.save_checkpoint(saver.path("ckpts", "edit.ckpt"), model,
                             optimizer, scheduler, n_steps)
    print(f"edit fit done; artifacts in {saver.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
