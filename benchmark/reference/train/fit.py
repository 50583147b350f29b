"""The one-shot fit step in plain PyTorch: forward with the fit-constant
prefix computed once, loss = L1 + VGG + mask MSE + identity regularisers,
the gradients of the per-identity parameters by autograd, and Adam written
out (betas 0.9 / 0.999, eps 1e-8, bias-corrected, as ``torch.optim.Adam``)
at the MultiStepLR rate of the update count.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark.reference.train.losses import (LossWeights, compute_error,
                                              identity_regularizers)

TRAINABLE_KEYS = ("map_bias", "color_w", "color_b", "opacity_b",
                  "identity_code")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    lr: float = 0.01
    steps_per_epoch: int = 50
    milestones: Tuple[int, ...] = (2, 5, 10, 20, 35, 50, 75)
    gamma: float = 0.5
    weights: LossWeights = LossWeights()


def lr_at(cfg: FitConfig, count: int) -> float:
    """The rate after ``count`` updates."""
    return cfg.lr * cfg.gamma ** sum(count >= m * cfg.steps_per_epoch
                                     for m in cfg.milestones)


def trainable(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """The per-identity parameters by name; every other parameter stops
    requiring grad."""
    out = {}
    for name, p in model.named_parameters():
        train = any(k in name for k in TRAINABLE_KEYS)
        p.requires_grad_(train)
        if train:
            out[name] = p
    return out


def fit_steps(model, vgg_loss_fn: Optional[Callable], batch: Dict,
              n_steps: int, cfg: FitConfig, *, height: int, width: int,
              loss_patch: Optional[Callable] = None) -> Dict:
    """Runs ``n_steps`` steps. Returns per step the loss terms (floats),
    the first step's render (comp_rgb (H, W, 3), comp_mask (H, W)), its
    rasterizer work and gradients by name, and the parameters by name
    after the last update.
    ``loss_patch(pred_rgb, target_rgb, pred_mask, target_mask)`` may
    replace the images the losses see (a planted fault)."""
    params = trainable(model)
    with torch.no_grad():
        batch = {**batch, "static_feats": model.static_features(batch)}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses: List[Dict[str, float]] = []
    first: Dict = {}
    for t in range(1, n_steps + 1):
        out = model(batch, height, width)
        imgs = (out["comp_rgb"][:, 0], batch["target_rgb"],
                out["comp_mask"][:, 0], batch["target_mask"])
        if loss_patch is not None:
            imgs = loss_patch(*imgs)
        total, err = compute_error(*imgs, vgg_loss_fn, cfg.weights)
        err["reg"] = identity_regularizers(
            {"color_b": model.color_b, "opacity_b": model.opacity_b,
             "map_bias": model.map_bias}, cfg.weights)
        total = total + err["reg"]
        names = list(params)
        grads = torch.autograd.grad(total, [params[k] for k in names],
                                    allow_unused=True)
        losses.append({"loss": float(total.detach()),
                       **{k: float(e.detach()) for k, e in err.items()}})
        if t == 1:
            first = {"comp_rgb": out["comp_rgb"][0, 0].detach(),
                     "comp_mask": out["comp_mask"][0, 0].detach(),
                     "work": out["work"][0],
                     "grads": {k: g for k, g in zip(names, grads)
                               if g is not None}}
        lr = lr_at(cfg, t - 1)
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None:
                    continue
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                params[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del out, total, grads
    return {"losses": losses, **first,
            "params": {k: p.detach() for k, p in params.items()}}
