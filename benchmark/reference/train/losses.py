"""Fitting losses (a frozen copy of the program's ``train/losses.py``).

- ``pix_loss``: l1 / l2 / lp pixel losses, and the top-K ones: a key
  ``l1top<P>`` / ``l2top<P>`` is the mean of the largest P % of the
  per-pixel channel sums of |diff| / diff^2;
- ``compute_error``: the weighted sum of L1 + VGG + mask MSE;
- ``identity_regularizers``: 100 mean|color_b| + mean(opacity_b^2)
  + 0.01 mean(map_bias^2).

|x| in the pixel losses is ``abs_ref``: the JAX package's ``jnp.abs``, whose
gradient at 0 is 1 (``torch.abs``'s is 0). It matters where prediction and
target agree exactly, as in the VGG features of an empty background. The
regulariser uses ``torch.abs``, whose 0 at 0 the JAX package reproduces
there with x sign(x).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The lambdas of the reference's one-shot config."""

    l1: float = 10.0
    l2: float = 0.0
    lp: float = 0.0
    vgg: float = 0.1
    mask: float = 1.0
    # the JAX package's fields, which its compute_error does not read
    # either: stored with no effect (pix_loss takes l1top<P> keys)
    l1_top: float = 0.0
    l1_top_ratio: float = 0.2
    color_b_reg: float = 100.0
    opacity_b_reg: float = 1.0
    map_bias_reg: float = 0.01


def abs_ref(x: torch.Tensor) -> torch.Tensor:
    """|x| with gradient sign(x) for x != 0 and 1 at 0, as ``jnp.abs``."""
    return torch.where(x >= 0, x, -x)


def pix_loss(src: torch.Tensor, tar: torch.Tensor,
             weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """src/tar: (..., C, H, W) or any matching shape."""
    out = {}
    diff = src - tar
    if weights.get("l1", 0.0) > 0:
        out["l1"] = weights["l1"] * abs_ref(diff).mean()
    if weights.get("l2", 0.0) > 0:
        out["l2"] = weights["l2"] * (diff ** 2).mean()
    if weights.get("lp", 0.0) > 0:
        out["lp"] = weights["lp"] * ((abs_ref(diff) + 1e-4) ** 0.4).mean()
    for key, w in weights.items():
        if key.startswith(("l1top", "l2top")) and w > 0:
            ratio = float(key[5:]) / 100.0
            err = abs_ref(diff) if key.startswith("l1") else diff ** 2
            per_px = err.sum(-3).reshape(diff.shape[0], -1)
            k = max(1, int(per_px.shape[-1] * ratio))
            out[key] = w * torch.topk(per_px, k, dim=-1).values.mean()
    return out


def compute_error(pred_rgb: torch.Tensor, target_rgb: torch.Tensor,
                  pred_mask: Optional[torch.Tensor] = None,
                  target_mask: Optional[torch.Tensor] = None,
                  vgg_loss_fn: Optional[Callable] = None,
                  weights: LossWeights = LossWeights()):
    """(total, err dict) from (B, H, W, 3) images and (B, H, W) masks."""
    err = {}
    src = pred_rgb.permute(0, 3, 1, 2)
    tar = target_rgb.permute(0, 3, 1, 2)
    pw = {"l1": weights.l1, "l2": weights.l2, "lp": weights.lp}
    err.update({f"e_pix_{k}": v for k, v in pix_loss(src, tar, pw).items()})
    if pred_mask is not None and target_mask is not None and weights.mask > 0:
        pm = torch.clamp(pred_mask, -0.001, 1.0)
        err["mask_loss"] = weights.mask * ((pm - target_mask) ** 2).mean()
    if vgg_loss_fn is not None and weights.vgg > 0:
        err["e_vgg"] = weights.vgg * vgg_loss_fn(src, tar)
    total = sum(err.values(), torch.zeros((), device=pred_rgb.device))
    return total, err


def identity_regularizers(params: Dict[str, torch.Tensor],
                          weights: LossWeights = LossWeights()):
    """The per-identity parameter regularisers; ``params`` holds color_b,
    opacity_b and map_bias. A narrow (3, Hm, Wm) color_b is averaged over
    the 48-channel element count, so value and gradient equal the wide
    layout's (its other 45 channels stay 0)."""
    cb = params["color_b"]
    denom = (48.0 * cb.shape[-2] * cb.shape[-1]
             if cb.dim() == 3 and cb.shape[0] == 3 else cb.numel())
    return (weights.color_b_reg * cb.abs().sum() / denom
            + weights.opacity_b_reg * (params["opacity_b"] ** 2).mean()
            + weights.map_bias_reg * (params["map_bias"] ** 2).mean())
