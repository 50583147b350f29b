"""One-shot avatar fitting (counterpart of ``train/fit.py``).

- Adam (optax's defaults: betas 0.9 / 0.999, eps 1e-8) with a MultiStepLR
  schedule (milestones [2, 5, 10, 20, 35, 50, 75] epochs, gamma 0.5),
  evaluated on the number of updates already made, as optax evaluates
  ``piecewise_constant_schedule``;
- only the per-identity parameters train (``TRAINABLE_KEYS``); every other
  parameter gets ``requires_grad_(False)``, so no gradient is computed for
  it (the JAX package's ``stop_frozen``);
- loss = L1 + VGG + mask MSE + identity regularisers;
- "training" refits the single reference frame for epochs x
  steps_per_epoch steps; its fit-constant prefix (frame embeddings and the
  shade branch) is computed once (``attach_static_features``).

The model runs in eval mode: the JAX fit step applies it with
``train=False``, so no dropout. Steps run with TF32 off. Under a bf16
compute dtype the losses still take float32 renders: the step checks it
rather than casting.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel, no_tf32
from guassianhand_tpu_torch.train.losses import (LossWeights, compute_error,
                                                 identity_regularizers)

TRAINABLE_KEYS = ("map_bias", "color_w", "color_b", "opacity_b",
                  "identity_code")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    lr: float = 0.01
    epochs: int = 1
    steps_per_epoch: int = 50
    milestones: Tuple[int, ...] = (2, 5, 10, 20, 35, 50, 75)
    gamma: float = 0.5
    weights: LossWeights = LossWeights()
    # average the gradients of this many micro-batches before each update
    accumulate_grad_batches: int = 1
    # compute the fit-constant prefix of the features once per fit
    static_prefix_cache: bool = True
    # JAX's stop_gradient on the frozen base before the forward: the port
    # always freezes it by requires_grad_(False) (make_optimizer), and JAX
    # documents bit-identical updates either way, so no effect here
    freeze_base_gradients: bool = True


def lr_schedule(cfg: FitConfig) -> Callable[[int], float]:
    """lr after ``count`` updates: lr * gamma per milestone boundary
    (milestone x steps_per_epoch) at or below ``count``."""
    boundaries = [m * cfg.steps_per_epoch for m in cfg.milestones]

    def schedule(count: int) -> float:
        return cfg.lr * cfg.gamma ** sum(count >= b for b in boundaries)

    return schedule


def trainable_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True for the per-identity parameters, matched by name."""
    return {name: any(k in name for k in TRAINABLE_KEYS)
            for name, _ in model.named_parameters()}


def make_optimizer(model: torch.nn.Module, cfg: FitConfig = FitConfig()
                   ) -> Tuple[torch.optim.Adam,
                              torch.optim.lr_scheduler.LambdaLR]:
    """Adam over the trainable parameters and its lr schedule; every other
    parameter stops requiring grad, so its weight gradients are never
    computed."""
    mask = trainable_mask(model)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    optimizer = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    schedule = lr_schedule(cfg)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / cfg.lr)
    return optimizer, scheduler


def attach_static_features(model: OneShotAvatarModel, batch: Dict) -> Dict:
    """A copy of ``batch`` carrying ``model.static_features(batch)`` under
    ``"static_feats"``: every forward that sees the key skips the frame
    embeddings and the shade branch. Valid for the whole fit, since only
    per-identity parameters train."""
    with no_tf32():
        return {**batch, "static_feats": model.static_features(batch)}


def make_fit_step(model: OneShotAvatarModel, vgg_loss_fn: Optional[Callable],
                  optimizer: torch.optim.Optimizer,
                  scheduler: Optional[torch.optim.lr_scheduler.LRScheduler],
                  cfg: FitConfig = FitConfig(), *, height: int, width: int,
                  forward_kw: Optional[Dict[str, Any]] = None):
    """``step(batch) -> (loss, err)``: forward, loss, backward and, every
    ``cfg.accumulate_grad_batches`` calls, one Adam update and one schedule
    step. The batch holds target_rgb (B, H, W, 3) and target_mask (B, H, W)
    for the input view (V = 1 while fitting). ``forward_kw`` goes to every
    forward (the edit fit's ``edit`` and ``identity_from_book``; none of
    them sits upstream of ``static_features``). ``err`` has the JAX step's
    keys: e_pix_l1, mask_loss, e_vgg (with a VGG loss), reg, overflow
    (always 0: the port bins every pair) and interaction_overflow (the
    interacting points ``interaction_cap`` left out)."""
    k = cfg.accumulate_grad_batches
    calls = [0]
    forward_kw = forward_kw or {}

    def loss_fn(batch):
        out = model(batch, height, width, **forward_kw)
        for key in ("comp_rgb", "comp_mask"):
            if out[key].dtype != torch.float32:
                raise TypeError(f"the losses take float32 renders, "
                                f"{key} is {out[key].dtype}")
        total, err = compute_error(
            out["comp_rgb"][:, 0], batch["target_rgb"], out["comp_mask"][:, 0],
            batch["target_mask"], vgg_loss_fn, cfg.weights)
        err["reg"] = identity_regularizers(
            {"color_b": model.color_b, "opacity_b": model.opacity_b,
             "map_bias": model.map_bias}, cfg.weights)
        err["overflow"] = torch.tensor(float(sum(out["overflow"])))
        err["interaction_overflow"] = out["interaction_overflow"]
        return total + err["reg"], err

    def step(batch):
        with no_tf32():
            loss, err = loss_fn(batch)
            (loss / k if k > 1 else loss).backward()
        calls[0] += 1
        if calls[0] % k == 0:
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if scheduler is not None:
                scheduler.step()
        return loss.detach(), {key: v.detach() for key, v in err.items()}

    return step


def fit(model: OneShotAvatarModel, batch_fn: Callable[[int], Dict],
        vgg_loss_fn: Optional[Callable] = None,
        cfg: FitConfig = FitConfig(), *, height: int, width: int,
        log_every: int = 10, log_fn: Callable[[str], None] = print):
    """Run the fitting loop; ``batch_fn(step)`` gives the batch. Returns the
    losses logged every ``log_every`` steps and at the last."""
    if cfg.static_prefix_cache:
        first = batch_fn(0)
        if "static_feats" not in first:
            static = attach_static_features(model, first)["static_feats"]
            inner = batch_fn

            def batch_fn(i, _inner=inner, _static=static):
                return {"static_feats": _static, **_inner(i)}

    optimizer, scheduler = make_optimizer(model, cfg)
    step_fn = make_fit_step(model, vgg_loss_fn, optimizer, scheduler, cfg,
                            height=height, width=width)
    n_steps = cfg.epochs * cfg.steps_per_epoch
    history = []
    t0 = time.time()
    for i in range(n_steps):
        loss, _ = step_fn(batch_fn(i))
        if i % log_every == 0 or i == n_steps - 1:
            history.append(float(loss))
            log_fn(f"fit step {i}/{n_steps} loss={history[-1]:.5f} "
                   f"({time.time() - t0:.1f}s)")
    return history
