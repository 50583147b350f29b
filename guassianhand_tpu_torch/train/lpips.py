"""LPIPS with an AlexNet backbone (counterpart of ``train/lpips.py``).

The weights come from ``weights_path`` or ``$GH_LPIPS_WEIGHTS``: a torch
state_dict with torchvision AlexNet's feature convolutions and the LPIPS
calibration layers (``lin0`` .. ``lin4``). Without them the network is a
fixed-seed random AlexNet with uniform calibration (``_random_params``, the
JAX package's numpy draw), which ranks images but is no published LPIPS:
``pretrained`` says which, and callers score LPIPS only when it is True.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# AlexNet's feature convolutions: (out channels, kernel, stride, padding,
# a 3 x 3 / 2 max-pool before it)
_ALEX_PLAN = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
# their indices in torchvision's AlexNet ``features``
_ALEX_IDX = [0, 3, 6, 8, 10]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _random_params(seed: int = 0):
    """[(weight (O, I, k, k), bias (O,))] and [lin (O,)] from
    ``np.random.RandomState(seed)``: He-normal weights, zero biases,
    uniform calibration 1 / O."""
    rng = np.random.RandomState(seed)
    convs, lins = [], []
    in_ch = 3
    for out_ch, k, _, _, _ in _ALEX_PLAN:
        fan = in_ch * k * k
        convs.append((rng.normal(0, np.sqrt(2.0 / fan),
                                 (out_ch, in_ch, k, k)).astype(np.float32),
                      np.zeros(out_ch, np.float32)))
        lins.append(np.full((out_ch,), 1.0 / out_ch, np.float32))
        in_ch = out_ch
    return convs, lins


def _load_params(weights_path: Optional[str]):
    """(convs, lins, pretrained): the state_dict's weights where a file is
    given and exists, else ``_random_params()``."""
    path = weights_path or os.environ.get("GH_LPIPS_WEIGHTS")
    if not (path and os.path.exists(path)):
        convs, lins = _random_params()
        return convs, lins, False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.replace("net.", "").replace("model.", ""): v
          for k, v in sd.items()}
    convs, lins = [], []
    for i, idx in enumerate(_ALEX_IDX):
        key_w = next(k for k in (f"slice{i + 1}.{idx}.weight",
                                 f"features.{idx}.weight", f"{idx}.weight")
                     if k in sd)
        key_b = key_w.replace("weight", "bias")
        convs.append((sd[key_w].numpy(), sd[key_b].numpy()))
        lin_key = (f"lin{i}.1.weight" if f"lin{i}.1.weight" in sd
                   else f"lins.{i}.1.weight")
        lins.append(sd[lin_key].numpy().reshape(-1))
    return convs, lins, True


class LPIPS(nn.Module):
    """``LPIPS()(x, y)``: x, y (B, 3, H, W) in [-1, 1] -> (B,) distances."""

    def __init__(self, weights_path: Optional[str] = None):
        super().__init__()
        convs, lins, self.pretrained = _load_params(weights_path)
        for i, ((w, b), lin) in enumerate(zip(convs, lins)):
            self.register_buffer(f"w{i}", torch.as_tensor(np.array(w)))
            self.register_buffer(f"b{i}", torch.as_tensor(np.array(b)))
            self.register_buffer(f"lin{i}", torch.as_tensor(np.array(lin)))
        self.register_buffer("shift",
                             torch.as_tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale",
                             torch.as_tensor(_SCALE).reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list:
        h = (x - self.shift) / self.scale
        outs = []
        for i, (_, _, stride, pad, pool) in enumerate(_ALEX_PLAN):
            if pool:
                h = F.max_pool2d(h, 3, 2)
            h = F.relu(F.conv2d(h, getattr(self, f"w{i}"), stride=stride,
                                padding=pad) + getattr(self, f"b{i}")[:, None,
                                                                     None])
            outs.append(h)
        return outs

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(x), self.features(y))):
            an = a / a.norm(dim=1, keepdim=True).clamp_min(1e-10)
            bn = b / b.norm(dim=1, keepdim=True).clamp_min(1e-10)
            d = ((an - bn) ** 2 * getattr(self, f"lin{i}")[:, None, None])
            total = total + d.sum(1).mean((1, 2))
        return total


def lpips_from_01(metric: LPIPS, x01: torch.Tensor,
                  y01: torch.Tensor) -> torch.Tensor:
    """LPIPS of (B, H, W, 3) images in [0, 1]."""
    x = x01.permute(0, 3, 1, 2) * 2.0 - 1.0
    y = y01.permute(0, 3, 1, 2) * 2.0 - 1.0
    return metric(x, y)
