"""VGG19 perceptual loss over 4 feature slices (counterpart of
``train/vgg.py``): ImageNet normalisation, features after relu1_1 /
relu2_1 / relu3_1 / relu4_1, L1 distance with weights [1/16, 1/8, 1/4, 1],
the target branch detached.

Weights: a torchvision ``vgg19`` state dict loaded from ``weights_path``
when one is given; otherwise a fixed-seed random network (``_random_params``,
the same numbers as the JAX package's). Convolutions are ``F.conv2d`` in
OIHW layout; on the card the caller turns TF32 off for fp32 parity. With
``compute_dtype`` (the JAX package's ``VGGLoss(compute_dtype=...)``) the
convolutions and their bias and ReLU run in that type, the weights stored
float32 and cast at each call; the ImageNet normalisation and the
per-slice L1 stay float32.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from guassianhand_tpu_torch.train.losses import abs_ref

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# the first 9 convs of torchvision's vgg19.features:
# (name in its state dict, out channels, max-pool before the conv)
_CONV_PLAN = [
    ("features.0", 64, False),    # conv1_1 [slice 1 ends after relu1_1]
    ("features.2", 64, False),    # conv1_2
    ("features.5", 128, True),    # conv2_1 [slice 2 ends after relu2_1]
    ("features.7", 128, False),   # conv2_2
    ("features.10", 256, True),   # conv3_1 [slice 3 ends after relu3_1]
    ("features.12", 256, False),  # conv3_2
    ("features.14", 256, False),  # conv3_3
    ("features.16", 256, False),  # conv3_4
    ("features.19", 512, True),   # conv4_1 [slice 4 ends after relu4_1]
]
# index into _CONV_PLAN after whose relu a slice output is taken
_SLICE_AFTER = [0, 2, 4, 8]
SLICE_WEIGHTS = (1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def _random_params(seed: int = 0):
    """[(w (O, I, 3, 3), b (O,))] numpy float32, He-normal from ``seed``."""
    rng = np.random.RandomState(seed)
    params = []
    in_ch = 3
    for _, out_ch, _ in _CONV_PLAN:
        fan_in = in_ch * 9
        w = rng.normal(0, np.sqrt(2.0 / fan_in),
                       (out_ch, in_ch, 3, 3)).astype(np.float32)
        params.append((w, np.zeros((out_ch,), np.float32)))
        in_ch = out_ch
    return params


def load_vgg19_params(weights_path: Optional[str] = None):
    """([(w, b)] numpy, pretrained): the state dict at ``weights_path`` if
    it exists, else ``_random_params()``."""
    if weights_path and os.path.exists(weights_path):
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        params = []
        for name, out_ch, _ in _CONV_PLAN:
            w = sd[f"{name}.weight"].numpy().astype(np.float32)
            if w.shape[0] != out_ch:
                raise ValueError(f"{name}.weight has {w.shape[0]} output "
                                 f"channels, VGG19 has {out_ch}")
            params.append((w, sd[f"{name}.bias"].numpy().astype(np.float32)))
        return params, True
    return _random_params(), False


class VGGLoss(nn.Module):
    """The perceptual loss; its weights are buffers, never trained."""

    def __init__(self, weights_path: Optional[str] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        params, self.pretrained = load_vgg19_params(weights_path)
        self.compute_dtype = (getattr(torch, compute_dtype) if compute_dtype
                              else None)
        for i, (w, b) in enumerate(params):
            self.register_buffer(f"w{i}", torch.from_numpy(w))
            self.register_buffer(f"b{i}", torch.from_numpy(b))
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN)
                             .reshape(1, 3, 1, 1))
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD)
                             .reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) in [0, 1] -> the 4 slice activations."""
        h = (x - self.mean) / self.std
        dt = self.compute_dtype
        if dt is not None:
            h = h.to(dt)
        outs = []
        for i, (_, _, pool) in enumerate(_CONV_PLAN):
            if pool:
                h = F.max_pool2d(h, 2, 2)
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            if dt is None:
                h = F.relu(F.conv2d(h, w, b, padding=1))
            else:
                h = F.relu(F.conv2d(h, w.to(dt), padding=1)
                           + b.to(dt)[:, None, None])
            if i in _SLICE_AFTER:
                outs.append(h)
        return outs

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y (B, 3, H, W) in [0, 1]; y is the target, detached."""
        fx = self.features(x)
        with torch.no_grad():
            fy = self.features(y.detach())
        loss = torch.zeros((), device=x.device)
        for wgt, a, b in zip(SLICE_WEIGHTS, fx, fy):
            # float32 whatever the compute dtype
            loss = loss + wgt * abs_ref(a.float() - b.float()).mean()
        return loss
