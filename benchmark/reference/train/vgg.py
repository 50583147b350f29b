"""VGG19 perceptual loss over 4 feature slices: ImageNet normalisation,
features after relu1_1 / relu2_1 / relu3_1 / relu4_1, L1 distance with
weights [1/16, 1/8, 1/4, 1], the target branch detached. The weights are
given (the benchmark draws them from the seed); float32 throughout, as the
fit computes it.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.train.losses import abs_ref

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


class VGGLoss(nn.Module):
    """The perceptual loss; its weights are buffers, never trained."""

    def __init__(self, params):
        """``params``: [(w (O, I, 3, 3), b (O,))] tensors of ``_CONV_PLAN``'s
        convolutions."""
        super().__init__()
        self.compute_dtype = None
        for i, (w, b) in enumerate(params):
            self.register_buffer(f"w{i}", w.float())
            self.register_buffer(f"b{i}", b.float())
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN)
                             .reshape(1, 3, 1, 1).to(w.device))
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD)
                             .reshape(1, 3, 1, 1).to(w.device))

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
