"""Basic MLP blocks (a frozen copy of the program's ``nn/mlp.py``), with
the reference's module names so a reference ``state_dict`` loads by key:

- ``MLP``: ``layers.{0,2,...}`` Linear with activations between;
- ``MLPBlock``: ``layer_norm`` -> ``fc1`` -> relu -> ``fc2``;
- ``MLPResBlock``: x + fc2(relu(fc1(layer_norm(x))));
- ``ResnetBlockFC``: ``fc_0``, ``fc_1`` and a bias-free ``shortcut``.

``compute_dtype`` on each block is the JAX package's flax ``dtype``: None
computes in float32; ``torch.bfloat16`` runs the block's layers in bf16
(``Linear``) while its parameters stay float32, so checkpoints and
``compat/from_jax.py`` do not depend on it. The LayerNorms of ``MLPBlock``
and ``MLPResBlock`` take no compute dtype, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import lowp

# flax's LayerNorm epsilon, used by every norm of the JAX model
LN_EPS = 1e-6

_ACT = {"relu": nn.ReLU, "silu": nn.SiLU}


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense(dtype=...)``'s compute type: with a
    ``compute_dtype`` the input and the float32 weight and bias are cast to
    it at the call, the product is taken in it (accumulated in float32 and
    rounded once) and the bias is added in it. None is ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = lowp(x) @ lowp(self.weight).t()
        return lowp(y if self.bias is None else y + lowp(self.bias))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax ``LayerNorm(dtype=...)``'s compute type:
    the statistics, the normalisation and the affine map in float32, the
    result cast to ``compute_dtype`` once. None is ``nn.LayerNorm``."""

    def __init__(self, dim: int, eps: float = LN_EPS,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return lowp(super().forward(x.float()))


class MLP(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, n_neurons: int,
                 n_hidden_layers: int, activation: str = "relu",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        layers = [Linear(dim_in, n_neurons, compute_dtype=dt),
                  _ACT[activation]()]
        for _ in range(n_hidden_layers - 1):
            layers += [Linear(n_neurons, n_neurons, compute_dtype=dt),
                       _ACT[activation]()]
        layers.append(Linear(n_neurons, dim_out, compute_dtype=dt))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class MLPBlock(nn.Module):
    def __init__(self, dim_in: int, hid_dim: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(dim_in, eps=LN_EPS)
        self.fc1 = Linear(dim_in, hid_dim, compute_dtype=compute_dtype)
        self.fc2 = Linear(hid_dim, hid_dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(self.layer_norm(x))))


class MLPResBlock(nn.Module):
    def __init__(self, dim: int, hid_dim: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = Linear(dim, hid_dim, compute_dtype=compute_dtype)
        self.fc2 = Linear(hid_dim, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(self.layer_norm(x))))


class ResnetBlockFC(nn.Module):
    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        dt = compute_dtype
        self.fc_0 = Linear(size_in, size_h, compute_dtype=dt)
        self.fc_1 = Linear(size_h, size_out, compute_dtype=dt)
        self.shortcut = (Linear(size_in, size_out, bias=False,
                                compute_dtype=dt)
                         if size_in != size_out else None)

    def forward(self, x):
        net = self.fc_0(F.relu(x))
        dx = self.fc_1(F.relu(net))
        xs = x if self.shortcut is None else self.shortcut(x)
        return xs + dx


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=t.dtype) * std)


def init_default_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX model's default scales: Linear and
    ConvTranspose weights normal with std 1/sqrt(fan_in) (flax's
    lecun_normal scale), biases 0, norms scale 1 and bias 0. Heads with a
    special init reset themselves after this (see ``nn/heads.py``)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, 1.0 / math.sqrt(m.in_features), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.ConvTranspose2d):
            # flax ConvTranspose fan_in: kh * kw * in_channels
            kh, kw = m.kernel_size
            normal_(m.weight, 1.0 / math.sqrt(kh * kw * m.in_channels),
                    generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
