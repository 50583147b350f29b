"""The DINOv2 image tokenizer with camera modulation (counterpart of
``nn/image_tokenizer.py``): a ViT-B/14 (768 wide, 12 layers, 12 heads)
whose two post-norm activations in each layer are scaled and shifted by a
camera embedding (``Modulation``).

Names: the ViT is ``model``, in the Hugging Face ``Dinov2Model`` state
dict's names (``embeddings.*``, ``encoder.layer.{i}.*``, ``layernorm.*``),
so ``compat/torch_port.port_dinov2_backbone`` fills it from a
``facebook/dinov2-base`` state dict (the reference loads it at build time;
it is not in the reference checkpoint). The modulations are
``modulations.{2i, 2i + 1}.linear2``, as the reference checkpoint stores
them.

As the JAX package computes it: the patch embedding pads ``SAME`` (flax
``nn.Conv``: nothing at 224 or 252, but a size that 14 does not divide is
padded on both sides); the position embeddings are resized from the
native 16 x 16 grid as ``jax.image.resize(..., "bicubic")`` resizes (Keys'
cubic with a = -0.5, the weights renormalised at the edges and, when the
grid shrinks, widened to low-pass: ``resize``); the LayerNorms use eps
1e-6 and the MLP the exact (erf) GELU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from guassianhand_tpu_torch.nn.mlp import LN_EPS

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x
                   + f(2.0), out)
    return np.where(x >= 2, f(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize`` along one axis
    (``scale_and_translate`` with antialiasing, in float32 as it computes
    them): output j samples input position (j + 0.5) n_in / n_out - 0.5."""
    f = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * f(inv_scale) - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) \
        / kernel_scale
    w = _KERNELS[method](x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= f(-0.5)) & (sample <= f(n_in - 0.5))
    return np.where(inside[None, :], w, f(0.0)).astype(np.float32)


def resize(x: torch.Tensor, height: int, width: int,
           method: str = "bilinear") -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) as ``jax.image.resize(x, (B,
    height, width, C), method)`` (``"bilinear"`` or ``"bicubic"``)."""
    h, w = x.shape[1:3]
    if (h, w) == (height, width):
        return x
    wh = torch.from_numpy(resize_weights(h, height, method)).to(x.device)
    ww = torch.from_numpy(resize_weights(w, width, method)).to(x.device)
    return torch.einsum("bhwc,hy,wx->byxc", x, wh, ww)


class Modulation(nn.Module):
    """x * (1 + scale) + shift, (scale, shift) = linear2(silu(cond));
    zero-initialised, so that the backbone starts unmodulated."""

    def __init__(self, embed_dim: int, cond_dim: int):
        super().__init__()
        self.linear2 = nn.Linear(cond_dim, embed_dim * 2)
        nn.init.zeros_(self.linear2.weight)
        nn.init.zeros_(self.linear2.bias)

    def forward(self, x, cond):
        scale, shift = self.linear2(F.silu(cond)).chunk(2, dim=-1)
        return x * (1 + scale[:, None, :]) + shift[:, None, :]


class Dinov2PatchEmbeddings(nn.Module):
    def __init__(self, width: int, patch: int):
        super().__init__()
        self.projection = nn.Conv2d(3, width, patch, stride=patch)


class Dinov2Embeddings(nn.Module):
    def __init__(self, width: int, patch: int, native_grid: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, 1 + native_grid ** 2, width))
        self.patch_embeddings = Dinov2PatchEmbeddings(width, patch)
        self.patch, self.native_grid = patch, native_grid

    def forward(self, images):
        """images (B, H, W, 3), normalised -> (B, 1 + gh * gw, width)."""
        p = self.patch
        x = images.permute(0, 3, 1, 2)
        pads = []
        for n in (x.shape[3], x.shape[2]):          # F.pad: last axis first
            total = max((-(-n // p) - 1) * p + p - n, 0)
            pads += [total // 2, total - total // 2]
        x = self.patch_embeddings.projection(F.pad(x, pads))
        b, width, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, 1, width), x], dim=1)
        pos = self.position_embeddings
        g0 = self.native_grid
        if (gh, gw) != (g0, g0):
            grid = resize(pos[:, 1:].reshape(1, g0, g0, width), gh, gw,
                          "bicubic")
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, width)], 1)
        return x + pos


class Dinov2SelfAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)


class Dinov2SelfOutput(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.dense = nn.Linear(width, width)


class Dinov2Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = Dinov2SelfAttention(width)
        self.output = Dinov2SelfOutput(width)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        a = self.attention

        def split(t):
            return t.reshape(b, n, self.heads, hd)

        q, k, v = split(a.query(x)), split(a.key(x)), split(a.value(x))
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                            / (hd ** 0.5), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, n, c)
        return self.output.dense(o)


class LayerScale(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(width))

    def forward(self, x):
        return x * self.lambda1


class Dinov2MLP(nn.Module):
    def __init__(self, width: int, ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(width, width * ratio)
        self.fc2 = nn.Linear(width * ratio, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Dinov2Layer(nn.Module):
    """Pre-LN attention and MLP with layer scales; each norm's output
    modulated by the condition where one is given."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attention = Dinov2Attention(width, heads)
        self.layer_scale1 = LayerScale(width)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = Dinov2MLP(width)
        self.layer_scale2 = LayerScale(width)

    def forward(self, x, mod1=None, mod2=None, cond=None):
        h = self.norm1(x)
        if cond is not None:
            h = mod1(h, cond)
        x = x + self.layer_scale1(self.attention(h))
        h = self.norm2(x)
        if cond is not None:
            h = mod2(h, cond)
        return x + self.layer_scale2(self.mlp(h))


class Dinov2Encoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.layer = nn.ModuleList(Dinov2Layer(width, heads)
                                   for _ in range(layers))


class Dinov2Model(nn.Module):
    """The ViT, under the Hugging Face ``Dinov2Model``'s names."""

    def __init__(self, width: int, layers: int, heads: int, patch: int,
                 native_grid: int):
        super().__init__()
        self.embeddings = Dinov2Embeddings(width, patch, native_grid)
        self.encoder = Dinov2Encoder(width, layers, heads)
        self.layernorm = nn.LayerNorm(width, eps=LN_EPS)


class ImageTokenizer(nn.Module):
    """DINOv2 with camera modulation: images (B, H, W, 3) in [0, 1] and a
    condition (B, cond_dim) -> tokens (B, 1 + patches, width), the CLS
    token first."""

    def __init__(self, patch_size: int = 14, width: int = 768,
                 layers: int = 12, heads: int = 12, native_grid: int = 16,
                 cond_dim: int = 768):
        super().__init__()
        self.model = Dinov2Model(width, layers, heads, patch_size,
                                 native_grid)
        self.modulations = nn.ModuleList(Modulation(width, cond_dim)
                                         for _ in range(2 * layers))

    def forward(self, images, modulation_cond: Optional[torch.Tensor] = None):
        mean = images.new_tensor(IMAGE_MEAN)
        std = images.new_tensor(IMAGE_STD)
        x = self.model.embeddings((images - mean) / std)
        for i, layer in enumerate(self.model.encoder.layer):
            x = layer(x, self.modulations[2 * i], self.modulations[2 * i + 1],
                      modulation_cond)
        return self.model.layernorm(x)
