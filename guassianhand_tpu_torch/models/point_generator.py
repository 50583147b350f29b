"""The point-cloud generator (counterpart of ``models/point_generator.py``,
the reference's ``SimplePointGenerator``): learned point tokens, a
10-layer cross-attention backbone over DINOv2 tokens modulated by the
camera, a linear head to xyz, and the snowflake upsampler.

- ``SimplePointGenerator.forward`` is the one-shot contract: it bypasses
  generation and snowflake-upsamples the batch's points (farthest point
  sampling to ``num_pcl`` first), conditioned on the learned point tokens;
- ``generate`` runs the whole path from an image and a camera.

The submodules carry the reference checkpoint's names under
``pointcloud_generator.``: ``camera_embedder``, ``image_tokenizer``,
``tokenizer``, ``backbone``, ``post_processor``,
``pointcloud_upsampling.decoder``. The backbone's cross-attention and the
decoder's condition take the first 512 channels of the image tokens, as
the reference's parameter shapes fix them. A sample of the batch at a
time goes through the decoder (the JAX package's ``jax.vmap``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from guassianhand_tpu_torch.nn.image_tokenizer import ImageTokenizer, resize
from guassianhand_tpu_torch.nn.mlp import MLP, normal_
from guassianhand_tpu_torch.nn.snowflake import SnowflakeDecoder
from guassianhand_tpu_torch.nn.transformer import Transformer1D
from guassianhand_tpu_torch.ops.distance_transform import (
    mask_distance_channel)
from guassianhand_tpu_torch.ops.fps import fps_subsample

# the flattened c2w (16) and K (9) the camera embedder reads
CAMERA_DIM = 25


class PointLearnablePositionalEmbedding(nn.Module):
    """num_pcl x num_channels learned point tokens."""

    def __init__(self, num_pcl: int = 2048, num_channels: int = 512):
        super().__init__()
        self.pcl_embeddings = nn.Embedding(num_pcl, num_channels)

    def forward(self, batch_size: int) -> torch.Tensor:
        """-> (B, num_channels, num_pcl) channels-first."""
        emb = self.pcl_embeddings.weight.T[None]
        return emb.expand(batch_size, *emb.shape[1:])

    @staticmethod
    def detokenize(tokens: torch.Tensor) -> torch.Tensor:
        return tokens.transpose(1, 2)


class PointOutLayer(nn.Module):
    """A zero-initialised linear map to xyz."""

    def __init__(self, in_channels: int = 512):
        super().__init__()
        self.point_layer = nn.Linear(in_channels, 3)
        nn.init.zeros_(self.point_layer.weight)
        nn.init.zeros_(self.point_layer.bias)

    def forward(self, x):
        return self.point_layer(x)


class ImageFeature(nn.Module):
    """Per-pixel features: RGB (3), the patch tokens resized bilinearly to
    the image (768), the mask (1) and its distance channel (1), 773 in the
    reference's order, zero-padded or cut to ``out_dim``. rgb (B, H, W, 3),
    tokens (B, n, C) with or without a leading CLS token, mask (B, H, W)
    -> (B, H, W, out_dim)."""

    def __init__(self, out_dim: int = 773):
        super().__init__()
        self.out_dim = out_dim

    def forward(self, rgb, tokens, mask):
        b, h, w, _ = rgb.shape
        side = int(tokens.shape[1] ** 0.5)
        if side * side != tokens.shape[1]:
            tokens = tokens[:, 1:]                   # drop the CLS token
            side = int(tokens.shape[1] ** 0.5)
        tok = tokens[:, :side * side].reshape(b, side, side, -1)
        tok = resize(tok, h, w, "bilinear")
        feat = torch.cat([rgb, tok, mask[..., None],
                          mask_distance_channel(mask)[..., None]], dim=-1)
        if feat.shape[-1] < self.out_dim:
            feat = nn.functional.pad(feat, (0, self.out_dim - feat.shape[-1]))
        return feat[..., :self.out_dim]


class SimplePointGenerator(nn.Module):
    """DINOv2-conditioned point-token transformer and snowflake
    upsampling. ``tokenizer_kw`` sizes the image tokenizer (a ViT-B/14 by
    default, as the JAX package fixes it)."""

    def __init__(self, num_pcl: int = 2048, num_channels: int = 512,
                 backbone_layers: int = 10,
                 up_factors: Sequence[int] = (2, 4),
                 camera_embed_dim: int = 768, dim_feat: int = 128,
                 **tokenizer_kw):
        super().__init__()
        self.num_pcl, self.num_channels = num_pcl, num_channels
        self.camera_embedder = MLP(CAMERA_DIM, camera_embed_dim,
                                   camera_embed_dim, n_hidden_layers=1,
                                   activation="silu")
        self.image_tokenizer = ImageTokenizer(cond_dim=camera_embed_dim,
                                              **tokenizer_kw)
        self.tokenizer = PointLearnablePositionalEmbedding(num_pcl,
                                                           num_channels)
        self.backbone = Transformer1D(num_channels, backbone_layers, heads=8,
                                      head_dim=64, context_dim=num_channels)
        self.post_processor = PointOutLayer(num_channels)
        self.pointcloud_upsampling = nn.ModuleDict({"decoder": SnowflakeDecoder(
            up_factors=up_factors, input_channels=num_channels,
            dim_feat=dim_feat)})

    def upsample(self, points: torch.Tensor, cond: torch.Tensor,
                 use_fps: bool) -> torch.Tensor:
        """(B, N, 3) points, (B, M, num_channels) condition -> the
        decoder's points, a sample at a time; FPS to ``num_pcl`` first
        where N is larger."""
        decoder = self.pointcloud_upsampling["decoder"]
        out = []
        for p, c in zip(points, cond):
            if use_fps and p.shape[0] > self.num_pcl:
                p = fps_subsample(p, self.num_pcl)
            out.append(decoder(p, c)[0])
        return torch.stack(out)

    def generate(self, images, c2w_flat_K_flat, points=None,
                 use_fps: bool = True):
        """images (B, H, W, 3) in [0, 1], c2w_flat_K_flat (B, 25) -> the
        upsampled points (B, num_pcl * prod(up_factors), 3); ``points``
        (B, N, 3) in place of the generated ones."""
        cam = self.camera_embedder(c2w_flat_K_flat)
        img_tokens = self.image_tokenizer(images, modulation_cond=cam)
        tokens = self.backbone(self.tokenizer(images.shape[0]),
                               context=img_tokens[..., :self.num_channels])
        if points is None:
            points = self.post_processor(self.tokenizer.detokenize(tokens))
        return self.upsample(points, img_tokens[:, 1:, :self.num_channels],
                             use_fps)

    def forward(self, batch_points, cond_tokens: Optional[torch.Tensor] = None,
                use_fps: bool = True):
        """batch_points (B, N, 3); cond_tokens (B, M, num_channels), the
        learned point tokens when None -> (B, num_pcl * prod(up_factors),
        3) where N > num_pcl."""
        if cond_tokens is None:
            cond_tokens = self.tokenizer.detokenize(
                self.tokenizer(batch_points.shape[0]))
        return self.upsample(batch_points, cond_tokens, use_fps)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded weights with no zero leaf, as a trained checkpoint would
        carry them in place of the zero-initialised heads and modulations:
        matrix and convolution weights normal at 1/sqrt(fan-in), norm
        scales 1 + N(0, 0.1), variances in [0.5, 1.5], everything else
        N(0, 0.1). A CPU generator: build on the CPU, then move."""
        with torch.no_grad():
            for name, t in self.state_dict().items():
                if not t.is_floating_point():
                    continue
                if name.endswith("running_var"):
                    t.copy_(0.5 + torch.rand(t.shape, generator=generator))
                elif name.endswith("weight") and t.ndim >= 2:
                    normal_(t, float(t[0].numel()) ** -0.5, generator)
                elif name.endswith("weight"):
                    normal_(t, 0.1, generator)
                    t.add_(1.0)
                else:
                    normal_(t, 0.1, generator)
