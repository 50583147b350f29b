"""Port the reference's torch checkpoint into the port's state dict
(counterpart of ``compat/torch_port.py``; the name is kept so that a reader
finds the counterpart, though here it maps torch to torch).

The reference loads ``pretrain_model.ckpt`` with ``strict=False``. The
port's modules carry the reference's ``state_dict`` names, so
``port_reference_checkpoint`` strips a leading ``model.`` (Lightning's
prefix), reshapes the identity codes from the reference's
(*, 1, C, H, W) to the port's (*, C, H, W), and keeps every key whose name
one of the port's modules carries:

- the avatar model's (``models/one_shot.OneShotAvatarModel``);
- ``pointcloud_generator.*`` (375 keys in the published checkpoint): the
  point-cloud generator's (``models/point_generator.SimplePointGenerator``),
  which no run path of the avatar reads; ``load_point_generator`` loads
  them into one;
- ``post_processor.*``: the reference's second triplane upsampler
  (``nn/tokenizers.TriplaneUpsampler``), which no forward reads.

The rest it reports as unmapped. Loaded into the avatar model, the last two
groups are reported as absent from it, as the JAX package's
``merge_ported`` reports them. ``port_dinov2_backbone`` maps a Hugging Face
``facebook/dinov2-base`` state dict into the generator's image tokenizer.

Shapes are not checked here: ``train/checkpoints.load_params_partial``
keeps the model's value where a shape disagrees, and reconciles
``color_b``'s 48 and 3 channel layouts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from guassianhand_tpu_torch.models.one_shot import (OneShotAvatarModel,
                                                    OneShotConfig)
from guassianhand_tpu_torch.models.point_generator import SimplePointGenerator
from guassianhand_tpu_torch.nn.image_tokenizer import ImageTokenizer
from guassianhand_tpu_torch.nn.tokenizers import TriplaneUpsampler
from guassianhand_tpu_torch.train.checkpoints import load_params_partial

IDENTITY_CODES = ("identity_code_book", "identity_code_one_shot")
GENERATOR = "pointcloud_generator."
# the Hugging Face DINOv2 key with no counterpart on the inference path
DINOV2_IGNORED = ("embeddings.mask_token",)


def _names(module: torch.nn.Module, prefix: str = "") -> set:
    return {prefix + k for k in module.state_dict()}


def port_state_dict_names(backbone_layers: int = 10) -> set:
    """The names a reference checkpoint maps to: the avatar model's with
    ``backbone_layers`` blocks a backbone, the point-cloud generator's under
    ``pointcloud_generator.`` and the second upsampler's under
    ``post_processor.``. The models are built on the meta device: nothing
    is allocated."""
    with torch.device("meta"):
        return (_names(OneShotAvatarModel(OneShotConfig(
                    backbone_layers=backbone_layers)))
                | _names(SimplePointGenerator(), GENERATOR)
                | _names(TriplaneUpsampler(), "post_processor."))


def port_reference_checkpoint(state_dict: Dict[str, Any],
                              backbone_layers: int = 10
                              ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference ``state_dict`` (with or without the ``model.`` prefix;
    tensors or arrays) -> (the port's state dict of the keys it carries,
    the sorted unmapped source keys, prefix stripped)."""
    names = port_state_dict_names(backbone_layers)
    ported, unmapped = {}, []
    for key, value in state_dict.items():
        key = key.removeprefix("model.")
        if key not in names:
            unmapped.append(key)
            continue
        value = torch.as_tensor(value)
        if key in IDENTITY_CODES and value.ndim == 5:
            value = value.reshape(value.shape[0], *value.shape[-3:])
        ported[key] = value
    return ported, sorted(unmapped)


def port_dinov2_backbone(state_dict: Dict[str, Any], num_layers: int = 12
                         ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A Hugging Face ``Dinov2Model`` state dict (keys with or without
    ``dinov2.``) -> (the image tokenizer's state dict of its ViT, under
    ``model.``; the sorted unmapped keys). The port's ViT carries the
    Hugging Face names, so the map is by name; ``embeddings.mask_token`` is
    dropped, as the JAX package drops it."""
    with torch.device("meta"):
        names = _names(ImageTokenizer(layers=num_layers).model)
    ported, unmapped = {}, []
    for key, value in state_dict.items():
        key = key.removeprefix("dinov2.")
        if key in DINOV2_IGNORED:
            continue
        if key not in names:
            unmapped.append(key)
            continue
        ported[f"model.{key}"] = torch.as_tensor(value)
    return ported, sorted(unmapped)


def load_point_generator(path: str, device: str = "cuda",
                         **generator_kw) -> SimplePointGenerator:
    """A ``SimplePointGenerator(**generator_kw)`` in eval mode on
    ``device``, with the ``pointcloud_generator.*`` tensors of the port's
    checkpoint at ``path`` (``cli/port_checkpoint.py``'s output, with the
    DINOv2 weights where it was given ``--dinov2``) loaded partially
    (``load_params_partial``, which prints ``restored N/M``)."""
    generator = SimplePointGenerator(**generator_kw)
    load_params_partial(path, generator, prefix=GENERATOR)
    return generator.to(device).eval()
