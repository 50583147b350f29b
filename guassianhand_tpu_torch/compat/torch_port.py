"""Port the reference's torch checkpoint into the port's state dict
(counterpart of ``compat/torch_port.py``; the name is kept so that a reader
finds the counterpart, though here it maps torch to torch).

The reference loads ``pretrain_model.ckpt`` with ``strict=False``. The
port's modules carry the reference's ``state_dict`` names, so
``port_reference_checkpoint`` strips a leading ``model.`` (Lightning's
prefix), reshapes the identity codes from the reference's
(*, 1, C, H, W) to the port's (*, C, H, W), and keeps every key whose name
the port's model carries; the rest it reports as unmapped:

- ``pointcloud_generator.*`` (375 keys in the published checkpoint): the
  point-cloud generator, which no run path of either package reads; the
  JAX package maps it into a tree of its own, the port waits for
  ``models/point_generator.py`` (ROADMAP Queue A item 12);
- ``post_processor.*``: an upsampler of the reference that no forward
  reads (the JAX converter maps it into a subtree its model does not have,
  which ``merge_ported`` then skips).

Shapes are not checked here: ``train/checkpoints.load_params_partial``
keeps the model's value where a shape disagrees, and reconciles
``color_b``'s 48 and 3 channel layouts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from guassianhand_tpu_torch.models.one_shot import (OneShotAvatarModel,
                                                    OneShotConfig)

IDENTITY_CODES = ("identity_code_book", "identity_code_one_shot")


def port_state_dict_names(backbone_layers: int = 10) -> set:
    """The names of the port model's state dict with ``backbone_layers``
    blocks a backbone (the names depend on nothing else), from a model on
    the meta device: nothing is allocated."""
    with torch.device("meta"):
        model = OneShotAvatarModel(OneShotConfig(
            backbone_layers=backbone_layers))
    return set(model.state_dict())


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
