"""Seeded weights for a set of named tensors, made on the device in one
draw.

One ``torch.randn`` call on the device's generator fills a flat buffer as
long as all the tensors together; each tensor takes its slice in the order
given and is scaled by the first rule whose ``match`` (a regular
expression, searched in the name) fits:

  value = mean + std * scale * z,   clipped to [-clip, clip] if ``clip``

where ``scale`` is 1 / sqrt(fan_in) with ``"fan_in": "linear"`` (the second
axis of an (out, in) weight), ``"conv_t"`` (in * kh * kw of a transposed
convolution's (in, out, kh, kw) weight), ``"conv"`` (in * kh * kw of an
(out, in, kh, kw) weight), and 1 otherwise; ``mean`` may be a list as long
as the tensor. Every name must meet a rule.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence, Tuple

import torch


def _fan_in(kind: str, shape: Sequence[int]) -> int:
    if kind == "linear":
        return shape[1]
    if kind == "conv_t":
        return shape[0] * math.prod(shape[2:])
    if kind == "conv":
        return math.prod(shape[1:])
    raise ValueError(f"fan_in {kind!r}")


def draw(shapes: List[Tuple[str, Sequence[int]]], rules: List[dict],
         seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``shapes`` [(name, shape)] under
    ``rules``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s in shapes)
    z = torch.randn(total, generator=gen, device=device)
    compiled = [(re.compile(r["match"]), r) for r in rules]
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        rule = next((r for pat, r in compiled if pat.search(name)), None)
        if rule is None:
            raise KeyError(f"no init rule matches {name}")
        scale = rule.get("std", 0.0)
        if "fan_in" in rule:
            scale /= math.sqrt(_fan_in(rule["fan_in"], shape))
        mean = rule.get("mean", 0.0)
        if isinstance(mean, list):
            mean = torch.tensor(mean, device=device).reshape(shape)
        t = z[at:at + n].reshape(shape) * scale + mean
        if "clip" in rule:
            t = t.clamp(-rule["clip"], rule["clip"])
        out[name] = t
        at += n
    return out
