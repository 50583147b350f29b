"""The one-shot avatar model on both sides: the program's built through its
own config loader, the reference's from the frozen copy, both given the
same seeded weights, and the seeded VGG19 of the fit's perceptual loss.

A configuration file of this model family holds ``experiment`` (the
program's config keys, nested as its YAML files nest them), ``env`` (the
program's environment switches), ``scene`` and ``init`` (the weight rules
of ``harness/weights.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import torch

from benchmark.harness import weights

STREAMS = {"model": 1, "vgg": 2}


def stream_seed(seed: int, stream: str) -> int:
    """A seed of its own for each thing drawn from the run's seed."""
    return (seed * 0x9E3779B1 + STREAMS[stream]) % (1 << 62)


def np_seed(seed: int) -> int:
    """The run's seed as numpy's RandomState takes it (below 2**32)."""
    return seed % (1 << 32)


def _flatten(d: dict, prefix: str = "") -> List[str]:
    out = []
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out += _flatten(v, key + ".")
        else:
            out.append(f"{key}={json.dumps(v)}")
    return out


def set_env(config: dict) -> None:
    for k, v in config.get("env", {}).items():
        os.environ[k] = str(v)


def program_config(config: dict):
    """The program's ExperimentConfig, through its own loader."""
    from guassianhand_tpu_torch.config import load_config
    return load_config(None, _flatten(config["experiment"]))


def reference_configs(config: dict):
    """(OneShotConfig, FitConfig) of the reference copy."""
    from benchmark.reference.models.one_shot import OneShotConfig
    from benchmark.reference.ops.rasterize import RasterizeConfig
    from benchmark.reference.render.renderer import RendererConfig
    from benchmark.reference.train.fit import FitConfig
    from benchmark.reference.train.losses import LossWeights
    model = dict(config["experiment"]["model"])
    renderer = dict(model.pop("renderer", {}))
    raster = renderer.pop("raster", {})
    keep = {f.name for f in dataclasses.fields(RasterizeConfig)}
    model["residual_map_hw"] = tuple(model["residual_map_hw"])
    cfg = OneShotConfig(**model, renderer=RendererConfig(
        **renderer, raster=RasterizeConfig(
            **{k: v for k, v in raster.items() if k in keep})))
    fit = dict(config["experiment"].get("fit", {}))
    fit_cfg = FitConfig(
        lr=fit.get("lr", 0.01), steps_per_epoch=fit.get("steps_per_epoch", 50),
        milestones=tuple(fit.get("milestones", (2, 5, 10, 20, 35, 50, 75))),
        gamma=fit.get("gamma", 0.5),
        weights=LossWeights(**fit.get("weights", {})))
    return cfg, fit_cfg


def shapes(model: torch.nn.Module) -> List[Tuple[str, tuple]]:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def seeded_state(config: dict, names_shapes, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    return weights.draw(names_shapes, config["init"],
                        stream_seed(seed, "model"), device)


def load_state(model: torch.nn.Module, state: Dict[str, torch.Tensor]):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state[n])
    return model


def program_model(config: dict, seed: int, device):
    """The program's model in eval mode with the seeded weights."""
    from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
    cfg = program_config(config).model
    with torch.device(device):
        model = OneShotAvatarModel(cfg).eval()
    return load_state(model, seeded_state(config, shapes(model), seed,
                                          device))


def reference_model(config: dict, seed: int, device):
    from benchmark.reference.models.one_shot import OneShotAvatarModel
    cfg, _ = reference_configs(config)
    with torch.device(device):
        model = OneShotAvatarModel(cfg).eval()
    return load_state(model, seeded_state(config, shapes(model), seed,
                                          device))


def vgg_params(seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The VGG19 convolutions to relu4_1, He-normal from the seed."""
    from benchmark.reference.train.vgg import _CONV_PLAN
    shp, cin = [], 3
    for i, (_, cout, _) in enumerate(_CONV_PLAN):
        shp += [(f"w{i}", (cout, cin, 3, 3)), (f"b{i}", (cout,))]
        cin = cout
    rules = [{"match": r"^w", "std": 2.0 ** 0.5, "fan_in": "conv"},
             {"match": r"^b"}]
    d = weights.draw(shp, rules, stream_seed(seed, "vgg"), device)
    return [(d[f"w{i}"], d[f"b{i}"]) for i in range(len(_CONV_PLAN))]


def program_vgg(seed: int, device):
    """The program's VGG loss with the seeded convolutions."""
    from guassianhand_tpu_torch.train.vgg import VGGLoss
    vgg = VGGLoss().to(device)
    with torch.no_grad():
        for i, (w, b) in enumerate(vgg_params(seed, device)):
            getattr(vgg, f"w{i}").copy_(w)
            getattr(vgg, f"b{i}").copy_(b)
    return vgg


def reference_vgg(seed: int, device):
    from benchmark.reference.train.vgg import VGGLoss
    return VGGLoss(vgg_params(seed, device))


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref),
    for per-leaf norms; the median is over the leaves whose ref is not 0."""
    vals = sorted(v for v in ref.values() if v > 0)
    med = vals[len(vals) // 2] if vals else 0.0
    gaps = [abs(prog.get(k, 0.0) - r) / max(r, med, 1e-30)
            for k, r in ref.items()]
    return max(gaps) if gaps else 0.0
