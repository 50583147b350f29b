"""Experiment configs (counterpart of ``config.py``): dataclasses, YAML
files that may inherit through ``extends:``, and ``key.sub=value``
command-line overrides.

``yaml`` is imported only when a YAML path is given, so a run configured by
overrides alone needs no YAML package. The run's merged config is written
as JSON. Every key of the repo's configs loads, with the JAX package's
value (every leaf of the JAX package's config tree); unknown keys raise.
Not every key has an effect: the synthetic scene reads none of
``DataConfig``'s InterHand2.6M paths and flags (the InterHand2.6M path,
``data/interhand.py``, reads them all); the keys that choose only a TPU
layout, an order of summation or a route to the same result
(``RasterizeConfig``'s ``opacity_cull``, tile, cap and segment-sum keys,
``RendererConfig.multiview_batched``, ``OneShotConfig``'s
``backbone_scan`` and ``attn_*``), ``FitConfig.freeze_base_gradients`` and
``LossWeights.l1_top`` / ``l1_top_ratio`` are stored with no effect (each
documented there). The
``edit`` section is the renderer's ``EditConfig``: the fit CLI does not
read it, as in the JAX package, and the edit CLI (``cli/edit.py``) takes
its flags from its command line, as the JAX one does.
``model.compute_dtype`` takes effect: the entry points print the type the
feature pipeline computes in, and the snapshot records it as
``compute_dtype_effective``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Dict, List, Optional

from guassianhand_tpu_torch.models.one_shot import (OneShotConfig,
                                                    compute_dtype_of)
from guassianhand_tpu_torch.render.renderer import EditConfig
from guassianhand_tpu_torch.train.fit import FitConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"          # "synthetic" | "interhand"
    height: int = 256
    width: int = 256
    edge_subdivide: int = 2
    # the InterHand2.6M layout (data/interhand.py)
    data_root: str = "./processed_dataset"
    annot_path: str = "./InterHand2.6M/annotations"
    mano_models_path: Optional[str] = None
    mano_uv_path: Optional[str] = None
    # the test sequence --run_val scores: oneshot_reg_i / oneshot_nv / ...
    pose_sequence: Optional[str] = None
    mask_sa: bool = True
    render_mask: bool = True
    color_jitter: bool = False
    use_native_loader: bool = True
    # the InterHand2.6M edit fit's fixed frame and custom image
    edit: bool = False
    image_path: Optional[str] = None
    mask_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    expname: str = "one_shot"
    out_dir: str = "./EXPERIMENTS"
    seed: int = 0
    data: DataConfig = DataConfig()
    model: OneShotConfig = OneShotConfig()
    fit: FitConfig = FitConfig()
    edit: EditConfig = EditConfig()
    vgg_weights: Optional[str] = None
    # LPIPS AlexNet weights (train/lpips.py; $GH_LPIPS_WEIGHTS otherwise)
    lpips_weights: Optional[str] = None
    pretrained: Optional[str] = None
    resume: bool = True


def _from_dict(cls, d: Dict[str, Any]):
    """Build (possibly nested) dataclasses from plain dicts."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    names = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in names:
            raise KeyError(f"unknown config key '{k}' for {cls.__name__}")
        ftype = hints[k]
        args = typing.get_args(ftype)
        if typing.get_origin(ftype) is typing.Union and type(None) in args:
            ftype = next(a for a in args if a is not type(None))
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[k] = _from_dict(ftype, v)
        elif (ftype is tuple or typing.get_origin(ftype) is tuple) \
                and isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml_with_extends(path: str) -> Dict:
    import yaml
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    ext = d.pop("extends", None)
    if ext:
        d = _deep_merge(_load_yaml_with_extends(
            os.path.join(os.path.dirname(path), ext)), d)
    return d


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except ValueError:
        return s


def apply_overrides(d: Dict, overrides: List[str]) -> Dict:
    """Apply 'a.b.c=value' dotted overrides; values parse as JSON where
    they can, else stay strings."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not key=value")
        key, val = item.split("=", 1)
        parts = key.split(".")
        cur = d
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_value(val)
    return d


def load_config(path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> ExperimentConfig:
    d = _load_yaml_with_extends(path) if path else {}
    if overrides:
        d = apply_overrides(d, overrides)
    return _from_dict(ExperimentConfig, d)


def compute_dtype_effective(model: OneShotConfig) -> str:
    """The name of the type the model's feature pipeline computes in."""
    dt = compute_dtype_of(model)
    return "float32" if dt is None else str(dt).removeprefix("torch.")


def compute_dtype_line(model: OneShotConfig) -> str:
    """The one line an entry point prints about the type it computes in."""
    line = f"compute dtype: {compute_dtype_effective(model)}"
    if compute_dtype_of(model) is not None:
        line += (" (the feature pipeline; parameters, the renderer, the "
                 "losses and the rasterizer float32)")
    return line


def save_config_snapshot(cfg: ExperimentConfig, run_dir: str) -> str:
    """The merged config as JSON in the run directory, with the type the
    run computes in as ``compute_dtype_effective``."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config_snapshot.json")
    snap = dataclasses.asdict(cfg)
    snap["compute_dtype_effective"] = compute_dtype_effective(cfg.model)
    with open(path, "w") as f:
        json.dump(snap, f, indent=1)
    return path
