"""The floating-point operations a fit step or a drive request needs, as a
function of the configuration's widths and the inputs' sizes (a
multiply-add counts two).

The widths come from the parameter shapes of the reference model built
from the configuration (on the meta device: nothing is allocated), so the
count follows the configuration and not the program. What is counted:

- every dense layer: 2 * rows * in * out, with rows the points, the
  Gaussian slots or the tokens the layer sees;
- every attention core: q k^T and p v, 4 * rows * keys * width;
- the upsampler's transposed convolution, and VGG19's convolutions to
  relu4_1 at the target's size;
- the rasterizer's pair work: the operations the front-to-back rule needs
  at the inputs (``reference/ops/rasterize.py``'s work count).

A fit step's backward computes activation gradients only (the frozen
weights get none): once the forward's count for a dense layer or a
convolution, twice for an attention core (dq, dk, dv and dp). The shade
branch and the frame embeddings are cached for the fit and not counted
there; the VGG runs forward on the target, forward and backward on the
render.
"""
from __future__ import annotations

import json
import math
from typing import Dict

import torch

VGG_CONVS = [(3, 64, 0), (64, 64, 0), (64, 128, 1), (128, 128, 0),
             (128, 256, 1), (256, 256, 0), (256, 256, 0), (256, 256, 0),
             (256, 512, 1)]   # (in, out, pools before it)


_SHAPES: Dict[str, Dict[str, tuple]] = {}


def model_shapes(config: dict) -> Dict[str, tuple]:
    key = json.dumps(config["experiment"]["model"], sort_keys=True)
    if key not in _SHAPES:
        _SHAPES[key] = _model_shapes(config)
    return _SHAPES[key]


def _model_shapes(config: dict) -> Dict[str, tuple]:
    from benchmark.harness.oneshot import reference_configs
    from benchmark.reference.models.one_shot import OneShotAvatarModel
    cfg, _ = reference_configs(config)
    with torch.device("meta"):
        model = OneShotAvatarModel(cfg)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def dense(shapes: Dict[str, tuple], prefix: str, rows: int) -> int:
    """Every 2-D weight under ``prefix`` applied to ``rows`` rows."""
    return sum(2 * rows * s[0] * s[1] for n, s in shapes.items()
               if n.startswith(prefix) and n.endswith(".weight")
               and len(s) == 2)


def attention_core(rows: int, keys: int, width: int) -> int:
    return 4 * rows * keys * width


def backbone(shapes: Dict[str, tuple], prefix: str, tokens: int,
             heads: int, head_dim: int) -> Dict[str, int]:
    n_blocks = len({n.split(".")[2] for n in shapes
                    if n.startswith(prefix + ".transformer_blocks.")})
    core = 2 * n_blocks * attention_core(tokens, tokens, heads * head_dim)
    return {"dense": dense(shapes, prefix + ".", tokens), "core": core}


def upsampler(shapes: Dict[str, tuple], tokens: int) -> int:
    cin, cout, kh, kw = shapes["post_processor_texture.upsample.weight"]
    return 2 * tokens * cin * cout * kh * kw


def vgg19(height: int, width: int) -> int:
    total, h, w = 0, height, width
    for cin, cout, pools in VGG_CONVS:
        for _ in range(pools):
            h, w = h // 2, w // 2
        total += 2 * h * w * cin * cout * 9
    return total


def _parts(config: dict, n_points: int, n_live: int) -> Dict[str, int]:
    m = config["experiment"]["model"]
    shapes = model_shapes(config)
    tokens = m["n_plane"] * m["plane_size"] ** 2
    bb = dict(tokens=tokens, heads=m["backbone_heads"],
              head_dim=m["backbone_head_dim"])
    sa_width = shapes["renderer.self_attn_layer.w_qs.weight"][0]
    slots = 2 * n_points
    tex = backbone(shapes, "backbone", **bb)
    shade = backbone(shapes, "backbone_shade", **bb)
    return {
        "embedders": dense(shapes, "camera_embedder.", 1)
        + dense(shapes, "pose_embedder.", 1),
        "pointnet_texture": dense(shapes, "point_encoder_texture.", n_points),
        "pointnet_shade": dense(shapes, "point_encoder_shade.", n_points),
        "backbone_dense": tex["dense"], "backbone_core": tex["core"],
        "backbone_shade": shade["dense"] + shade["core"],
        "upsampler": upsampler(shapes, tokens),
        "additional": dense(shapes, "additional_features_fc.", n_points),
        "self_attn_dense": dense(shapes, "renderer.self_attn_layer.",
                                 n_points),
        "self_attn_core": attention_core(n_live, n_live, sa_width),
        "heads": dense(shapes, "renderer.mlp_net.", slots)
        + dense(shapes, "renderer.gs_net.", slots)
        + dense(shapes, "renderer.gs_valid.", n_points)
        + dense(shapes, "renderer.vert_pos_refinement.", n_points),
    }


def fit_step(config: dict, n_points: int, n_live: int, height: int,
             width: int, raster_forward_ops: int,
             raster_backward_ops: int) -> int:
    """One fit step with the shade branch cached: forward, activation
    gradients, the VGG terms and the rasterizer's pair work."""
    p = _parts(config, n_points, n_live)
    dense_fwd = (p["pointnet_texture"] + p["backbone_dense"] + p["upsampler"]
                 + p["additional"] + p["self_attn_dense"] + p["heads"])
    cores = p["backbone_core"] + p["self_attn_core"]
    return (2 * dense_fwd + 3 * cores + 3 * vgg19(height, width)
            + raster_forward_ops + raster_backward_ops)


def request(config: dict, n_points: int, n_live: int,
            raster_forward_ops: int) -> int:
    """One drive request's forward: every branch, and the render."""
    return sum(_parts(config, n_points, n_live).values()) + raster_forward_ops


def mfu_percent(flops: float, seconds: float, peak: float = 989e12) -> float:
    if not seconds or not math.isfinite(seconds):
        return float("nan")
    return 100.0 * flops / (seconds * peak)
