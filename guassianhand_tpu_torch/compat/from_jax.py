"""Load the JAX model's parameters into the port's modules.

``load_jax_params(module, params)`` takes a flax ``params`` tree (nested
dicts of numpy arrays, with or without the outer ``"params"`` key) for the
JAX counterpart of ``module`` and loads it by the port's ``state_dict``
keys, which are the reference torch names. The conversions:

- Dense kernel (in, out) -> Linear weight (out, in); bias as is;
- LayerNorm / GroupNorm scale -> weight;
- ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight
  (in, out, kh, kw) with the spatial taps flipped (the two libraries'
  transposed convolutions are mirror images; without the flip every
  upsampled 2x2 block comes out transposed);
- per-identity maps and tokenizer embeddings as they are;
- the JAX model keeps ``self_attn_layer`` at its top level, the reference
  (and the port) under ``renderer``;
- ``identity_code_infer`` exists in a JAX tree only when the model was
  initialised with ``infer_identity=True``; the port's head is always
  there, and keeps its own values where the tree has none;
- the point-cloud generator: kernel-1 convolutions take the Dense kernel
  as (out, in, 1[, 1]), the frozen BatchNorms' scale, bias, mean and var
  their weight, bias and running statistics, the patch embedding's HWIO
  kernel OIHW, the learned point tokens an ``Embedding``'s weight, and
  ``uppers_i`` and ``layer_i`` their list index.

``load_jax_vgg`` loads the JAX ``VGGLoss``'s convolution weights (HWIO)
into the port's ``VGGLoss`` (OIHW buffers).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn as nn

from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from guassianhand_tpu_torch.models.point_generator import SimplePointGenerator
from guassianhand_tpu_torch.nn import snowflake as sf
from guassianhand_tpu_torch.nn.heads import (AdditionalFeaturesFC, GSLayer,
                                             IdentityCodeInfer, SelfAttn,
                                             VertPosRefinement, VertValid)
from guassianhand_tpu_torch.nn.image_tokenizer import ImageTokenizer
from guassianhand_tpu_torch.nn.mlp import (MLP, MLPBlock, MLPResBlock,
                                           ResnetBlockFC)
from guassianhand_tpu_torch.nn.pointnet import LocalPoolPointnet
from guassianhand_tpu_torch.nn.tokenizers import (
    TriplaneLearnablePositionalEmbedding, TriplaneUpsampler)
from guassianhand_tpu_torch.nn.transformer import (AdaLayerNormContinuous,
                                                   Attention, Transformer1D,
                                                   TransformerBlock)
from guassianhand_tpu_torch.render.renderer import GSRenderer
from guassianhand_tpu_torch.train.vgg import VGGLoss

Tree = Dict[str, Any]

PER_IDENTITY = ("identity_code_book", "identity_code_one_shot", "map_bias",
                "color_w", "color_b", "xyz_b", "xyz_b_map", "opacity_b")


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _under(prefix: str, sd: Tree) -> Tree:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _linear(p: Tree) -> Tree:
    out = {"weight": _np(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def _norm(p: Tree) -> Tree:
    return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}


def _mlp(m: MLP, p: Tree) -> Tree:
    n_dense = sum(isinstance(x, nn.Linear) for x in m.layers)
    sd = {}
    for i in range(n_dense):
        sd.update(_under(f"layers.{2 * i}", _linear(p[f"Dense_{i}"])))
    return sd


def _mlp_block(m, p: Tree) -> Tree:
    return {**_under("layer_norm", _norm(p["LayerNorm_0"])),
            **_under("fc1", _linear(p["Dense_0"])),
            **_under("fc2", _linear(p["Dense_1"]))}


def _resnet_fc(m: ResnetBlockFC, p: Tree) -> Tree:
    sd = {**_under("fc_0", _linear(p["Dense_0"])),
          **_under("fc_1", _linear(p["Dense_1"]))}
    if m.shortcut is not None:
        sd.update(_under("shortcut", _linear(p["Dense_2"])))
    return sd


def _pointnet(m: LocalPoolPointnet, p: Tree) -> Tree:
    sd = {**_under("fc_pos", _linear(p["Dense_0"])),
          **_under("fc_c", _linear(p["Dense_1"]))}
    for i, block in enumerate(m.blocks):
        sd.update(_under(f"blocks.{i}", _resnet_fc(block, p[f"block_{i}"])))
    return sd


def _tokenizer(m, p: Tree) -> Tree:
    return {"embeddings": _np(p["embeddings"])}


def _upsampler(m: TriplaneUpsampler, p: Tree) -> Tree:
    k = _np(p["ConvTranspose_0"]["kernel"])             # (kh, kw, in, out)
    return {"upsample.weight": np.ascontiguousarray(
                k[::-1, ::-1].transpose(2, 3, 0, 1)),
            "upsample.bias": _np(p["ConvTranspose_0"]["bias"])}


def _attention(m: Attention, p: Tree) -> Tree:
    return {"to_q.weight": _np(p["Dense_0"]["kernel"]).T,
            "to_k.weight": _np(p["Dense_1"]["kernel"]).T,
            "to_v.weight": _np(p["Dense_2"]["kernel"]).T,
            **_under("to_out.0", _linear(p["Dense_3"]))}


def _ada_norm(m: AdaLayerNormContinuous, p: Tree) -> Tree:
    return {**_under("linear1", _linear(p["Dense_0"])),
            **_under("linear2", _linear(p["Dense_1"]))}


def _transformer_block(m: TransformerBlock, p: Tree) -> Tree:
    norm = _ada_norm if m.modulated else (lambda _, q: _norm(q))
    return {**_under("norm1", norm(m.norm1, p["norm1"])),
            **_under("attn1", _attention(m.attn1, p["attn1"])),
            **_under("norm2", norm(m.norm2, p["norm2"])),
            **_under("attn2", _attention(m.attn2, p["attn2"])),
            **_under("norm3", norm(m.norm3, p["norm3"])),
            **_under("ff.net.0.proj", _linear(p["ff"]["GEGLU_0"]["Dense_0"])),
            **_under("ff.net.2", _linear(p["ff"]["Dense_0"]))}


def _transformer1d(m: Transformer1D, p: Tree) -> Tree:
    sd = {**_under("norm", _norm(p["GroupNorm_0"])),
          **_under("proj_in", _linear(p["Dense_0"])),
          **_under("proj_out", _linear(p["Dense_1"]))}
    for i, block in enumerate(m.transformer_blocks):
        sd.update(_under(f"transformer_blocks.{i}",
                         _transformer_block(block, p[f"block_{i}"])))
    return sd


def _gs_layer(m: GSLayer, p: Tree) -> Tree:
    names = ("xyz", "scaling", "rotation", "opacity", "shs")
    sd = {}
    for i, name in enumerate(names):
        sd.update(_under(f"out_layers.{i}", _linear(p[name])))
    return sd


def _valid_head(m, p: Tree) -> Tree:
    return {**_under("ff", _mlp_block(m.ff, p["MLPBlock_0"])),
            **_under("fc", _linear(p["Dense_0"]))}


def _additional(m: AdditionalFeaturesFC, p: Tree) -> Tree:
    return _under("ff1", _mlp_block(m.ff1, p["MLPBlock_0"]))


def _self_attn(m: SelfAttn, p: Tree) -> Tree:
    return {**_under("layer_norm", _norm(p["LayerNorm_0"])),
            **_under("w_qs", _linear(p["Dense_0"])),
            **_under("w_ks", _linear(p["Dense_1"])),
            **_under("w_vs", _linear(p["Dense_2"])),
            **_under("fc", _linear(p["Dense_3"])),
            **_under("ff", _mlp_block(m.ff, p["MLPResBlock_0"]))}


def _identity_code_infer(m: IdentityCodeInfer, p: Tree) -> Tree:
    return {**_under("fc", _linear(p["Dense_0"])),
            **_under("layer_norm", _norm(p["LayerNorm_0"])),
            **_under("fc_out", _linear(p["Dense_1"]))}


def identity_code_infer_to_jax(m: IdentityCodeInfer) -> Tree:
    """The head's flax params (the inverse of the mapping above)."""
    def dense(lin):
        return {"kernel": lin.weight.detach().cpu().numpy().T,
                "bias": lin.bias.detach().cpu().numpy()}
    return {"Dense_0": dense(m.fc), "Dense_1": dense(m.fc_out),
            "LayerNorm_0": {"scale": m.layer_norm.weight.detach().cpu().numpy(),
                            "bias": m.layer_norm.bias.detach().cpu().numpy()}}


def _renderer(m: GSRenderer, p: Tree) -> Tree:
    sd = {**_under("mlp_net", _mlp(m.mlp_net, p["mlp_net"])),
          **_under("gs_net", _gs_layer(m.gs_net, p["gs_net"])),
          **_under("gs_valid", _valid_head(m.gs_valid, p["gs_valid"])),
          **_under("vert_pos_refinement",
                   _valid_head(m.vert_pos_refinement,
                               p["vert_pos_refinement"]))}
    if "self_attn_layer" in p:
        sd.update(_under("self_attn_layer",
                         _self_attn(m.self_attn_layer, p["self_attn_layer"])))
    return sd


def _point_conv(p: Tree, ndim: int = 1) -> Tree:
    """Dense -> kernel-1 Conv1d (ndim 1) or Conv2d (ndim 2)."""
    sd = _linear(p)
    sd["weight"] = sd["weight"].reshape(sd["weight"].shape + (1,) * ndim)
    return sd


def _batch_norm(p: Tree) -> Tree:
    return {"weight": _np(p["scale"]), "bias": _np(p["bias"]),
            "running_mean": _np(p["mean"]), "running_var": _np(p["var"]),
            "num_batches_tracked": np.array(0, np.int64)}


def _mlp_conv(m: sf.MLPConv, p: Tree) -> Tree:
    n = sum(isinstance(x, sf.PointConv) for x in m.mlp)
    sd = {}
    for i in range(n):
        sd.update(_under(f"mlp.{2 * i}", _point_conv(p[f"Dense_{i}"])))
    return sd


def _mlp_res(m: sf.MLPRes, p: Tree) -> Tree:
    sd = {}
    for k in ("conv_1", "conv_2", "conv_shortcut"):
        sd.update(_under(k, _point_conv(p[k])))
    return sd


def _conv_bn_conv(m: sf.ConvBNConv, p: Tree) -> Tree:
    return {**_under("0", _point_conv(p["fc1"], 2)),
            **_under("1", _batch_norm(p["bn"])),
            **_under("3", _point_conv(p["fc2"], 2))}


def _skip_transformer(m: sf.SkipTransformer, p: Tree) -> Tree:
    sd = {**_under("mlp_v", _mlp_res(m.mlp_v, p["mlp_v"])),
          **_under("pos_mlp", _conv_bn_conv(m.pos_mlp, p["pos_mlp"])),
          **_under("attn_mlp", _conv_bn_conv(m.attn_mlp, p["attn_mlp"]))}
    for k in ("conv_key", "conv_query", "conv_value", "conv_end"):
        sd.update(_under(k, _point_conv(p[k])))
    return sd


def _cross_attn(m: sf.ResidualCrossAttn, p: Tree) -> Tree:
    sd = {**_under("norm", _norm(p["norm"])),
          **_under("norm2", _norm(p["norm2"]))}
    for k in ("to_q", "to_k", "to_v", "to_out", "ff1", "ff2"):
        sd.update(_under(k, _linear(p[k])))
    return sd


def _spd(m: nn.Module, p: Tree) -> Tree:
    """SPDpp, SPD or SPDCrossAttn."""
    sd = {"ps.weight": _np(p["ps"]["kernel"]),
          **_under("skip_transformer",
                   _skip_transformer(m.skip_transformer,
                                     p["skip_transformer"])),
          **_under("mlp_delta_feature",
                   _mlp_res(m.mlp_delta_feature, p["mlp_delta_feature"]))}
    for k in ("mlp_1", "mlp_2", "mlp_ps", "mlp_delta"):
        sd.update(_under(k, _mlp_conv(getattr(m, k), p[k])))
    if isinstance(m, sf.SPDCrossAttn):
        sd.update(_under("cross_attn", _cross_attn(m.cross_attn,
                                                   p["cross_attn"])))
    return sd


def _snowflake_decoder(m: sf.SnowflakeDecoder, p: Tree) -> Tree:
    sd = _under("mlp_feat_cond", _mlp_conv(m.mlp_feat_cond,
                                           p["mlp_feat_cond"]))
    for i, upper in enumerate(m.uppers):
        sd.update(_under(f"uppers.{i}", _spd(upper, p[f"uppers_{i}"])))
    return sd


def _pointnet2(m: nn.Module, p: Tree) -> Tree:
    """PointNetSAModuleKNN or PointNetFPModule: conv{i}, bn{i}."""
    sd = {}
    for i in range(m.n_layers):
        sd.update(_under(f"conv{i}", _point_conv(p[f"conv{i}"], 2)))
        if f"bn{i}" in p:
            sd.update(_under(f"bn{i}", _batch_norm(p[f"bn{i}"])))
    return sd


def _image_tokenizer(m: ImageTokenizer, p: Tree) -> Tree:
    """The JAX tree of a tokenizer initialised without a condition has no
    modulations; the port's keep their values then."""
    k = _np(p["patch_embed"]["kernel"])                  # (kh, kw, in, out)
    sd = {"model.embeddings.cls_token": _np(p["cls_token"]),
          "model.embeddings.position_embeddings": _np(p["pos_embed"]),
          "model.embeddings.patch_embeddings.projection.weight":
              np.ascontiguousarray(k.transpose(3, 2, 0, 1)),
          "model.embeddings.patch_embeddings.projection.bias":
              _np(p["patch_embed"]["bias"]),
          **_under("model.layernorm", _norm(p["layernorm"]))}
    for i in range(len(m.model.encoder.layer)):
        q = p[f"layer_{i}"]
        a = q["attention"]
        sd.update(_under(f"model.encoder.layer.{i}", {
            **_under("norm1", _norm(q["norm1"])),
            **_under("norm2", _norm(q["norm2"])),
            **_under("attention.attention.query", _linear(a["query"])),
            **_under("attention.attention.key", _linear(a["key"])),
            **_under("attention.attention.value", _linear(a["value"])),
            **_under("attention.output.dense", _linear(a["dense"])),
            "layer_scale1.lambda1": _np(q["layer_scale1"]["lambda1"]),
            "layer_scale2.lambda1": _np(q["layer_scale2"]["lambda1"]),
            **_under("mlp.fc1", _linear(q["fc1"])),
            **_under("mlp.fc2", _linear(q["fc2"]))}))
        for j, norm in enumerate(("norm1", "norm2")):
            mod = q.get(f"{norm}_modulation")
            sd.update(_under(f"modulations.{2 * i + j}.linear2", _linear(
                mod["linear2"]) if mod is not None else {
                    k: v.detach().cpu().numpy() for k, v in
                    m.modulations[2 * i + j].linear2.state_dict().items()}))
    return sd


def _point_generator(m: SimplePointGenerator, p: Tree) -> Tree:
    return {
        **_under("camera_embedder", _mlp(m.camera_embedder,
                                         p["camera_embedder"])),
        **_under("image_tokenizer", _image_tokenizer(m.image_tokenizer,
                                                     p["image_tokenizer"])),
        "tokenizer.pcl_embeddings.weight":
            _np(p["tokenizer"]["pcl_embeddings"]),
        **_under("backbone", _transformer1d(m.backbone, p["backbone"])),
        **_under("post_processor.point_layer",
                 _linear(p["post_processor"]["point_layer"])),
        **_under("pointcloud_upsampling.decoder", _snowflake_decoder(
            m.pointcloud_upsampling["decoder"], p["pointcloud_upsampling"]))}


def _model(m: OneShotAvatarModel, p: Tree) -> Tree:
    sd = {k: _np(p[k]) for k in PER_IDENTITY}
    for name, fn in (("camera_embedder", _mlp), ("pose_embedder", _mlp),
                     ("point_encoder_texture", _pointnet),
                     ("point_encoder_shade", _pointnet),
                     ("tokenizer_texture", _tokenizer),
                     ("tokenizer_shade", _tokenizer),
                     ("backbone", _transformer1d),
                     ("backbone_shade", _transformer1d),
                     ("post_processor_texture", _upsampler),
                     ("additional_features_fc", _additional)):
        sd.update(_under(name, fn(getattr(m, name), p[name])))
    renderer = {**p["renderer"], "self_attn_layer": p["self_attn_layer"]}
    sd.update(_under("renderer", _renderer(m.renderer, renderer)))
    head = m.identity_code_infer
    sd.update(_under("identity_code_infer",
                     _identity_code_infer(head, p["identity_code_infer"])
                     if "identity_code_infer" in p else
                     {k: v.detach().cpu().numpy()
                      for k, v in head.state_dict().items()}))
    return sd


_CONVERTERS: Dict[type, Callable[[nn.Module, Tree], Tree]] = {
    OneShotAvatarModel: _model, GSRenderer: _renderer, MLP: _mlp,
    MLPBlock: _mlp_block, MLPResBlock: _mlp_block,
    ResnetBlockFC: _resnet_fc, LocalPoolPointnet: _pointnet,
    TriplaneLearnablePositionalEmbedding: _tokenizer,
    TriplaneUpsampler: _upsampler, Attention: _attention,
    TransformerBlock: _transformer_block, Transformer1D: _transformer1d,
    GSLayer: _gs_layer, VertValid: _valid_head,
    VertPosRefinement: _valid_head, AdditionalFeaturesFC: _additional,
    SelfAttn: _self_attn, IdentityCodeInfer: _identity_code_infer,
    SimplePointGenerator: _point_generator, ImageTokenizer: _image_tokenizer,
    sf.SnowflakeDecoder: _snowflake_decoder, sf.SPDpp: _spd, sf.SPD: _spd,
    sf.SPDCrossAttn: _spd, sf.SkipTransformer: _skip_transformer,
    sf.PointNetSAModuleKNN: _pointnet2, sf.PointNetFPModule: _pointnet2,
}


def state_dict_from_jax(module: nn.Module, params: Tree) -> Dict[str, np.ndarray]:
    """The port ``state_dict`` (numpy values) for ``module`` from the flax
    params of its JAX counterpart."""
    if "params" in params:
        params = params["params"]
    try:
        convert = _CONVERTERS[type(module)]
    except KeyError:
        raise TypeError(f"no JAX parameter mapping for {type(module).__name__}")
    return convert(module, params)


def load_jax_params(module: nn.Module, params: Tree, strict: bool = True):
    """Load flax ``params`` into ``module`` in place. Returns
    ``load_state_dict``'s (missing_keys, unexpected_keys)."""
    ref = module.state_dict()
    sd = {}
    for k, v in state_dict_from_jax(module, params).items():
        if k in ref and tuple(ref[k].shape) != v.shape:
            raise ValueError(f"{k}: JAX shape {v.shape} vs port "
                             f"{tuple(ref[k].shape)}")
        sd[k] = torch.as_tensor(np.ascontiguousarray(v))
    return module.load_state_dict(sd, strict=strict)


def load_jax_vgg(module: VGGLoss, params) -> None:
    """Load the JAX ``VGGLoss.params`` [(w (3, 3, I, O), b (O,))] into
    ``module`` in place."""
    if len(params) != sum(1 for k in module.state_dict() if k[0] == "w"):
        raise ValueError(f"{len(params)} convolutions given")
    with torch.no_grad():
        for i, (w, b) in enumerate(params):
            w = torch.as_tensor(np.ascontiguousarray(
                _np(w).transpose(3, 2, 0, 1)))
            target = getattr(module, f"w{i}")
            if w.shape != target.shape:
                raise ValueError(f"conv {i}: JAX shape {tuple(w.shape)} vs "
                                 f"port {tuple(target.shape)}")
            target.copy_(w)
            getattr(module, f"b{i}").copy_(torch.as_tensor(np.array(_np(b))))
