"""One-shot hand-avatar model (a frozen copy of the program's
``models/one_shot.py``: ``features``, ``static_features`` and ``__call__``,
eval mode).

  camera feats = MLP(25 -> 768)([K_normed.flat, c2w.flat])
  pose feats   = MLP(96 -> 768)(two-hand MANO pose)
  uv           = packed-atlas UVs normalised to [-1, 1]; id_vert = the
                 identity-code plane sampled at uv                     (33)
  enc_texture  = LocalPoolPointnet([uv, PE(uv), id_vert])              (53)
  enc_shade    = LocalPoolPointnet([uv, PE(uv), xyz, PE(xyz), mask,
                                    pose feats, camera feats])         (1587)
  tokens       = backbone(tokenizer_texture(enc_texture))
                 + backbone_shade(tokenizer_shade(enc_shade));
                 detokenize; upsample; the two planes side by side;
                 + map_bias                                  -> scene codes
  additional   = MLPBlock(852 -> 51)([uv, PE(uv), xyz, PE(xyz), mask,
                                      id_vert, pose feats])
  hidden       = scene codes sampled at uv (80) ++ additional (51) = 131,
                 then the interaction self-attention on interacting points
  render       = GSRenderer: 2N slots, appearance residuals, views

The frame embeddings and the shade branch depend on no per-identity
parameter: ``static_features`` computes them once for a one-shot fit and
``features`` reuses them from ``batch["static_feats"]``. The model runs in
eval semantics (no dropout), as the JAX fit step applies it.

The identity plane is ``identity_code_one_shot``, or with
``identity_from_book=i`` the codebook's entry i; with ``infer_identity``
the ``identity_code_infer`` head adds a code inferred from k =
``identity_infer_tokens`` points (indices arange(k) * N // k) to it as a
per-channel bias. The head is built always (the JAX model creates its
parameters only when initialised with the flag) and trains with the
identity codes. ``edit`` (``render/renderer.py::EditConfig``) reaches the
renderer's appearance residuals.

Parameters carry the reference ``state_dict`` names, so
``compat/from_jax.py`` and a reference checkpoint both load by key. They
are float32 whatever ``compute_dtype`` says. With ``compute_dtype=
"bfloat16"`` the frozen feature pipeline computes in bf16, as the JAX
package's: the embedders, the pointnets, the upsampler, both backbones, the
additional-features FC and the interaction attention; ``hidden`` is cast
back to float32, and the renderer heads, the appearance residuals, the
losses and the rasterizer stay float32. With None it all runs in float32;
on the card the caller turns TF32 off (``no_tf32``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from benchmark.reference.nn.heads import (AdditionalFeaturesFC,
                                             IdentityCodeInfer)
from benchmark.reference.nn.mlp import MLP, init_default_, normal_
from benchmark.reference.nn.pointnet import LocalPoolPointnet
from benchmark.reference.nn.spatial import pe_dim, positional_encoding
from benchmark.reference.nn.tokenizers import (
    TriplaneLearnablePositionalEmbedding, TriplaneUpsampler)
from benchmark.reference.nn.transformer import Transformer1D
from benchmark.reference.ops.grid_sample import grid_sample_batched
from benchmark.reference.render.renderer import (EditConfig, GSRenderer,
                                                   RendererConfig)


@dataclasses.dataclass(frozen=True)
class OneShotConfig:
    camera_embed_dim: int = 768
    pose_embed_dim: int = 768
    pe_levels: int = 4
    plane_size: int = 32
    token_channels: int = 512
    n_plane: int = 2
    backbone_layers: int = 10
    backbone_heads: int = 8
    backbone_head_dim: int = 64
    scene_code_channels: int = 80
    identity_channels: int = 33
    identity_book_size: int = 27
    residual_map_hw: tuple = (1024, 2048)
    additional_feature_dim: int = 51
    # the points the identity-code inference head reads
    identity_infer_tokens: int = 256
    # stored and read nowhere, as in the JAX package: the synthetic batch's
    # interaction mask takes k = min(100, N // 4) and threshold 10
    interaction_k: int = 100
    interaction_threshold: int = 10
    # static budget of the interaction attention (SelfAttn.cap): the first
    # max(128, cap) interacting points attend, the rest pass through and are
    # counted as interaction_overflow; None attends over all of them
    interaction_cap: Optional[int] = None
    # The JAX package's interaction-attention keys, accepted so that its
    # configs load, with no effect here:
    # - attn_dropout: active in JAX only with train=True, and nothing calls
    #   the port's model in training mode;
    # - attn_dense: JAX's materialised (N, N) route gives in eval mode the
    #   attention that SelfAttn's one route computes, at O(N^2) memory;
    # - attn_chunk: JAX's query/key chunk; the port's query chunk changes
    #   no row's softmax, and the flash kernels take their own tiles.
    attn_dropout: float = 0.1
    attn_dense: bool = False
    attn_chunk: int = 1024
    # store color_b as the rgb triple the renderer reads (3, Hm, Wm)
    # instead of the reference's 48 channels; renders are the same
    narrow_color_b: bool = False
    # "bfloat16" runs the frozen feature pipeline in bf16 (parameters stay
    # float32); None or "float32" runs everything in float32
    compute_dtype: Optional[str] = None
    # under bf16, the backbones' attention softmax and AV product in float32
    # (True) or in bf16 (False)
    backbone_softmax_fp32: bool = True
    # recompute the backbones' attention cores in the backward instead of
    # keeping their probabilities (the same function to the bit)
    backbone_attn_remat: bool = False
    # the JAX package's lax.scan over the backbone blocks, an XLA compile
    # knob: accepted so that its configs load, with no effect here
    backbone_scan: bool = False
    renderer: RendererConfig = RendererConfig()


COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": "lowp"}


def compute_dtype_of(cfg: OneShotConfig) -> Optional[torch.dtype]:
    """The torch type the feature pipeline computes in under ``cfg``: None
    for float32, else ``torch.bfloat16``; other names raise."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one of "
                         f"{sorted(k for k in COMPUTE_DTYPES if k)} or None")
    return COMPUTE_DTYPES[cfg.compute_dtype]


class OneShotAvatarModel(nn.Module):
    def __init__(self, cfg: OneShotConfig = OneShotConfig()):
        super().__init__()
        self.cfg = c = cfg
        dt = compute_dtype_of(c)
        s = c.plane_size
        uv_dim = 2 + pe_dim(2, c.pe_levels)
        xyz_dim = 3 + pe_dim(3, c.pe_levels)
        self.camera_embedder = MLP(25, c.camera_embed_dim, c.camera_embed_dim,
                                   n_hidden_layers=1, activation="silu",
                                   compute_dtype=dt)
        self.pose_embedder = MLP(96, c.pose_embed_dim, c.pose_embed_dim,
                                 n_hidden_layers=1, activation="silu",
                                 compute_dtype=dt)
        self.point_encoder_texture = LocalPoolPointnet(
            uv_dim + c.identity_channels, c_dim=c.token_channels, plane_size=s,
            compute_dtype=dt)
        self.point_encoder_shade = LocalPoolPointnet(
            uv_dim + xyz_dim + 1 + c.pose_embed_dim + c.camera_embed_dim,
            c_dim=c.token_channels, plane_size=s, compute_dtype=dt)
        self.tokenizer_texture = TriplaneLearnablePositionalEmbedding(
            s, c.token_channels, c.n_plane)
        self.tokenizer_shade = TriplaneLearnablePositionalEmbedding(
            s, c.token_channels, c.n_plane)
        backbone = dict(compute_dtype=dt, softmax_fp32=c.backbone_softmax_fp32,
                        attn_remat=c.backbone_attn_remat)
        self.backbone = Transformer1D(c.token_channels, c.backbone_layers,
                                      c.backbone_heads, c.backbone_head_dim,
                                      **backbone)
        self.backbone_shade = Transformer1D(
            c.token_channels, c.backbone_layers, c.backbone_heads,
            c.backbone_head_dim, **backbone)
        self.post_processor_texture = TriplaneUpsampler(
            c.token_channels, c.scene_code_channels, compute_dtype=dt)
        self.additional_features_fc = AdditionalFeaturesFC(
            uv_dim + xyz_dim + 1 + c.identity_channels + c.pose_embed_dim,
            c.additional_feature_dim, compute_dtype=dt)
        self.renderer = GSRenderer(c.renderer,
                                   interaction_cap=c.interaction_cap,
                                   compute_dtype=dt)
        self.identity_code_infer = IdentityCodeInfer(
            xyz_dim + c.pose_embed_dim, c.identity_channels,
            c.identity_infer_tokens)

        mh, mw = c.residual_map_hw
        zeros = torch.zeros
        self.identity_code_one_shot = nn.Parameter(
            zeros(1, c.identity_channels, 2 * s, 4 * s))
        self.identity_code_book = nn.Parameter(
            zeros(c.identity_book_size, c.identity_channels, 2 * s, 4 * s))
        self.map_bias = nn.Parameter(zeros(c.scene_code_channels, 2 * s, 4 * s))
        self.color_w = nn.Parameter(torch.ones(48))
        self.color_b = nn.Parameter(zeros(3 if c.narrow_color_b else 48, mh, mw))
        self.xyz_b = nn.Parameter(zeros(3))
        self.xyz_b_map = nn.Parameter(zeros(3, mh, mw))
        self.opacity_b = nn.Parameter(zeros(1, mh, mw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX model's schemes: default layers by
        fan-in, the tokenizer embeddings, the reference GSLayer heads, the
        clipped identity code book; the other per-identity maps 0 and
        color_w 1. The identity-code head is drawn last, so the other
        parameters take the same values from a seed with or without it."""
        head = self.identity_code_infer
        for child in self.children():
            if child is not head:
                init_default_(child, generator)
        self.tokenizer_texture.reset_parameters(generator)
        self.tokenizer_shade.reset_parameters(generator)
        self.renderer.gs_net.reset_parameters()
        with torch.no_grad():
            normal_(self.identity_code_book, 0.02, generator)
            self.identity_code_book.clamp_(-1.0, 1.0)
            for p in (self.identity_code_one_shot, self.map_bias, self.color_b,
                      self.xyz_b, self.xyz_b_map, self.opacity_b):
                p.zero_()
            self.color_w.fill_(1.0)
        init_default_(head, generator)

    def scene_codes(self, uv_n, uv_pe, id_vert, tokens_shade):
        """The (B, C80, 2S, 4S) scene-code plane."""
        s2 = 2 * self.cfg.plane_size
        cond_tex = self.point_encoder_texture(
            torch.cat([uv_n, uv_pe, id_vert], dim=-1))
        tokens = self.backbone(self.tokenizer_texture(cond_tex)) + tokens_shade
        planes = self.post_processor_texture(
            self.tokenizer_texture.detokenize(tokens))
        codes = torch.cat([planes[:, 0], planes[:, 1]], dim=-1)
        mb = torch.cat([self.map_bias[..., :s2], self.map_bias[..., :s2]],
                       dim=-1)
        return codes + mb[None]

    def _frame_embeds(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The per-frame embeddings: camera and pose MLPs and the
        positional encodings, functions of the batch and frozen weights."""
        c = self.cfg
        points = batch["points"]
        b = points.shape[0]
        camera_feats = self.camera_embedder(torch.cat(
            [batch["intrinsic_normed"].reshape(b, -1),
             batch["c2w"].reshape(b, -1)], dim=-1))
        pose_feats = self.pose_embedder(batch["mano_pose"].reshape(b, -1))
        uv = batch["vert_uv"]
        uv_n = torch.stack([2.0 * uv[..., 0] - 1.0,
                            2.0 * (uv[..., 1] / 0.5) - 1.0], dim=-1)
        return {"camera_feats": camera_feats, "pose_feats": pose_feats,
                "uv_n": uv_n, "uv_pe": positional_encoding(uv_n, c.pe_levels),
                "xyz_pe": positional_encoding(points, c.pe_levels)}

    def _shade_tokens(self, batch: Dict[str, Any], emb: Dict[str, Any]):
        """The shade branch: pointnet -> tokenizer -> 10-layer backbone."""
        points = batch["points"]
        b, n, _ = points.shape
        inter = batch["inter_mask"].to(torch.float32)[..., None]
        pose_b = emb["pose_feats"][:, None].expand(b, n, -1)
        cam_b = emb["camera_feats"][:, None].expand(b, n, -1)
        shade_in = torch.cat([emb["uv_n"], emb["uv_pe"], points,
                              emb["xyz_pe"], inter, pose_b, cam_b],
                             dim=-1)                            # (B, N, 1587)
        return self.backbone_shade(
            self.tokenizer_shade(self.point_encoder_shade(shade_in)))

    def static_features(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The fit-constant prefix of ``features``: the frame embeddings and
        the whole shade branch. No per-identity parameter sits upstream of
        it, and a one-shot fit refits one constant frame, so it is computed
        once per fit; ``features`` reuses it from ``batch["static_feats"]``.
        Valid only for the frame inputs and frozen weights it was computed
        from."""
        with torch.no_grad():
            emb = self._frame_embeds(batch)
            return {**emb, "tokens_shade": self._shade_tokens(batch, emb)}

    def features(self, batch: Dict[str, Any],
                 identity_from_book: Optional[int] = None,
                 infer_identity: bool = False) -> Dict[str, Any]:
        """The pre-render feature pipeline; ``hidden`` is (B, N, 131). With
        ``batch["static_feats"]`` (``static_features``) the frame embeddings
        and the shade branch are taken from it, detached. The identity plane
        is the codebook's entry ``identity_from_book`` when given, and with
        ``infer_identity`` the inferred code is added to it per channel."""
        points = batch["points"]
        b, n, _ = points.shape
        static = batch.get("static_feats")
        if static is not None:
            emb = {k: v.detach() for k, v in static.items()}
            tokens_shade = emb["tokens_shade"]
        else:
            emb = self._frame_embeds(batch)
            tokens_shade = self._shade_tokens(batch, emb)
        uv_n, uv_pe, xyz_pe = emb["uv_n"], emb["uv_pe"], emb["xyz_pe"]
        camera_feats, pose_feats = emb["camera_feats"], emb["pose_feats"]

        id_plane = self.identity_code_one_shot
        if identity_from_book is not None:
            id_plane = self.identity_code_book[identity_from_book][None]
        id_plane = id_plane.expand(b, *id_plane.shape[1:])
        if infer_identity:
            k = self.cfg.identity_infer_tokens
            sel = torch.arange(k, device=points.device) * n // k
            code = self.identity_code_infer(torch.cat(
                [points[:, sel], xyz_pe[:, sel],
                 pose_feats.float()[:, None].expand(b, k, -1)], dim=-1))
            id_plane = id_plane + code[:, :, None, None]
        id_vert = grid_sample_batched(id_plane, uv_n)          # (B, N, 33)
        codes = self.scene_codes(uv_n, uv_pe, id_vert, tokens_shade)
        inter = batch["inter_mask"].to(torch.float32)[..., None]
        pose_b = pose_feats[:, None].expand(b, n, pose_feats.shape[-1])
        additional = self.additional_features_fc(torch.cat(
            [uv_n, uv_pe, points, xyz_pe, inter, id_vert, pose_b], dim=-1))
        hidden = torch.cat([grid_sample_batched(codes, uv_n), additional],
                           dim=-1)                              # (B, N, 131)
        hidden, inter_overflow = self.renderer.self_attn_layer(
            hidden, mask=batch["inter_mask"], return_overflow=True)
        # everything downstream (the renderer heads, the appearance
        # residuals, the rasterizer) is float32 whatever the compute dtype
        hidden = hidden.float()
        return {"hidden": hidden, "codes": codes, "additional": additional,
                "camera_feats": camera_feats, "pose_feats": pose_feats,
                "id_vert": id_vert, "uv_n": uv_n, "points": points,
                # interacting points left out by interaction_cap (0 unless
                # the cap is below the interacting count)
                "interaction_overflow": inter_overflow}

    def forward(self, batch: Dict[str, Any], height: int, width: int,
                edit: EditConfig = EditConfig(),
                identity_from_book: Optional[int] = None,
                infer_identity: bool = False) -> Dict[str, Any]:
        """batch (batched over B): points (B, N, 3), points_tar (optional),
        vert_uv (B, N, 2), inter_mask (B, N) bool, mano_pose (B, 96),
        c2w (B, 4, 4), intrinsic_normed (B, 3, 3), w2c_render (B, V, 4, 4),
        K_render (B, V, 3/4, 3/4), background (B, 3) optional, the posed UV
        mesh tri_xyz (B, F, 3, 3) and tri_uv (B, F, 3, 2) optional (read by
        the renderer's ``exact_duplicate_uv``). ``edit`` goes to the
        renderer; ``identity_from_book`` and ``infer_identity`` to
        ``features``.

        Returns comp_rgb (B, V, H, W, 3), comp_mask (B, V, H, W), hidden,
        n_pairs (B,), overflow (B,), 3dgs (per-sample list), points and
        interaction_overflow."""
        points = batch["points"]
        b = points.shape[0]
        feats = self.features(batch, identity_from_book, infer_identity)
        hidden = feats["hidden"]
        query = batch.get("points_tar", points)
        background = batch.get("background")
        tri_xyz, tri_uv = batch.get("tri_xyz"), batch.get("tri_uv")
        outs = [self.renderer(
            hidden[i], query[i], batch["vert_uv"][i], batch["w2c_render"][i],
            batch["K_render"][i], height=height, width=width,
            background=None if background is None else background[i],
            color_w=self.color_w, xyz_b=self.xyz_b, color_b_map=self.color_b,
            opacity_b_map=self.opacity_b, edit=edit,
            tri_xyz=None if tri_xyz is None else tri_xyz[i],
            tri_uv=None if tri_uv is None else tri_uv[i]) for i in range(b)]
        return {"comp_rgb": torch.stack([o["comp_rgb"] for o in outs]),
                "comp_mask": torch.stack([o["comp_mask"] for o in outs]),
                "hidden": hidden,
                "n_pairs": [o["n_pairs"] for o in outs],
                "work": [o["work"] for o in outs],
                "3dgs": [o["3dgs"] for o in outs],
                "points": points,
                "interaction_overflow": feats["interaction_overflow"]}


def build_model(cfg: OneShotConfig = OneShotConfig(), *, seed: int = 0,
                device: Optional[str] = None) -> OneShotAvatarModel:
    """A model in eval mode on ``device`` (default ``cuda``), initialised
    from ``seed`` with a generator on that device."""
    device = torch.device(device or "cuda")
    model = OneShotAvatarModel(cfg).to(device).eval()
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model
