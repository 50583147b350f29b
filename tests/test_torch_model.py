"""The PyTorch port's network modules and the whole one-shot model held
against the JAX package on the CPU.

Every test makes its inputs and the module's parameters with numpy from a
seed, with no zero leaf (zero-initialised heads and maps would otherwise
hide mapping bugs), carries the parameters across with
``compat/from_jax.load_jax_params`` and compares the outputs. The whole
model starts from its own init schemes, with seeded noise on every leaf.

Tolerances: module outputs at atol 2e-5 / rtol 1e-5, the fp32 rounding of
matmuls and reductions that XLA and PyTorch order differently; the whole
model at atol 1e-4 (hidden features pass two stacked transformers and an
attention, where those differences compound; the renders stay near 1e-6).
"""
import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.compat.torch_port import (merge_ported,
                                                port_reference_checkpoint)
from guassianhand_tpu.models.one_shot import OneShotAvatarModel as JModel
from guassianhand_tpu.nn import heads as jheads
from guassianhand_tpu.nn import mlp as jmlp
from guassianhand_tpu.nn import pointnet as jpointnet
from guassianhand_tpu.nn import tokenizers as jtok
from guassianhand_tpu.nn import transformer as jtr
from guassianhand_tpu.nn.spatial import positional_encoding as j_pe
from guassianhand_tpu.ops.blockwise_attention import blockwise_attention as j_attn
from guassianhand_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample
from guassianhand_tpu.render.renderer import GSRenderer as JRenderer
from guassianhand_tpu_torch.compat.from_jax import load_jax_params
from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene as TScene
from guassianhand_tpu_torch.data.synthetic import synthetic_batch as t_batch
from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from guassianhand_tpu_torch.nn import heads, mlp, pointnet, tokenizers
from guassianhand_tpu_torch.nn import transformer
from guassianhand_tpu_torch.nn.spatial import positional_encoding
from guassianhand_tpu_torch.ops.blockwise_attention import blockwise_attention
from guassianhand_tpu_torch.ops.common import TILE
from guassianhand_tpu_torch.ops.grid_sample import grid_sample_2d
from guassianhand_tpu_torch.ops.rasterize import render_gaussians
from guassianhand_tpu_torch.render.renderer import GSRenderer
from tests.test_model import HW, TINY
from tests.torch_parity import (batch_to_torch, perturb, port_model_config,
                                random_params, to_numpy_tree, to_torch)

# TINY with JAX raster caps wide enough that no pair is dropped (overflow 0)
JTINY = dataclasses.replace(TINY, renderer=dataclasses.replace(
    TINY.renderer, raster=dataclasses.replace(
        TINY.renderer.raster, max_tiles_per_gaussian=32,
        pairs_per_gaussian=16.0)))
ATOL, RTOL = 2e-5, 1e-5
MODEL_ATOL, MODEL_RTOL = 1e-4, 1e-4
REPO = Path(__file__).resolve().parents[1]


def close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def carried(flax_module, torch_module, *args, seed=0, **kw):
    """Seeded numpy parameters in the layout of ``flax_module``'s params
    (no zero leaf), loaded into ``torch_module``; returns them."""
    shapes = jax.eval_shape(functools.partial(flax_module.init, **kw),
                            jax.random.PRNGKey(0), *args)
    params = random_params(shapes, seed)
    load_jax_params(torch_module, params)
    return params


def japply(flax_module, params, *args, **kw):
    """``flax_module.apply`` compiled: eager flax dispatch is slower."""
    return jax.jit(functools.partial(flax_module.apply, **kw))(params, *args)


def randn(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# --- module groups -----------------------------------------------------

@pytest.mark.parametrize("activation", ["silu", "relu"])
def test_mlp(activation):
    rng = np.random.RandomState(0)
    x = randn(rng, 5, 25)
    jm = jmlp.MLP(dim_out=12, n_neurons=32, n_hidden_layers=2,
                  activation=activation)
    tm = mlp.MLP(25, 12, 32, n_hidden_layers=2, activation=activation)
    p = carried(jm, tm, x)
    close(tm(to_torch(x)), japply(jm, p, x))


def test_mlp_blocks():
    rng = np.random.RandomState(1)
    x = randn(rng, 7, 20)
    jb, tb = jmlp.MLPBlock(hid_dim=9), mlp.MLPBlock(20, 9)
    p = carried(jb, tb, x)
    close(tb(to_torch(x)), japply(jb, p, x))
    jr, tr = jmlp.MLPResBlock(hid_dim=11), mlp.MLPResBlock(20, 11)
    p = carried(jr, tr, x)
    close(tr(to_torch(x)), japply(jr, p, x))


def test_positional_encoding():
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (4, 6, 3)).astype(np.float32)
    close(positional_encoding(to_torch(x), 4), j_pe(jnp.asarray(x), 4),
          atol=1e-6, rtol=1e-6)


def test_local_pool_pointnet():
    """Coordinates reach the clip at +-(radius - 1e-6) and leave cells of
    the 4x4 grid empty (pooled to 0)."""
    rng = np.random.RandomState(3)
    p = randn(rng, 2, 40, 7)
    p[:, :, :2] = rng.uniform(-1.2, 0.3, (2, 40, 2))
    jm = jpointnet.LocalPoolPointnet(c_dim=16, plane_size=4)
    tm = pointnet.LocalPoolPointnet(7, c_dim=16, plane_size=4)
    params = carried(jm, tm, p)
    close(tm(to_torch(p)), japply(jm, params, p))


def test_triplane_tokenizer_and_upsampler():
    rng = np.random.RandomState(4)
    cond = randn(rng, 2, 8, 4, 4)
    jt = jtok.TriplaneLearnablePositionalEmbedding(plane_size=4,
                                                   num_channels=8, n_plane=2)
    tt = tokenizers.TriplaneLearnablePositionalEmbedding(4, 8, 2)
    pt = carried(jt, tt, cond)
    tokens = tt(to_torch(cond))
    close(tokens, japply(jt, pt, cond))
    planes = randn(rng, 2, 2, 8, 4, 4)
    close(tt.detokenize(to_torch(planes.reshape(2, 8, 32))),
          japply(jt, pt, planes.reshape(2, 8, 32), method="detokenize"))
    ju, tu = jtok.TriplaneUpsampler(out_channels=5), \
        tokenizers.TriplaneUpsampler(8, 5)
    pu = carried(ju, tu, planes)
    close(tu(to_torch(planes)), japply(ju, pu, planes))


def test_transformer1d():
    rng = np.random.RandomState(5)
    tokens = randn(rng, 2, 64, 32)
    jm = jtr.Transformer1D(num_layers=2, heads=2, head_dim=16)
    tm = transformer.Transformer1D(64, num_layers=2, heads=2, head_dim=16)
    p = carried(jm, tm, tokens)
    close(tm(to_torch(tokens)), japply(jm, p, tokens), atol=5e-5)


def test_grid_sample_matches_at_borders():
    """Interior, edge and out-of-range coordinates: the JAX sampler clamps
    indices and weights, which zero-padded F.grid_sample does not."""
    rng = np.random.RandomState(6)
    feat = randn(rng, 5, 7, 9)
    uv = rng.uniform(-1.3, 1.3, (200, 2)).astype(np.float32)
    uv[:4] = [[-1, -1], [1, 1], [1, -1], [-1, 1]]
    close(grid_sample_2d(to_torch(feat), to_torch(uv)),
          jax.jit(j_grid_sample)(jnp.asarray(feat), jnp.asarray(uv)),
          atol=1e-6)


def test_blockwise_attention_masked():
    rng = np.random.RandomState(7)
    q, k, v = (randn(rng, 300, 4, 8) for _ in range(3))
    mask = rng.uniform(size=300) > 0.4
    want = j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(mask), q_chunk=128, k_chunk=128)
    got = blockwise_attention(to_torch(q), to_torch(k), to_torch(v),
                              to_torch(mask), q_chunk=128)
    close(got, want)
    assert float(got[torch.from_numpy(~mask)].abs().max()) == 0.0


@pytest.mark.parametrize("use_rgb", [True, False])
def test_gs_layer(use_rgb):
    rng = np.random.RandomState(8)
    x, pts = randn(rng, 30, 16), randn(rng, 30, 3, scale=0.1)
    jm = jheads.GSLayer(sh_degree=1, use_rgb=use_rgb)
    tm = heads.GSLayer(16, sh_degree=1, use_rgb=use_rgb)
    p = carried(jm, tm, x, pts)
    want, got = japply(jm, p, x, pts), tm(to_torch(x), to_torch(pts))
    for name in ("xyz", "opacity", "rotation", "scaling", "shs"):
        close(getattr(got, name), getattr(want, name))


def test_vert_heads_and_additional_features():
    rng = np.random.RandomState(9)
    feats, pts = randn(rng, 25, 13), randn(rng, 25, 3, scale=0.1)
    for jm, tm in ((jheads.VertValid(), heads.VertValid(16)),
                   (jheads.VertPosRefinement(), heads.VertPosRefinement(16))):
        p = carried(jm, tm, feats, pts)
        close(tm(to_torch(feats), to_torch(pts)), japply(jm, p, feats, pts))
    jm, tm = jheads.AdditionalFeaturesFC(out_dim=7), \
        heads.AdditionalFeaturesFC(13, 7)
    p = carried(jm, tm, feats)
    close(tm(to_torch(feats)), japply(jm, p, feats))


def test_self_attn_masked_rows_pass_through():
    rng = np.random.RandomState(10)
    x = randn(rng, 2, 150, 131)
    mask = rng.uniform(size=(2, 150)) > 0.5
    jm = jheads.SelfAttn(chunk_size=128)
    tm = heads.SelfAttn(131)
    p = carried(jm, tm, x, mask)
    got = tm(to_torch(x), mask=to_torch(mask))
    close(got, japply(jm, p, x, mask))
    np.testing.assert_array_equal(got.detach().numpy()[~mask], x[~mask])


@pytest.mark.parametrize("color_channels", [48, 3])
def test_renderer_gaussians_and_appearance(color_channels):
    """build_gaussians (2N slots, validity at 0.1 / 0.9) and
    apply_appearance with the wide and the narrow color_b layouts."""
    rng = np.random.RandomState(11)
    n = 60
    feats = randn(rng, n, 131)
    pts = randn(rng, n, 3, scale=0.05)
    uv = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 0.5, n)],
                  1).astype(np.float32)
    jm = JRenderer()
    tm = GSRenderer()
    shapes = jax.eval_shape(functools.partial(jm.init, method="build_gaussians"),
                            jax.random.PRNGKey(0), feats, pts, uv)
    params = random_params(shapes, 12)
    missing, unexpected = load_jax_params(tm, params, strict=False)
    assert not unexpected
    assert all(k.startswith("self_attn_layer.") for k in missing)
    gs_j, uv_j = japply(jm, params, feats, pts, uv, method="build_gaussians")
    gs_t, uv_t = tm.build_gaussians(to_torch(feats), to_torch(pts),
                                    to_torch(uv))
    valid = np.asarray(gs_j.valid)
    assert 0 < valid.sum() < 2 * n
    np.testing.assert_array_equal(gs_t.valid.numpy(), valid)
    maps = {"color_w": 1 + randn(rng, 48, scale=0.1),
            "xyz_b": randn(rng, 3, scale=0.01),
            "color_b_map": randn(rng, color_channels, 16, 32, scale=0.1),
            "opacity_b_map": randn(rng, 1, 16, 32, scale=0.1)}
    want = japply(jm, params, gs_j, uv_j, *maps.values(),
                  method="apply_appearance")
    got = tm.apply_appearance(gs_t, uv_t, *(to_torch(v) for v in maps.values()))
    for name in ("xyz", "opacity", "rotation", "scaling", "shs"):
        close(getattr(got, name), getattr(want, name))


# --- the whole model -----------------------------------------------------

def _jax_layout(model: OneShotAvatarModel, shapes):
    """The port's state_dict in the JAX params layout, through the JAX
    package's reference-checkpoint converter, over a zero tree of the JAX
    model's structure. Returns (params, converter leftovers)."""
    ported, unmapped = port_reference_checkpoint(model.state_dict(),
                                                 backbone_layers=1)
    # the converter emits an empty subtree for the point-cloud generator
    # that the one-shot model does not have
    ported = {k: v for k, v in ported.items() if not (isinstance(v, dict)
                                                      and not v)}
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    merged, skipped = merge_ported(zeros, ported)
    return to_numpy_tree(merged), unmapped + skipped


@pytest.fixture(scope="module")
def tiny():
    """TINY from tests/test_model.py on the synthetic scene: the port's
    seeded init carried into the JAX layout, seeded noise on every leaf,
    then the same params in both models."""
    scene = TScene.build(n_vertices=96, subdivide=1, height=HW, width=HW,
                         device="cpu")
    batch = {k: v.numpy() for k, v in t_batch(scene, seed=0).items()}
    jm = JModel(cfg=JTINY)
    shapes = jax.eval_shape(lambda k, b: jm.init(k, b, HW, HW),
                            jax.random.PRNGKey(0), batch)
    seeded = OneShotAvatarModel(port_model_config(TINY))
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    params, leftovers = _jax_layout(seeded, shapes)
    assert leftovers == []
    params = perturb(params, 21)
    out, hidden = jax.jit(lambda p, b: (
        jm.apply(p, b, HW, HW), jm.apply(p, b, method="features")["hidden"]))(
            params, batch)
    tm = OneShotAvatarModel(port_model_config(TINY)).eval()
    load_jax_params(tm, params)
    return {"batch": batch, "shapes": shapes, "params": params, "out": out,
            "hidden": hidden, "model": tm}


def test_whole_model_forward_matches_jax(tiny):
    with torch.no_grad():
        got = tiny["model"](batch_to_torch(tiny["batch"]), HW, HW)
    want = tiny["out"]
    assert int(want["overflow"][0]) == 0
    assert float(np.asarray(want["comp_mask"]).mean()) > 0.01
    for key, g in (("comp_rgb", got["comp_rgb"]),
                   ("comp_mask", got["comp_mask"])):
        close(g, want[key], atol=MODEL_ATOL, rtol=MODEL_RTOL)
    close(got["hidden"], tiny["hidden"], atol=MODEL_ATOL, rtol=MODEL_RTOL)
    np.testing.assert_array_equal(got["3dgs"][0].valid.numpy(),
                                  np.asarray(want["3dgs"].valid)[0])


def test_state_dict_round_trips_through_reference_port(tiny):
    """The port's parameter names are the reference torch names: its
    state_dict goes through compat/torch_port.py (port_reference_checkpoint
    + merge_ported) and comes back as the JAX params it was loaded from."""
    back, leftovers = _jax_layout(tiny["model"], tiny["shapes"])
    assert leftovers == []
    want = jax.tree_util.tree_leaves_with_path(tiny["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, value in want:
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def test_port_imports_no_jax_or_jax_package():
    """guassianhand_tpu_torch/ and chip_smoke.py import torch, never jax,
    flax or the JAX package."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|guassianhand_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "guassianhand_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []


def test_port_model_config_covers_tiny():
    cfg = port_model_config(TINY)
    assert dataclasses.asdict(cfg)["plane_size"] == TINY.plane_size
    assert TINY.renderer.raster.tile_size == TILE


def test_render_request_views_match_single_view_raster():
    """The CLI's request path on the CPU: two orbit views rendered by one
    model call (one stacked raster) equal each view rendered alone from the
    returned Gaussians (the port counterpart of
    tests/test_rasterize.py::test_multiview_matches_per_view)."""
    from guassianhand_tpu_torch.cli.render_360 import orbit_batch, render_request
    scene = TScene.build(n_vertices=96, subdivide=1, height=HW, width=HW,
                         device="cpu")
    batch = orbit_batch(scene, t_batch(scene, seed=1), 0, 2, 2)
    cfg = port_model_config(TINY)
    model = OneShotAvatarModel(cfg).eval()
    model.reset_parameters(torch.Generator().manual_seed(3))
    out = render_request(model, batch, HW, HW)
    assert out["comp_rgb"].shape == (1, 2, HW, HW, 3)
    assert 0.0 < float(out["comp_mask"].mean()) < 1.0
    r = cfg.renderer
    for v in range(2):
        alone = render_gaussians(
            out["3dgs"][0], batch["w2c_render"][0, v], batch["K_render"][0, v],
            height=HW, width=HW, sh_degree=r.sh_degree, use_rgb=r.use_rgb,
            config=r.raster)
        for key in ("comp_rgb", "comp_mask"):
            close(out[key][0, v], alone[key].numpy(), atol=1e-5, rtol=0)
