"""The PyTorch port's renderer head and the whole one-shot model held
against the JAX package on the CPU (the building blocks are in
tests/test_torch_nn.py and tests/test_torch_heads.py).

The renderer's parameters are made with numpy from a seed, with no zero
leaf, and carried across with ``compat/from_jax.load_jax_params``. The
whole model starts from its own init schemes, with seeded noise on every
leaf.

Tolerances: the renderer's outputs at atol 2e-5 / rtol 1e-5, the fp32
rounding of matmuls and reductions that XLA and PyTorch order differently;
the whole model at atol 1e-4 (hidden features pass two stacked transformers
and an attention, where those differences compound; the renders stay near
1e-6).
"""
import dataclasses
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from guassianhand_tpu.models.one_shot import OneShotAvatarModel as JModel
from guassianhand_tpu.render.renderer import GSRenderer as JRenderer
from guassianhand_tpu_torch.compat.from_jax import load_jax_params
from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene as TScene
from guassianhand_tpu_torch.data.synthetic import synthetic_batch as t_batch
from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from guassianhand_tpu_torch.ops.common import TILE
from guassianhand_tpu_torch.ops.rasterize import render_gaussians
from guassianhand_tpu_torch.render.renderer import GSRenderer
from tests.test_model import HW, TINY
from tests.torch_parity import (batch_to_torch, close, japply,  # noqa: F401
                                jax_layout, one_torch_thread, perturb,
                                port_model_config, randn, random_params,
                                to_torch)

# TINY with JAX raster caps wide enough that no pair is dropped (overflow 0)
JTINY = dataclasses.replace(TINY, renderer=dataclasses.replace(
    TINY.renderer, raster=dataclasses.replace(
        TINY.renderer.raster, max_tiles_per_gaussian=32,
        pairs_per_gaussian=16.0)))
MODEL_ATOL, MODEL_RTOL = 1e-4, 1e-4
REPO = Path(__file__).resolve().parents[1]


# --- the renderer head -------------------------------------------------

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
    params, leftovers = jax_layout(seeded, shapes)
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
    back, leftovers = jax_layout(tiny["model"], tiny["shapes"])
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
