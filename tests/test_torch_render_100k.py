"""The port's render routes that the JAX package's config keys select, and
BASELINE.json config #2 (``cli/render_100k.py``), held against the JAX
package on the CPU:

- ``RendererConfig.multiview_batched=False``, stored with no effect: the
  port's stacked canvas renders what JAX's per-view (vmap) route of
  ``GSRenderer.render_views`` renders;
- ``RasterizeConfig.opacity_cull=False``, stored with no effect: the
  port's binner without the cull enumerates JAX's uncut pairs tile by
  tile, the cull only drops pairs, and on the single-view and the stacked
  multi-view routes the port's (culled) image equals JAX's uncut one;
- ``cli/render_100k.py --interpret``'s scene and render against
  ``scripts/render_100k.py``'s computation at a reduced size (2 views at
  64^2, subdivided once), and the CLI's JSON line.

The JAX side runs as its own tests run it (``tests/test_torch_rasterize.py``,
``JCFG``): Pallas in interpret mode, exact colours, caps wide enough that
it reports overflow 0. The port's composite runs through its plain twins.
Tolerances: the forward's of tests/test_rasterize.py, atol 2e-5 and rtol
1e-4.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from guassianhand_tpu.core.camera import Camera as JCamera
from guassianhand_tpu.data.rays import orbit_cameras as j_orbit_cameras
from guassianhand_tpu.data.synthetic import SyntheticHandScene as JScene
from guassianhand_tpu.ops import binning as jbin
from guassianhand_tpu.ops.projection import project_gaussians as j_project
from guassianhand_tpu.ops.rasterize import rasterize as j_rasterize
from guassianhand_tpu.ops.rasterize import rasterize_multiview as j_multiview
from guassianhand_tpu.ops.rasterize_ref import \
    composite_reference as j_composite_reference
from guassianhand_tpu.render import renderer as jrenderer
from guassianhand_tpu_torch import config as tconfig
from guassianhand_tpu_torch.cli import render_100k
from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.ops.binning import bin_gaussians
from guassianhand_tpu_torch.ops.projection import project_gaussians
from guassianhand_tpu_torch.ops.rasterize import (rasterize,
                                                  rasterize_multiview)
from guassianhand_tpu_torch.render.renderer import GSRenderer
from tests.test_torch_rasterize import (JCFG, close, port_camera,
                                        port_gaussians)
from tests.torch_parity import one_torch_thread, to_torch  # noqa: F401
from tests.utils import make_camera, make_gaussians

HW = 64
NO_CULL = dataclasses.replace(JCFG, opacity_cull=False)


@pytest.fixture(scope="module")
def views():
    """300 Gaussians and two 64x64 views of them, the second turned 0.5 rad
    about the y axis."""
    cam = make_camera(HW, HW)
    w2c = np.asarray(cam.w2c)
    turned = w2c.copy()
    a = 0.5
    turned[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                               [-np.sin(a), 0, np.cos(a)]], np.float32)
    w2cs = np.stack([w2c, turned]).astype(np.float32)
    Ks = np.stack([np.asarray(cam.K)] * 2).astype(np.float32)
    return make_gaussians(300, seed=3), cam, w2cs, Ks


def test_views_one_by_one_match_jax(views):
    """multiview_batched=False loads and changes nothing: the port renders
    the views on its stacked canvas, and the images equal JAX's per-view
    route (render_views vmapping its rasterize); the stacked canvas's
    n_pairs is the sum of the single views'."""
    g, _, w2cs, Ks = views
    jr = jrenderer.GSRenderer(cfg=jrenderer.RendererConfig(
        multiview_batched=False, raster=JCFG))
    want = jax.jit(lambda w, k: jr.apply({}, g, w, k, HW, HW,
                                         method="render_views"))(w2cs, Ks)
    assert int(want["overflow"]) == 0
    tg, tw, tk = port_gaussians(g), to_torch(w2cs), to_torch(Ks)
    cfg = tconfig.load_config(
        None, ["model.renderer.multiview_batched=false"]).model.renderer
    assert not cfg.multiview_batched
    got = GSRenderer(cfg).render_views(tg, tw, tk, HW, HW)
    close(got["comp_rgb"], want["comp_rgb"])
    close(got["comp_mask"], want["comp_mask"])
    singles = [rasterize(tg, Camera.from_w2c(w2cs[i], Ks[i], HW, HW,
                                             device="cpu"),
                         height=HW, width=HW, use_rgb=True)["n_pairs"]
               for i in range(2)]
    assert got["n_pairs"] == sum(singles) > 0
    assert got["overflow"] == 0


def test_opacity_cull_off_bins_the_whole_rect(views):
    """opacity_cull=False loads and changes nothing. The port's binner
    without the cull (opacity=None) gives JAX's uncut enumeration tile by
    tile, and with it keeps at most those pairs in every tile and fewer in
    all. On one view and on the stacked canvas of two, the port's image
    with the key off equals JAX's with its cull off (JAX bins the whole
    rects, the port the culled pairs: the cull changes no pixel)."""
    g, cam, w2cs, Ks = views
    tg = port_gaussians(g)
    proj = jax.jit(j_project)(g.xyz, g.scaling, g.rotation, cam)
    tile_flat, overflow = jax.jit(lambda m, r, v: jbin.enumerate_tiles(
        m, r, v, height=HW, width=HW, cfg=NO_CULL.binning()))(
            proj.mean2d, proj.radius, proj.visible)
    assert int(overflow) == 0
    ntiles = (HW // 16) ** 2
    want_counts = np.bincount(np.asarray(tile_flat),
                              minlength=ntiles + 1)[:ntiles]
    tcam = port_camera(cam, HW, HW)
    p = project_gaussians(tg.xyz, tg.scaling, tg.rotation, tcam)
    op = tg.effective_opacity()[:, 0]

    def counts(opacity):
        bins = bin_gaussians(p.mean2d, p.depth, p.radius, p.visible,
                             height=HW, width=HW, opacity=opacity)
        return (bins.tile_range[1:] - bins.tile_range[:-1]).numpy()

    np.testing.assert_array_equal(counts(None), want_counts)
    culled = counts(op)
    assert (culled <= want_counts).all() and culled.sum() < want_counts.sum()

    off = tconfig.load_config(
        None, ["model.renderer.raster.opacity_cull=false"]
    ).model.renderer.raster
    assert not off.opacity_cull
    one = rasterize(tg, tcam, height=HW, width=HW, use_rgb=True, config=off)
    assert one["n_pairs"] == int(culled.sum())
    want1 = jax.jit(lambda: j_rasterize(
        g, cam, height=HW, width=HW, use_rgb=True, config=NO_CULL))()
    assert int(want1["overflow"]) == 0
    assert int(want1["n_pairs"]) == int(want_counts.sum())
    close(one["comp_rgb"], want1["comp_rgb"])
    close(one["final_t"], want1["final_t"])

    want = jax.jit(lambda w, k: j_multiview(
        g, w, k, height=HW, width=HW, use_rgb=True, config=NO_CULL))(
            w2cs, Ks)
    assert int(want["overflow"]) == 0
    got = rasterize_multiview(tg, to_torch(w2cs), to_torch(Ks), height=HW,
                              width=HW, use_rgb=True, config=off)
    assert 0 < got["n_pairs"] < int(want["n_pairs"])
    close(got["comp_rgb"], want["comp_rgb"])
    close(got["final_t"], want["final_t"])


def jax_render_100k(hw: int, subdivide: int, views: int):
    """scripts/render_100k.py's computation at ``hw``, ``subdivide`` and
    ``views``, with JCFG's caps (interpret mode, overflow 0): (Gaussians,
    w2cs, Ks, the rasterize_multiview outputs)."""
    scene = JScene.build(n_vertices=778, subdivide=subdivide, height=hw,
                         width=hw)
    pose = jnp.zeros((16, 3)).at[3, 2].set(0.4)
    points = scene.pose_points(pose.reshape(-1), pose.reshape(-1))
    g = scene.decoration_gaussians(points)
    center = np.asarray(jnp.mean(g.xyz, axis=0))
    radius = float(np.asarray(jnp.max(
        jnp.linalg.norm(g.xyz - center[None], axis=1)))) * 3.0
    w2cs, Ks = j_orbit_cameras(center, radius, scene.K, n_views=views)
    out = jax.jit(lambda w, k: j_multiview(
        g, w, k, height=hw, width=hw, use_rgb=True, config=JCFG))(
            jnp.asarray(w2cs), jnp.asarray(Ks))
    return g, w2cs, Ks, out


def test_render_100k_matches_jax_script(capsys, monkeypatch):
    """cli/render_100k.py's scene and render against the JAX script's at 2
    views of 64^2, subdivided once: the same 4,634 Gaussians and cameras,
    overflow 0 in both and the same pair count; comp_rgb and final T within
    the forward tolerance of JAX's dense oracle (``ops/rasterize_ref.py``)
    on the script's projected views. Not of its Pallas composite: on this
    scene's tiles (400 to 4,321 pairs) the kernel departs from its own
    oracle by up to 6.5e-4, where the port's twin matches the oracle to
    1e-6; the kernel carries T from one 128-pair block to the next as the
    last accepted pair's, so a pixel whose T fell below T_EPS in one block
    still takes the next block's fainter pairs, where the oracle and the
    port stop. Then ``--interpret`` prints the JAX script's keys with the
    card's name and power limit (the CPU's: none)."""
    g, w2cs, Ks, want = jax_render_100k(HW, 1, 2)
    assert int(want["overflow"]) == 0
    tg, tw, tk = render_100k.baseline_scene(HW, 1, 2, "cpu")
    assert tg.n == g.xyz.shape[0] == 4634
    close(tg.xyz, g.xyz, atol=1e-6, rtol=1e-5)
    close(tw, w2cs, atol=1e-5, rtol=1e-5)
    close(tk, Ks, atol=0, rtol=0)
    got = render_100k.render(tg, tw, tk, HW)
    assert got["overflow"] == 0
    assert got["n_pairs"] == int(want["n_pairs"])
    assert float(got["comp_mask"].mean()) > 0.01
    def oracle_view(w, k):
        p = j_project(g.xyz, g.scaling, g.rotation,
                      JCamera.from_w2c(w, k, HW, HW))
        return j_composite_reference(
            p.mean2d, p.conic, g.shs[:, 0], g.effective_opacity()[:, 0],
            p.depth, p.radius, p.visible, HW, HW, jnp.zeros(3))

    oracle = jax.jit(oracle_view)
    for v in range(2):
        rgb, _, final_t = oracle(jnp.asarray(w2cs[v]), jnp.asarray(Ks[v]))
        close(got["comp_rgb"][v], rgb)
        close(got["final_t"][v], final_t)

    # the CLI's line, at 32^2 with no subdivision to keep the test short
    monkeypatch.setattr(render_100k, "SMOKE",
                        {"hw": 32, "subdivide": 0, "reps": 1})
    assert render_100k.main(["--interpret", "--views", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "ms_per_view", "n_pairs", "overflow",
                         "backend", "device", "power_limit"}
    assert (line["overflow"], line["backend"], line["device"],
            line["power_limit"]) == (0, "cpu", "cpu", None)
    assert "32x32, 1556 gaussians, 2 views" in line["metric"]
    assert line["n_pairs"] > 0 and line["ms_per_view"] > 0
