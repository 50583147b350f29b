"""The reference against the program's plain route at a CPU test's size.
The test imports both; the reference imports nothing of the program."""
import copy

import numpy as np
import pytest
import torch

from benchmark.harness import core, oneshot
from benchmark.harness import scene as scene_mod
from benchmark.tests.conftest import TINY_MESH, TINY_MODEL

K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
W2C = np.eye(4, dtype=np.float32)


def _gaussians(n=400, seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn(n, 3, generator=g) * 0.05
    xyz[:, 2] += 0.6
    return dict(xyz=xyz, opacity=torch.rand(n, 1, generator=g) * 0.9 + 0.05,
                rotation=torch.nn.functional.normalize(
                    torch.randn(n, 4, generator=g), dim=1),
                scaling=torch.rand(n, 3, generator=g) * 0.01 + 0.002,
                shs=torch.rand(n, 1, 3, generator=g))


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_rasterize_and_gradients(hw):
    from guassianhand_tpu_torch.core.camera import Camera as PC
    from guassianhand_tpu_torch.core.gaussians import Gaussians as PG
    from guassianhand_tpu_torch.ops import rasterize as prog
    from benchmark.reference.core.camera import Camera as RC
    from benchmark.reference.core.gaussians import Gaussians as RG
    from benchmark.reference.ops import rasterize as ref
    h, w = hw
    kw = _gaussians()
    a = {k: v.clone().requires_grad_(True) for k, v in kw.items()}
    b = {k: v.clone().requires_grad_(True) for k, v in kw.items()}
    po = prog.rasterize(PG(**a), PC.from_w2c(W2C, K, h, w, device="cpu"),
                        height=h, width=w, use_rgb=True)
    ro = ref.rasterize(RG(**b), RC.from_w2c(W2C, K, h, w, device="cpu"),
                       height=h, width=w)
    assert po["n_pairs"] == ro["n_pairs"]
    assert torch.allclose(po["comp_rgb"], ro["comp_rgb"], atol=1e-6)
    assert torch.allclose(po["comp_mask"], ro["comp_mask"], atol=1e-6)
    wt = torch.rand(h, w, 3, generator=torch.Generator().manual_seed(1))
    for o in (po, ro):
        ((o["comp_rgb"] * wt).sum() + o["comp_mask"].sum()).backward()
    for k in kw:
        scale = a[k].grad.abs().max()
        assert (a[k].grad - b[k].grad).abs().max() <= 1e-5 * scale, k


def test_multiview_and_work_count():
    from guassianhand_tpu_torch.core.gaussians import Gaussians as PG
    from guassianhand_tpu_torch.ops import rasterize as prog
    from guassianhand_tpu_torch.ops.rasterize_cuda import composite_plain
    from benchmark.reference.core.gaussians import Gaussians as RG
    from benchmark.reference.ops import rasterize as ref
    kw = _gaussians(seed=2)
    w2cs = torch.tensor(np.stack([W2C, W2C]))
    ks = torch.tensor(np.stack([K, K]))
    po = prog.rasterize_multiview(PG(**kw), w2cs, ks, height=64, width=64,
                                  use_rgb=True)
    ro = ref.rasterize_multiview(RG(**kw), w2cs, ks, height=64, width=64,
                                 work=True)
    assert po["n_pairs"] == ro["n_pairs"]
    assert torch.allclose(po["comp_rgb"], ro["comp_rgb"], atol=1e-6)
    inputs = prog.multiview_composite_inputs(PG(**kw), w2cs, ks, height=64,
                                             width=64, use_rgb=True)
    ops = composite_plain(inputs.tile_range, inputs.pair_gid, inputs.attrs,
                          height=inputs.height, width=inputs.width,
                          count_ops=True)[-1]
    assert int(ops.sum()) == ro["work"]["forward_ops"]


def _fp32_tiny_config():
    cfg = copy.deepcopy(core.Spec.load("fit_256_bf16").config)
    cfg["experiment"]["model"].update(TINY_MODEL, compute_dtype=None)
    cfg["experiment"]["model"]["renderer"]["raster"]["projection_impl"] = "xla"
    return cfg


def _scene_batch(module, seed=3, with_target=False):
    from benchmark.reference.data import synthetic as ref
    build = (ref.SyntheticHandScene.build if module is ref
             else scene_mod.program_scene)
    scene = build(TINY_MESH, subdivide=1, height=32, width=32, seed=0,
                  device="cpu")
    return module.synthetic_batch(scene, seed=seed, with_target=with_target)


@pytest.mark.parametrize("cell", ["fit_256_bf16", "render_100k_8x512"])
def test_hand_mesh_has_mano_topology(cell):
    """The configured mesh has the counts its configuration states, MANO's
    edges and wrist loop, and subdivides to MANO's vertex counts."""
    from benchmark.reference.mano.model import hand_mesh
    from benchmark.reference.ops.subdivision import build_subdivision_plans
    sc = core.Spec.load(cell).config["scene"]
    a = hand_mesh(**sc["mesh"])
    faces, n = a["faces"], a["v_template"].shape[0]
    assert (n, faces.shape[0]) == (sc["n_vertices"], sc["n_faces"]) \
        == (778, 1538)
    uses = {}
    for f in faces.tolist():
        for x, y in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            key = (min(x, y), max(x, y))
            uses[key] = uses.get(key, 0) + 1
    assert len(uses) == 2315
    assert sorted(set(uses.values())) == [1, 2]
    assert sum(v == 1 for v in uses.values()) == 16
    plans = build_subdivision_plans(faces, n, sc["subdivide"])
    per_hand = {2: 12337, 3: 49281}[sc["subdivide"]]
    assert plans[-1].n_vertices_out == per_hand
    assert sc.get("points", sc.get("gaussians")) == 2 * per_hand


def test_synthetic_batch_equal():
    from guassianhand_tpu_torch.data import synthetic as prog
    from benchmark.reference.data import synthetic as ref
    pb, rb = _scene_batch(prog, with_target=True), _scene_batch(ref,
                                                                with_target=True)
    for k in ("points", "vert_uv", "inter_mask", "mano_pose", "c2w",
              "intrinsic_normed", "w2c_render", "K_render"):
        assert torch.equal(pb[k], rb[k]), k
    assert torch.allclose(pb["target_rgb"], rb["target_rgb"], atol=1e-6)


def test_model_forward_and_fit_steps():
    from guassianhand_tpu_torch.train.fit import (attach_static_features,
                                                  make_fit_step,
                                                  make_optimizer)
    from guassianhand_tpu_torch.data import synthetic as prog_data
    from benchmark.reference.train.fit import fit_steps
    from benchmark.reference import precision
    precision.set_mode("reference")
    cfg = _fp32_tiny_config()
    batch = _scene_batch(prog_data, with_target=True)
    pm = oneshot.program_model(cfg, 5, "cpu")
    rm = oneshot.reference_model(cfg, 5, "cpu")
    with torch.no_grad():
        po, ro = pm(batch, 32, 32), rm(batch, 32, 32)
    assert torch.allclose(po["comp_rgb"], ro["comp_rgb"], atol=1e-5)
    exp = oneshot.program_config(cfg)
    vgg = oneshot.program_vgg(5, "cpu")
    opt, sched = make_optimizer(pm, exp.fit)
    step = make_fit_step(pm, vgg, opt, sched, exp.fit, height=32, width=32)
    bs = attach_static_features(pm, batch)
    losses = [float(step(bs)[0]) for _ in range(2)]
    _, fit_cfg = oneshot.reference_configs(cfg)
    r = fit_steps(rm, oneshot.reference_vgg(5, "cpu"), batch, 2, fit_cfg,
                  height=32, width=32)
    assert np.allclose(losses, [x["loss"] for x in r["losses"]], rtol=1e-4)
    # Adam's first steps move every element by about lr whatever the size
    # of its gradient, so the change is held leaf by leaf in norm
    for name, p in pm.named_parameters():
        if name in r["params"]:
            d = float((p.detach() - r["params"][name]).norm())
            assert d <= 1e-3 * max(float(r["params"][name].norm()), 1.0), name
