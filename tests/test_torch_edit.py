"""The PyTorch port's texture-edit path held against the JAX package on the
CPU: the renderer's appearance residuals under every edit flag, the
identity-code inference head, the TINY model's forward with a codebook
identity, an inferred identity and the edit flags, two edit-fit steps
(lr 0.001, no VGG, a codebook identity), the trainable set with the
identity-code head, and ``cli/edit.py`` end to end.

Inputs are numpy arrays made from seeds and handed to both packages; the
parameters are the port's seeded init carried into the JAX layout with
seeded noise on every leaf (tests/torch_parity.py). Tolerances, each with
its reason:
- ``apply_appearance``: atol 1e-6, a handful of fp32 operations in the same
  order;
- the head: MODULE_ATOL / MODULE_RTOL (matmuls and the LayerNorm's sums in
  another order);
- the model's forward: the rasterizer's forward tolerances, atol 2e-5 and
  rtol 1e-4 (RASTER_ATOL, RASTER_RTOL);
- the edit fit as tests/test_torch_train.py holds the one-shot fit: losses
  rtol 1e-3, the first step's gradients (Adam's first moments) atol
  2e-4 * scale + rtol 2e-3, the parameters after the steps every element
  within 2 sum(lr) and 99 % within 1e-5 (a tenth of test_torch_train's
  1e-4, as lr is a tenth).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from guassianhand_tpu.core.gaussians import Gaussians as JGaussians
from guassianhand_tpu.models.one_shot import OneShotAvatarModel as JModel
from guassianhand_tpu.nn.heads import IdentityCodeInfer as JIdentityCodeInfer
from guassianhand_tpu.render.renderer import EditConfig as JEditConfig
from guassianhand_tpu.render.renderer import GSRenderer as JRenderer
from guassianhand_tpu.train import fit as jfit
from guassianhand_tpu_torch.cli import edit as edit_cli
from guassianhand_tpu_torch.compat.from_jax import load_jax_params
from guassianhand_tpu_torch.config import load_config
from guassianhand_tpu_torch.core.gaussians import Gaussians
from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene as TScene
from guassianhand_tpu_torch.data.synthetic import synthetic_batch as t_batch
from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from guassianhand_tpu_torch.nn.heads import IdentityCodeInfer
from guassianhand_tpu_torch.render.renderer import EditConfig, GSRenderer
from guassianhand_tpu_torch.train import checkpoints
from guassianhand_tpu_torch.train.fit import trainable_mask
from tests.test_cli import TINY_OVERRIDES
from tests.test_model import HW, TINY
from tests.test_torch_train import adam_close, check_first_gradients
from tests.torch_parity import (RASTER_ATOL, RASTER_RTOL,  # noqa: F401
                                batch_to_torch, carried, close,
                                fit_against_jax, jax_layout, leaf_names,
                                one_torch_thread, perturb, port_model_config,
                                randn, to_torch)

JTINY = dataclasses.replace(TINY, renderer=dataclasses.replace(
    TINY.renderer, raster=dataclasses.replace(
        TINY.renderer.raster, max_tiles_per_gaussian=32,
        pairs_per_gaussian=16.0)))
FLAGS = (EditConfig(), EditConfig(enabled=True),
         EditConfig(enabled=True, edit_left_only=True),
         EditConfig(enabled=True, duplication=True),
         EditConfig(enabled=True, edit_left_only=True, duplication=True))
FORWARD_OPTIONS = {
    "book3": {"identity_from_book": 3},
    "infer": {"infer_identity": True},
    "edit_dup": {"edit": EditConfig(enabled=True, duplication=True)},
}
# the port's head, name by name, in the JAX layout
HEAD_LEAVES = {"Dense_0/kernel": "fc.weight", "Dense_0/bias": "fc.bias",
               "LayerNorm_0/scale": "layer_norm.weight",
               "LayerNorm_0/bias": "layer_norm.bias",
               "Dense_1/kernel": "fc_out.weight", "Dense_1/bias": "fc_out.bias"}
EDIT_FIT = dict(forward_kw={"edit": EditConfig(enabled=True,
                                               edit_left_only=True,
                                               duplication=True),
                            "identity_from_book": 1},
                lr=0.001, vgg=0.0)


def jax_options(options):
    if "edit" in options:
        return {**options,
                "edit": JEditConfig(**dataclasses.asdict(options["edit"]))}
    return options


def test_apply_appearance_under_edit_flags_matches_jax():
    """Every combination of the edit flags, the wide and the narrow colour
    map, points on both sides of u = 0.5 and at the atlas' right edge: the
    duplicated right hand samples its colour at u + 0.5, near 1.0 for u
    near 0.5, where the sampler clamps to the border."""
    rng = np.random.RandomState(5)
    edge = np.array([0.5 - 1e-6, 0.4999, 0.5, 0.5 + 1e-6, 0.999, 1.0,
                     0.0, 0.25], np.float32)
    u = np.concatenate([edge, rng.uniform(0, 1, 56).astype(np.float32)])
    n = u.size
    uv = np.stack([u, rng.uniform(0, 0.5, n).astype(np.float32)], 1)
    gs = dict(xyz=randn(rng, n, 3, scale=0.05),
              opacity=rng.uniform(0.1, 0.9, (n, 1)).astype(np.float32),
              rotation=randn(rng, n, 4), scaling=np.abs(randn(rng, n, 3)),
              shs=rng.uniform(0, 1, (n, 1, 3)).astype(np.float32),
              valid=np.ones(n, np.float32))
    jr = JRenderer()
    params = {"params": {}}    # apply_appearance reads no parameter
    for channels in (48, 3):
        maps = (1 + randn(rng, 48, scale=0.2), randn(rng, 3, scale=0.01),
                randn(rng, channels, 16, 32, scale=0.3),
                randn(rng, 1, 16, 32, scale=0.1))
        for flags in FLAGS:
            want = jr.apply(params, JGaussians(**gs), uv, *maps,
                            JEditConfig(**dataclasses.asdict(flags)),
                            method=JRenderer.apply_appearance)
            got = GSRenderer.apply_appearance(
                Gaussians(**{k: to_torch(v) for k, v in gs.items()}),
                to_torch(uv), *(to_torch(m) for m in maps), flags)
            for name in ("xyz", "opacity", "shs"):
                close(getattr(got, name), getattr(want, name), atol=1e-6,
                      rtol=0)


@pytest.fixture(scope="module")
def tiny():
    """TINY initialised by JAX with infer_identity=True (so its tree has
    the head), the port's seeded init carried in with noise on every leaf,
    and the JAX forward under each of FORWARD_OPTIONS, one compile (the
    frame's fit-constant prefix computed once for the three, as the fit
    computes it; the port's forward computes it itself). The
    head's leaves get a tenth of the others' noise (0.005): its last Dense
    sums 8,448 inputs with weights of spread 0.011 at init, and the 0.05
    the other leaves get would push every code into the sigmoid's flat
    tails at +-1, where nothing of the head's function is left to
    compare."""
    scene = TScene.build(n_vertices=96, subdivide=1, height=HW, width=HW,
                         device="cpu")
    batch = {k: v.numpy() for k, v in t_batch(scene, seed=0).items()}
    jm = JModel(cfg=JTINY)
    shapes = jax.eval_shape(
        lambda k, b: jm.init(k, b, HW, HW, infer_identity=True),
        jax.random.PRNGKey(0), batch)
    seeded = OneShotAvatarModel(port_model_config(TINY))
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    params, leftovers = jax_layout(seeded, shapes)
    assert leftovers == []
    head = params["params"]["identity_code_infer"]
    params = perturb(params, 21)
    params["params"]["identity_code_infer"] = perturb(head, 22, scale=0.005)
    cached = jfit.attach_static_features(jm, params, batch)
    outs = jax.jit(lambda p, b: {
        name: jm.apply(p, b, HW, HW, **jax_options(opts))
        for name, opts in FORWARD_OPTIONS.items()})(params, cached)
    tm = OneShotAvatarModel(port_model_config(TINY)).eval()
    load_jax_params(tm, params)
    return {"batch": batch, "shapes": shapes, "params": params, "outs": outs,
            "model": tm}


def test_identity_code_infer_carried_across(tiny):
    """The head alone against JAX's; in the model, a tree with the head
    loads it (strict) and goes back to the same JAX leaves, and a tree
    without it loads too (strict), leaving the head as it was."""
    rng = np.random.RandomState(3)
    tokens = randn(rng, 2, 256, 94)
    head = IdentityCodeInfer(94)
    params = carried(JIdentityCodeInfer(), head, tokens, seed=4)
    with torch.no_grad():
        got = head(to_torch(tokens))
    close(got, JIdentityCodeInfer().apply(params, tokens))

    model = tiny["model"]
    want = leaf_names(tiny["params"]["params"]["identity_code_infer"])
    for jname, tname in HEAD_LEAVES.items():
        value = model.identity_code_infer.state_dict()[tname].numpy()
        np.testing.assert_array_equal(
            value.T if jname.endswith("kernel") else value, want[jname])
    back, _ = jax_layout(model, tiny["shapes"])
    back = leaf_names(back["params"]["identity_code_infer"])
    assert back.keys() == want.keys()
    for jname, value in back.items():
        np.testing.assert_array_equal(value, want[jname])
    no_head = {k: v for k, v in tiny["params"]["params"].items()
               if k != "identity_code_infer"}
    fresh = OneShotAvatarModel(port_model_config(TINY))
    fresh.reset_parameters(torch.Generator().manual_seed(7))
    before = {k: v.clone() for k, v in
              fresh.identity_code_infer.state_dict().items()}
    load_jax_params(fresh, no_head, strict=True)
    for k, v in fresh.identity_code_infer.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(fresh.map_bias, model.map_bias)


@pytest.mark.parametrize("option", FORWARD_OPTIONS)
def test_forward_with_identity_and_edit_options_matches_jax(tiny, option):
    with torch.no_grad():
        got = tiny["model"](batch_to_torch(tiny["batch"]), HW, HW,
                            **FORWARD_OPTIONS[option])
        plain = tiny["model"](batch_to_torch(tiny["batch"]), HW, HW)
    want = tiny["outs"][option]
    assert int(want["overflow"][0]) == 0
    assert float(np.asarray(want["comp_mask"]).mean()) > 0.01
    for key in ("comp_rgb", "comp_mask"):
        close(got[key], want[key], atol=RASTER_ATOL, rtol=RASTER_RTOL)
    # the option changes the render
    assert not torch.allclose(got["comp_rgb"], plain["comp_rgb"])


@pytest.fixture(scope="module")
def edit_fit():
    return fit_against_jax(JTINY, TINY, HW, 2, **EDIT_FIT)


def test_edit_fit_steps_match_jax(edit_fit):
    """Two edit-fit steps: the losses and their terms, the first step's
    gradients of every trainable leaf (the codebook's, which only entry 1
    receives, among them; identity_code_one_shot gets none in either
    package), and the parameters after the two steps."""
    close(edit_fit["t_losses"], edit_fit["j_losses"], rtol=1e-3)
    assert edit_fit["t_losses"][-1] < edit_fit["t_losses"][0]
    for t_err, j_err in zip(edit_fit["t_errs"], edit_fit["j_errs"]):
        assert set(t_err) == {"e_pix_l1", "mask_loss", "reg", "overflow",
                              "interaction_overflow"}
        for key in t_err:
            close(t_err[key], j_err[key], atol=1e-7, rtol=1e-3)
    check_first_gradients(edit_fit)
    book = edit_fit["t_mu"]["identity_code_book"].numpy()
    assert np.abs(book[1]).max() > 0
    assert np.abs(np.delete(book, 1, axis=0)).max() == 0
    assert "identity_code_one_shot" not in edit_fit["t_mu"]
    model, j_after = edit_fit["model"], edit_fit["j_after"]
    start = {k.split("/")[-1]: v
             for k, v in leaf_names(edit_fit["params"]).items()}
    mask = trainable_mask(model)
    moved = set()
    for name, p in model.named_parameters():
        if name in j_after and mask[name]:
            adam_close(p.detach().numpy(), j_after[name], edit_fit["lrs"],
                       1e-5, name)
            if not np.array_equal(p.detach().numpy(), start[name]):
                moved.add(name)
    assert moved == {"identity_code_book", "map_bias", "color_w", "color_b",
                     "opacity_b"}


def test_trainable_set_matches_jax_with_identity_head(tiny):
    """Against a JAX tree that has the head (infer_identity at init), the
    port trains the same leaves: the per-identity maps, both identity codes
    and the head's six arrays."""
    want = set()
    for path, train in leaf_names(jfit.trainable_mask(tiny["shapes"])).items():
        parts = path.split("/")
        if train and "identity_code_infer" in parts:
            want.add("identity_code_infer."
                     + HEAD_LEAVES["/".join(parts[-2:])])
        elif train:
            want.add(parts[-1])
    got = {k for k, v in trainable_mask(tiny["model"]).items() if v}
    assert got == want
    assert {k for k in got if k.startswith("identity_code_infer.")} == {
        "identity_code_infer." + v for v in HEAD_LEAVES.values()}


def test_edit_cli_writes_render_and_checkpoint(tmp_path, monkeypatch):
    """``cli/edit.py --device cpu`` at the JAX CLI test's TINY_OVERRIDES
    for 2 steps: the flags reach the renderer's EditConfig, and it writes
    the first render and the checkpoint, which loads back."""
    captured = {}
    real = edit_cli.EditConfig

    def spy(*a, **kw):
        captured["edit"] = real(*a, **kw)
        return captured["edit"]

    monkeypatch.setattr(edit_cli, "EditConfig", spy)
    rc = edit_cli.main(
        ["--left-only", "--duplication", "--steps", "2", "--identity", "1",
         "--device", "cpu", f"out_dir={tmp_path}", "expname=esmoke"]
        + TINY_OVERRIDES)
    assert rc == 0
    assert captured["edit"] == real(enabled=True, edit_left_only=True,
                                    duplication=True)
    run = tmp_path / "esmoke_edit"
    assert (run / "vis" / "edit0000.png").read_bytes()[:4] == b"\x89PNG"
    assert (run / "vis" / "edit0001.png").exists()
    model = OneShotAvatarModel(load_config(None, TINY_OVERRIDES).model)
    assert checkpoints.load_checkpoint(str(run / "ckpts" / "edit.ckpt"),
                                       model) == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())
