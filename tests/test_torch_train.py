"""The PyTorch port's one-shot fitting held against the JAX package on the
CPU: the trainable set and the fit step itself at TINY (tests/test_model.py)
on the synthetic scene, 64^2, vgg 0.1; the static-prefix cache, checkpoint
resume and the fit CLI. The losses, VGG and schedule are in
tests/test_torch_losses.py.

Both packages get the same batch, made by the JAX package and converted
(the points' last-ulp LBS differences would otherwise flip a few points of
the interaction mask, ROADMAP.md Queue C), and the same parameters: the
port's seeded init carried into the JAX layout, seeded noise on every leaf.
The JAX composite runs in Pallas interpret mode with caps wide enough that
it reports overflow 0.

Tolerances, each with its reason:
- losses and their terms over 3 steps: rtol 1e-3 (fp32 sums and
  convolutions taken in another order);
- the first step's gradients of the trainable leaves: atol 2e-4 * scale +
  rtol 2e-3, the gradient tolerance of tests/test_rasterize.py; Adam's
  first moment after one update is 0.1 g in both packages, and is what is
  compared;
- the parameters after 3 steps: Adam divides each gradient by its own
  magnitude, so where a gradient is at noise level a reassociation can flip
  its sign and move that element by up to 2 lr a step. 99 % of every leaf
  must agree within 1e-4 (a 1 % gradient difference moves an Adam step by
  at most about 1 % of lr) and every element within 2 sum(lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

from guassianhand_tpu.train import fit as jfit
from guassianhand_tpu_torch.cli import fit_one_shot
from guassianhand_tpu_torch.compat.from_jax import load_jax_params
from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from guassianhand_tpu_torch.train import checkpoints
from guassianhand_tpu_torch.train import losses
from guassianhand_tpu_torch.train.fit import (FitConfig, fit, make_fit_step,
                                              make_optimizer, trainable_mask)
from tests.test_model import HW, TINY
from tests.torch_parity import (batch_to_torch,  # noqa: F401
                                fit_against_jax, leaf_names, one_torch_thread,
                                port_model_config)

JTINY = dataclasses.replace(TINY, renderer=dataclasses.replace(
    TINY.renderer, raster=dataclasses.replace(
        TINY.renderer.raster, max_tiles_per_gaussian=32,
        pairs_per_gaussian=16.0)))
STEPS = 3
# one update per epoch: the schedule halves lr at the third update
FIT = dict(steps_per_epoch=1, epochs=STEPS)
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3


def close(got, want, atol=0.0, rtol=1e-5, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def adam_close(got, want, lrs, within, msg=""):
    """Parameters after Adam updates with learning rates ``lrs``: every
    element within 2 sum(lrs), the most a gradient at noise level can move
    it by changing sign under Adam's normalisation, and 99 % within
    ``within``."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= 2.0 * sum(lrs), msg
    assert np.mean(diff <= within) >= 0.99, msg


def port_model(params):
    model = OneShotAvatarModel(port_model_config(TINY)).eval()
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def fit_run():
    """Three fit steps of each package from the same parameters on the same
    batch; Adam's first moments after the first step; the parameters
    after the last."""
    return fit_against_jax(JTINY, TINY, HW, STEPS)


def check_first_gradients(fit_run):
    j_mu, t_mu = fit_run["j_mu"], fit_run["t_mu"]
    assert set(j_mu) == {"identity_code_one_shot", "identity_code_book",
                         "map_bias", "color_w", "color_b", "opacity_b"}
    for name, want in j_mu.items():
        scale = float(np.abs(want).max())
        if name not in t_mu:    # no gradient reaches it in either package
            assert scale == 0.0, name
            continue
        assert scale > 0.0, name
        close(t_mu[name], want, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
              msg=name)


def check_losses(fit_run):
    close(fit_run["t_losses"], fit_run["j_losses"], rtol=1e-3)
    assert fit_run["t_losses"][-1] < fit_run["t_losses"][0]
    for t_err, j_err in zip(fit_run["t_errs"], fit_run["j_errs"]):
        assert set(t_err) == {"e_pix_l1", "mask_loss", "e_vgg", "reg",
                              "overflow", "interaction_overflow"}
        assert t_err["overflow"] == 0.0 == j_err["overflow"]
        assert t_err["interaction_overflow"] == 0.0 \
            == j_err["interaction_overflow"]
        for key in t_err:
            close(t_err[key], j_err[key], rtol=1e-3, msg=key)


def check_parameters_after_steps(fit_run):
    model, j_after = fit_run["model"], fit_run["j_after"]
    mask = trainable_mask(model)
    for name, p in model.named_parameters():
        if name in j_after and mask[name]:
            adam_close(p.detach().numpy(), j_after[name], fit_run["lrs"],
                       1e-4, name)


def test_fit_step_first_gradients_match_jax(fit_run):
    check_first_gradients(fit_run)


def test_fit_step_losses_match_jax(fit_run):
    check_losses(fit_run)


def test_fit_step_parameters_match_jax_after_three_steps(fit_run):
    check_parameters_after_steps(fit_run)


def test_fit_step_leaves_frozen_parameters_untouched(fit_run):
    """Frozen parameters do not require grad and keep their values to the
    bit; every trainable map with a gradient moved."""
    flat = leaf_names(fit_run["params"])
    moved = set()
    for name, p in fit_run["model"].named_parameters():
        start = next((v for k, v in flat.items()
                      if k.split("/")[-1] == name), None)
        if not trainable_mask(fit_run["model"])[name]:
            assert not p.requires_grad, name
            if start is not None:
                np.testing.assert_array_equal(p.detach().numpy(), start,
                                              err_msg=name)
        elif start is None:
            # the identity-code head, absent from this JAX tree: the fit
            # does not infer the identity, so no gradient reaches it
            assert name.startswith("identity_code_infer."), name
            assert name not in fit_run["t_mu"], name
        elif not np.array_equal(p.detach().numpy(), start):
            moved.add(name)
    assert moved == {"identity_code_one_shot", "map_bias", "color_w",
                     "color_b", "opacity_b"}


def test_trainable_set_matches_jax(fit_run):
    """The per-identity parameters train, and nothing else. The JAX tree
    here has no identity-code head (its model was initialised without
    infer_identity); the port's, always built, trains with the identity
    codes (tests/test_torch_edit.py holds the set against a JAX tree that
    has it)."""
    want = {k.split("/")[-1] for k, v in
            leaf_names(jfit.trainable_mask(fit_run["shapes"])).items() if v}
    got = {k for k, v in trainable_mask(fit_run["model"]).items() if v}
    head = {k for k in got if k.startswith("identity_code_infer.")}
    assert len(head) == 6
    assert got - head == want
    assert "xyz_b" not in got and "xyz_b_map" not in got


def test_fit_step_with_and_without_static_features_agree(fit_run):
    """One step recomputing the whole forward (make_fit_step without the
    cached prefix) and one through ``fit``, which attaches the cached prefix
    first, give the same loss and the same updated parameters (``adam_close``
    within 1e-6: the gradients differ by reassociation only)."""
    batch = batch_to_torch(fit_run["batch"])
    models, losses_ = [], []
    for cached in (False, True):
        model = port_model(fit_run["params"])
        cfg = FitConfig(weights=losses.LossWeights(vgg=0.0),
                        static_prefix_cache=cached, **dict(FIT, epochs=1))
        if cached:
            logged = []
            losses_.append(fit(model, lambda i: batch, None, cfg, height=HW,
                               width=HW, log_fn=logged.append)[0])
            assert len(logged) == 1
        else:
            opt, sched = make_optimizer(model, cfg)
            losses_.append(float(make_fit_step(model, None, opt, sched, cfg,
                                               height=HW, width=HW)(batch)[0]))
        models.append(model)
    close(losses_[1], losses_[0], rtol=1e-6)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        adam_close(b.detach(), a.detach(), fit_run["lrs"][:1], 1e-6, name)


def test_checkpoint_resume_gives_the_same_next_step(fit_run, tmp_path):
    """Step, save, step again; a fresh model and optimiser resumed from the
    checkpoint take the same second step. Two micro-batches a step
    (accumulate_grad_batches=2) check the accumulation too. The parameters
    agree by ``adam_close`` within 1e-6: the CPU's threaded sums in the
    texture pointnet's backward differ from run to run in the last bits."""
    cfg = FitConfig(weights=losses.LossWeights(vgg=0.0),
                    accumulate_grad_batches=2, **FIT)
    batch = batch_to_torch(fit_run["batch"])

    def fresh():
        model = port_model(fit_run["params"])
        opt, sched = make_optimizer(model, cfg)
        return model, opt, sched, make_fit_step(model, None, opt, sched, cfg,
                                                height=HW, width=HW)

    model, opt, sched, step = fresh()
    for _ in range(2):
        step(batch)
    path = str(tmp_path / "ckpts" / "model-00001.ckpt")
    checkpoints.save_checkpoint(path, model, opt, sched, step=1)
    losses_a = [float(step(batch)[0]) for _ in range(2)]

    model_b, opt_b, sched_b, step_b = fresh()
    latest = checkpoints.latest_checkpoint(str(tmp_path / "ckpts"))
    assert latest == path
    assert checkpoints.load_checkpoint(latest, model_b, opt_b, sched_b) == 1
    assert sched_b.last_epoch == 1
    losses_b = [float(step_b(batch)[0]) for _ in range(2)]
    assert losses_b == losses_a
    for (name, a), b in zip(model.named_parameters(), model_b.parameters()):
        adam_close(b.detach(), a.detach(), fit_run["lrs"][1:2], 1e-6, name)


def test_fit_cli_runs_resumes_and_needs_no_yaml(tmp_path, monkeypatch):
    """``cli/fit_one_shot --synthetic --device cpu --steps 2`` at a shrunken
    size through dotted overrides, with no YAML package importable: it
    writes its metrics, PNGs and checkpoint, and a second run with more
    steps resumes from that checkpoint."""
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    overrides = [f"out_dir={tmp_path}", "expname=cli", "data.edge_subdivide=0",
                 "model.camera_embed_dim=32", "model.pose_embed_dim=32",
                 "model.plane_size=8", "model.token_channels=32",
                 "model.backbone_layers=1", "model.backbone_heads=2",
                 "model.backbone_head_dim=16",
                 "model.residual_map_hw=[32,64]"]
    argv = ["--synthetic", "--device", "cpu", "--height", "32", "--width",
            "32", *overrides]
    assert fit_one_shot.main([*argv, "--steps", "2"]) == 0
    run = tmp_path / "cli"
    assert (run / "ckpts" / "model-00002.ckpt").is_file()
    assert (run / "ckpts" / "last.ckpt").is_symlink()
    for name in ("step0000_pred", "step0000_ref", "step0001_pred"):
        assert (run / "vis" / f"{name}.png").read_bytes()[:4] == b"\x89PNG"
    assert (run / "config_snapshot.json").is_file()
    assert fit_one_shot.main([*argv, "--steps", "3"]) == 0
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [__import__("json").loads(x)["step"] for x in lines] == [0, 1, 2]
    with pytest.raises(SystemExit):
        fit_one_shot.main([*argv, "--run_val"])
