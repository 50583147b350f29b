"""The port's CLIs take from the config what the JAX package's take from it:
``cli/render_360.py`` its scene and its model, ``cli/fit_one_shot.py
--steps`` its schedule; and the turntable's GIF and video.

Tolerances: the scene's points within the LBS's 1e-6
(``tests/test_torch_inputs.py``), its point count and the learning rates
exact (rtol 1e-6 for optax's float32 schedule).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from guassianhand_tpu.config import load_config as j_load_config
from guassianhand_tpu.data.synthetic import SyntheticHandScene as JScene
from guassianhand_tpu.data.synthetic import synthetic_batch as j_batch
from guassianhand_tpu.train import fit as jfit
from guassianhand_tpu_torch.cli import fit_one_shot, render_360
from guassianhand_tpu_torch.config import ExperimentConfig, load_config
from guassianhand_tpu_torch.models.one_shot import build_model
from guassianhand_tpu_torch.train import checkpoints
from tests.test_cli import TINY_OVERRIDES
from tests.test_torch_eval import TINY_ARGS
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_render_360_scene_and_model_from_the_config(tmp_path, capsys):
    """At tests/test_cli.py's TINY_OVERRIDES (32^2, data.edge_subdivide 0)
    the turntable renders JAX's scene: as many points, the same points;
    a checkpoint of the config's model (color_b at its 48 channels) loads;
    turntable.gif holds every frame and the video (or its GIF fallback)
    is written beside it."""
    cfg = load_config(None, TINY_OVERRIDES)
    jcfg = j_load_config(None, TINY_OVERRIDES)
    jscene = JScene.build(n_vertices=778, subdivide=min(
        jcfg.data.edge_subdivide, 1), height=jcfg.data.height,
        width=jcfg.data.width)
    want = np.asarray(j_batch(jscene, seed=jcfg.seed,
                              raster=jcfg.model.renderer.raster,
                              with_target=False)["points"])
    scene, batch, seed = render_360.turntable_scene(cfg, device="cpu")
    assert (scene.n_points, scene.height, seed) == (want.shape[1], 32, 0)
    np.testing.assert_allclose(batch["points"].numpy(), want, atol=1e-6)

    model = build_model(cfg.model, seed=5, device="cpu")
    assert model.color_b.shape[0] == 48
    ckpt = tmp_path / "default.ckpt"
    checkpoints.save_checkpoint(str(ckpt), model)
    out = tmp_path / "frames"
    capsys.readouterr()
    assert render_360.main(["--device", "cpu", "--views", "3",
                            "--views_per_call", "2", "--ckpt", str(ckpt),
                            f"--out={out}", *TINY_OVERRIDES]) == 0
    said = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert said["n_points"] == want.shape[1] and said["frames"] == 3
    from PIL import Image
    with Image.open(out / "turntable.gif") as gif:
        assert gif.n_frames == 3 and gif.size == (32, 32)
    assert said["video"] in (str(out / "turntable.mp4"),
                             str(out / "turntable.gif"))


def test_render_360_default_model_is_the_default_config(monkeypatch,
                                                        tmp_path):
    """Without --config or overrides the model is ExperimentConfig()'s, as
    JAX's (the port built a narrow-colour model here), seeded with the
    config's seed; the scene min(data.edge_subdivide, 1) = 1 subdivision:
    4,634 points, JAX's count."""
    built = {}

    class Built(Exception):
        pass

    def fake_build(model_cfg, seed, device):
        built.update(cfg=model_cfg, seed=seed)
        raise Built

    monkeypatch.setattr(render_360, "build_model", fake_build)
    scenes = []
    real_scene = render_360.turntable_scene

    def scene(*args, **kw):
        scenes.append(real_scene(*args, **kw))
        return scenes[-1]

    monkeypatch.setattr(render_360, "turntable_scene", scene)
    with pytest.raises(Built):
        render_360.main(["--device", "cpu", "--height", "32", "--width",
                         "32", f"--out={tmp_path}"])
    assert built == {"cfg": ExperimentConfig().model, "seed": 0}
    assert not built["cfg"].narrow_color_b
    jscene = JScene.build(n_vertices=778, subdivide=1, height=32, width=32)
    assert scenes[0][0].n_points == jscene.n_points == 4634


def test_steps_resets_the_schedule_as_jax(monkeypatch, tmp_path):
    """``--steps`` with fit.gamma and fit.milestones overridden: the JAX
    CLI rebuilds FitConfig from lr, steps and weights, so the overrides
    do not reach its schedule; the port's learning rate at each step
    equals JAX's lr_schedule (make_optimizer's) of that FitConfig."""
    overrides = ["fit.gamma=0.1", "fit.milestones=[0,1]", "fit.lr=0.02"]
    steps = 3
    lrs = []
    real = fit_one_shot.make_fit_step

    def recording(model, vgg, optimizer, *args, **kw):
        step = real(model, vgg, optimizer, *args, **kw)

        def wrapped(batch):
            lrs.append(optimizer.param_groups[0]["lr"])
            return step(batch)
        return wrapped

    monkeypatch.setattr(fit_one_shot, "make_fit_step", recording)
    assert fit_one_shot.main([*TINY_ARGS, "--steps", str(steps),
                              "fit.weights.vgg=0", f"out_dir={tmp_path}",
                              *overrides]) == 0
    jcfg = j_load_config(None, overrides)
    assert jcfg.fit.gamma == pytest.approx(0.1)     # the overrides load...
    # ... and guassianhand_tpu/cli/fit_one_shot.py --steps drops them
    schedule = jfit.lr_schedule(jfit.FitConfig(
        lr=jcfg.fit.lr, epochs=1, steps_per_epoch=steps,
        weights=jcfg.fit.weights))
    want = [float(schedule(jnp.asarray(i))) for i in range(steps)]
    assert lrs == pytest.approx(want, rel=1e-6)
    assert want[0] == pytest.approx(0.02)
