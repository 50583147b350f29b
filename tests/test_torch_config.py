"""The port's config loading against the JAX package's: every YAML file in
``configs/`` loads into the port, every key a file sets holds the JAX
``load_config``'s value for it, unknown keys still raise, and a config
that asks for bf16 compute runs and reports it, and the fit CLI says that
it does not read an edit config's edit settings (exact comparisons: these
are parsed values)."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from guassianhand_tpu import config as jconfig
from guassianhand_tpu_torch import config as tconfig
from guassianhand_tpu_torch.cli import fit_one_shot
from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from tests.torch_parity import one_torch_thread  # noqa: F401

CONFIGS = sorted(Path(__file__).resolve().parents[1].glob("configs/*.yaml"))


def leaves(d, prefix=()):
    """The (path, value) of every value a merged YAML dict sets."""
    for k, v in d.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def get(cfg, path):
    for k in path:
        cfg = getattr(cfg, k)
    return cfg


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_repo_config_loads_with_jax_values(path):
    """Each file loads in both packages, and every key it sets (through
    ``extends:`` too) has the same value in the port's config as in
    JAX's."""
    set_keys = list(leaves(jconfig._load_yaml_with_extends(str(path))))
    assert len(set_keys) > 10
    want = jconfig.load_config(str(path))
    got = tconfig.load_config(str(path))
    for key, _ in set_keys:
        assert get(got, key) == get(want, key), key


def test_unknown_keys_raise():
    """A key that no dataclass has raises at every level, and the keys the
    port stores without effect are the JAX defaults when unset."""
    for bad in ("bogus=1", "data.bogus=1", "model.bogus=1",
                "model.renderer.raster.bogus=1", "edit.bogus=1",
                "fit.weights.bogus=1"):
        with pytest.raises(KeyError, match="bogus"):
            tconfig.load_config(None, [bad])
    got, want = tconfig.load_config(), jconfig.load_config()
    for path in (("data", "data_root"), ("data", "mask_sa"),
                 ("model", "compute_dtype"), ("model", "interaction_k"),
                 ("model", "backbone_softmax_fp32"),
                 ("model", "renderer", "raster", "pairs_per_gaussian"),
                 ("edit", "enabled")):
        assert get(got, path) == get(want, path), path


def test_data_config_has_every_jax_field():
    """Every field of the JAX package's DataConfig exists in the port's,
    with the same default, and an override of each new one loads (as
    cli/port_and_eval.py passes data.pose_sequence and the paths)."""
    jfields = {f.name: f.default for f in
               dataclasses.fields(jconfig.DataConfig)}
    tfields = {f.name: f.default for f in
               dataclasses.fields(tconfig.DataConfig)}
    assert tfields == jfields
    cfg = tconfig.load_config(None, [
        "data.pose_sequence=oneshot_reg_i", "data.mano_models_path=m",
        "data.mano_uv_path=u", "data.use_native_loader=false"])
    assert (cfg.data.pose_sequence, cfg.data.mano_models_path,
            cfg.data.mano_uv_path, cfg.data.use_native_loader) == (
        "oneshot_reg_i", "m", "u", False)


def test_renderer_config_has_every_jax_field():
    """The port's RendererConfig has JAX's field names, with JAX's defaults
    (the raster config apart: the two packages' RasterizeConfig classes),
    multiview_batched included (stored with no effect: JAX's per-view
    route renders what the port's stacked canvas renders). The exchange's
    overrides load into both packages with equal values."""
    from guassianhand_tpu.render.renderer import RendererConfig as JR
    from guassianhand_tpu_torch.render.renderer import RendererConfig as TR
    jfields = {f.name: f.default for f in dataclasses.fields(JR)}
    tfields = {f.name: f.default for f in dataclasses.fields(TR)}
    assert set(tfields) == set(jfields)
    assert {k: v for k, v in tfields.items() if k != "raster"} == \
        {k: v for k, v in jfields.items() if k != "raster"}
    assert not tconfig.load_config(
        None, ["model.renderer.multiview_batched=false"]
    ).model.renderer.multiview_batched
    overrides = ["model.renderer.sharded_exchange=true",
                 "model.renderer.exchange_capacity=4096"]
    got = tconfig.load_config(None, overrides).model.renderer
    want = jconfig.load_config(None, overrides).model.renderer
    for name in ("sharded_exchange", "sharded_exchange_required",
                 "exchange_capacity"):
        assert getattr(got, name) == getattr(want, name), name
    assert (got.sharded_exchange, got.exchange_capacity) == (True, 4096)


def test_bf16_and_edit_are_not_run_silently(tmp_path, capsys):
    """configs/one_shot.yaml builds a model whose feature pipeline computes
    in bf16 (its parameters float32), and the line the entry points print
    and the snapshot's compute_dtype_effective say bfloat16; without
    compute_dtype both say float32. Given an edit config, the fit CLI says
    that it does not read the edit settings (as in the JAX package, the
    edit fit is cli/edit.py), and without --synthetic it goes to the
    config's InterHand2.6M data, which it loads before it builds or writes
    anything: with no MANO pickles it stops there."""
    cfg = tconfig.load_config(str(CONFIGS[0].parent / "one_shot.yaml"))
    assert cfg.model.compute_dtype == "bfloat16"
    model = OneShotAvatarModel(dataclasses.replace(
        cfg.model, residual_map_hw=(8, 16)))
    assert model.backbone.proj_in.compute_dtype == torch.bfloat16
    assert model.renderer.self_attn_layer.w_qs.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert tconfig.compute_dtype_line(cfg.model).startswith(
        "compute dtype: bfloat16")
    plain = dataclasses.replace(cfg.model, compute_dtype=None)
    assert tconfig.compute_dtype_line(plain) == "compute dtype: float32"
    snap = json.loads(Path(tconfig.save_config_snapshot(
        cfg, str(tmp_path))).read_text())
    assert snap["compute_dtype_effective"] == "bfloat16"
    assert snap["model"]["compute_dtype"] == "bfloat16"
    for name in ("one_shot_edit.yaml", "one_shot_avatar_drive.yaml"):
        with pytest.raises(FileNotFoundError, match="MANO model pickles"):
            fit_one_shot.main(["--config", str(CONFIGS[0].parent / name),
                               "--device", "cpu",
                               f"out_dir={tmp_path / 'runs'}",
                               f"data.mano_models_path={tmp_path / 'none'}"])
        said = capsys.readouterr()
        assert "does not read the edit settings" in said.out
        assert "cli.edit" in said.out
    assert not (tmp_path / "runs").exists()
