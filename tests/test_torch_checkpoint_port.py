"""The PyTorch port's reference-checkpoint path on the CPU: the converter
(``compat/torch_port.py``) against the published checkpoint's key spec
(``tests/fixtures/reference_tgs_spec.json``) and against the JAX package's
converter (the avatar's keys, and the point-cloud generator's and the
second upsampler's), the strict=False loader behind ``pretrained:``
(``train/checkpoints.load_params_partial``), ``cli/port_checkpoint.py``
(with ``--dinov2``) and ``cli/port_and_eval.py`` (its ``--dry_run``
checklist, and its three stages end to end at a small size on the fake
InterHand2.6M layout of ``tests/torch_interhand_layout.py``: the fit CLI's
InterHand2.6M fit and ``--run_val``).

Tolerances: none; every comparison is exact (parameters copied or
reshaped, and renders of equal parameters).
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from guassianhand_tpu.compat import torch_port as jport
from guassianhand_tpu.models.one_shot import OneShotAvatarModel as JModel
from guassianhand_tpu_torch.cli import fit_one_shot, port_and_eval
from guassianhand_tpu_torch.cli import port_checkpoint
from guassianhand_tpu_torch.compat import torch_port
from guassianhand_tpu_torch.compat.from_jax import (load_jax_params,
                                                    state_dict_from_jax)
from guassianhand_tpu_torch.config import load_config
from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene as TScene
from guassianhand_tpu_torch.data.synthetic import synthetic_batch as t_batch
from guassianhand_tpu_torch.models.one_shot import (OneShotAvatarModel,
                                                    OneShotConfig)
from guassianhand_tpu_torch.models.point_generator import SimplePointGenerator
from guassianhand_tpu_torch.nn.tokenizers import TriplaneUpsampler
from guassianhand_tpu_torch.train import checkpoints
from tests.test_model import HW, TINY
from tests.test_torch_eval import JAX_METRIC_KEYS, TINY_ARGS
from tests.test_torch_train import JTINY
from tests.torch_parity import (hf_dinov2,  # noqa: F401
                                one_torch_thread, port_model_config)
from tests import torch_interhand_layout as ih_layout

SPEC = json.loads((Path(__file__).parent / "fixtures" /
                   "reference_tgs_spec.json").read_text())
GENERATOR = "pointcloud_generator."
# the reference's upsampler that no forward reads (compat/torch_port.py)
DEAD = ("post_processor.upsample.bias", "post_processor.upsample.weight")
# what the loader says of the keys the avatar model has no module for
ABSENT = "skipped: pointcloud_generator (absent, {} tensors), " \
         "post_processor (absent, 2 tensors)"


def reference_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """``model``, with seeded noise on every tensor
    (``tests/torch_interhand_layout.py::add_noise``), in the reference checkpoint's layout
    (``torch_interhand_layout.reference_state_dict``: the ``model.`` prefix, 5-D
    identity codes, a 48-channel color_b, point-cloud generator keys, no
    identity-code head), with the reference's unread upsampler beside it."""
    sd = ih_layout.reference_state_dict(ih_layout.add_noise(model, seed))
    gen = torch.Generator().manual_seed(seed)
    for k in DEAD:
        like = sd[k.replace("post_processor", "model.post_processor_texture")]
        sd[f"model.{k}"] = torch.randn(like.shape, generator=gen)
    return sd


def test_converter_maps_the_reference_spec():
    """Every key of the published checkpoint's spec maps, by name and at
    its shape (identity codes reshaped), to a module of the port (built on
    the meta device: nothing allocated): the published-width avatar model,
    the point-cloud generator (its 375 keys) and the reference's second
    upsampler; none is unmapped, as none is in the JAX package's
    converter."""
    sd = {k: torch.empty(shape, device="meta") for k, shape in SPEC.items()}
    ported, unmapped = torch_port.port_reference_checkpoint(sd)
    assert unmapped == [] == jport.port_reference_checkpoint(
        {k: np.zeros(shape, np.float32) for k, shape in SPEC.items()})[1]
    generator = sorted(k for k in SPEC if k.startswith(GENERATOR))
    assert len(generator) == 375 and len(ported) == len(SPEC)
    with torch.device("meta"):
        own = OneShotAvatarModel(OneShotConfig()).state_dict()
        own.update({GENERATOR + k: v for k, v in
                    SimplePointGenerator().state_dict().items()})
        own.update({"post_processor." + k: v for k, v in
                    TriplaneUpsampler().state_dict().items()})
    for k, v in ported.items():
        assert v.shape == own[k].shape, k
    missing = set(own) - set(ported)
    assert all(k.startswith(("identity_code_infer.",
                             GENERATOR + "image_tokenizer.model."))
               for k in missing)


def with_vit_placeholders(tree):
    """JAX's converted generator tree carries the tokenizer's modulations
    only (the ViT's weights are not in the reference checkpoint): the ViT's
    leaves filled with placeholders, so that the tree maps as a whole."""
    dummy = {"kernel": np.zeros((1, 1, 1, 1), np.float32),
             "bias": np.zeros(1, np.float32),
             "scale": np.zeros(1, np.float32)}
    tok = tree["image_tokenizer"]
    tok.update(cls_token=dummy["bias"], pos_embed=dummy["bias"],
               patch_embed=dummy, layernorm=dummy)
    for layer in tok.values():
        if isinstance(layer, dict) and "norm1_modulation" in layer:
            layer.update({k: dummy for k in ("norm1", "norm2", "fc1", "fc2")})
            layer["attention"] = {k: dummy for k in
                                  ("query", "key", "value", "dense")}
            layer["layer_scale1"] = layer["layer_scale2"] = {
                "lambda1": dummy["bias"]}
    return tree


def test_generator_keys_equal_the_jax_converters():
    """The spec's 375 generator keys and the second upsampler's 2 on
    seeded values: each tensor the port's converter keeps equals, to the
    bit, JAX's converter's tree carried into the port's layout
    (``compat/from_jax``), BatchNorm counters aside (JAX drops them)."""
    rng = np.random.default_rng(0)
    sd = {f"model.{k}": rng.standard_normal(size=shape, dtype=np.float32)
          for k, shape in SPEC.items()
          if k.startswith((GENERATOR, "post_processor."))}
    ported, unmapped = torch_port.port_reference_checkpoint(sd)
    j_ported, j_unmapped = jport.port_reference_checkpoint(sd)
    assert unmapped == j_unmapped == [] and len(ported) == 377
    with torch.device("meta"):
        generator, upsampler = SimplePointGenerator(), TriplaneUpsampler()
    want = {GENERATOR + k: v for k, v in state_dict_from_jax(
        generator, with_vit_placeholders(j_ported["pointcloud_generator"])
    ).items()}
    want.update({"post_processor." + k: v for k, v in state_dict_from_jax(
        upsampler, j_ported["post_processor"]).items()})
    for k, v in ported.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, torch.from_numpy(want[k])), k


def test_both_converters_give_the_same_forward():
    """One reference-layout state dict of the small model, converted by the
    port's converter and by the JAX package's (port_reference_checkpoint +
    merge_ported over the JAX model's tree, then carried into the port by
    load_jax_params), gives the same parameters to the bit, and so the
    same render. (tests/test_torch_model.py holds the port's render of
    carried JAX parameters against JAX's own.)"""
    seeded = OneShotAvatarModel(port_model_config(TINY))
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    ref = reference_state_dict(seeded, seed=1)
    scene = TScene.build(n_vertices=96, subdivide=1, height=HW, width=HW,
                         device="cpu")
    batch = t_batch(scene, seed=0)
    jm = JModel(cfg=JTINY)
    shapes = jax.eval_shape(lambda k, b: jm.init(k, b, HW, HW),
                            jax.random.PRNGKey(0),
                            {k: v.numpy() for k, v in batch.items()})
    j_ported, _ = jport.port_reference_checkpoint(ref, backbone_layers=1)
    j_ported = {k: v for k, v in j_ported.items()
                if not (isinstance(v, dict) and not v)}
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, skipped = jport.merge_ported(zeros, j_ported)
    # the JAX model has neither the generator nor the reference's
    # post_processor: both converters set them aside
    assert sorted(skipped) == ["pointcloud_generator (absent)",
                               "post_processor (absent)"]
    via_jax = OneShotAvatarModel(port_model_config(TINY)).eval()
    load_jax_params(via_jax, jax.tree.map(np.array, params))

    model = OneShotAvatarModel(port_model_config(TINY)).eval()
    ported, unmapped = torch_port.port_reference_checkpoint(
        ref, backbone_layers=1)
    missing, unexpected = model.load_state_dict(ported, strict=False)
    assert unmapped == [] and all(
        k.startswith("identity_code_infer.") for k in missing)
    assert sorted(unexpected) == sorted(
        k.removeprefix("model.") for k in ref
        if k.startswith(("model." + GENERATOR, "model.post_processor.")))
    # the identity-code head, which neither checkpoint carries, as it is
    model.identity_code_infer.load_state_dict(
        via_jax.identity_code_infer.state_dict())
    want = via_jax.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with torch.no_grad():
        got, again = model(batch, HW, HW), via_jax(batch, HW, HW)
    assert float(got["comp_mask"].mean()) > 0.01
    for key in ("comp_rgb", "comp_mask"):
        assert torch.equal(got[key], again[key]), key


# the small model the CLIs build from TINY_ARGS' model overrides
SMALL_ARGS = [a for a in TINY_ARGS if a.startswith("model.")]


def small_model(narrow: bool, seed: int) -> OneShotAvatarModel:
    model = OneShotAvatarModel(dataclasses.replace(
        load_config(None, SMALL_ARGS).model, narrow_color_b=narrow))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def test_partial_loader_keeps_what_the_checkpoint_lacks(tmp_path, capsys):
    """A checkpoint that lacks a key keeps the model's value there, carries
    color_b from 48 channels into the narrow layout (sliced) and from 3
    into the wide one (zero-filled), says ``restored N/M`` and lists what it
    restored, kept and did not use; the fit CLI's ``pretrained:`` goes
    through it (the strict load raised on such a checkpoint)."""
    # noise on both, so that no map is 0 on both sides
    wide = ih_layout.add_noise(small_model(False, 0), 3)
    narrow = ih_layout.add_noise(small_model(True, 1), 4)
    sd = {k: v for k, v in wide.state_dict().items() if k != "map_bias"}
    sd["unused.weight"] = torch.ones(2)
    path = str(tmp_path / "wide.ckpt")
    checkpoints.write_checkpoint(path, sd, keep_last_link=False)
    before = narrow.map_bias.detach().clone()
    got = checkpoints.load_params_partial(path, narrow)
    n = len(narrow.state_dict())
    assert f"restored {n - 1}/{n} tensors" in capsys.readouterr().out
    assert got["missing"] == ["map_bias"]
    assert got["unexpected"] == ["unused.weight"]
    assert len(got["restored"]) == n - 1
    assert torch.equal(narrow.map_bias, before)
    assert torch.equal(narrow.color_b, wide.color_b[:3])
    assert torch.equal(narrow.color_w, wide.color_w)

    path = str(tmp_path / "narrow.ckpt")
    checkpoints.save_checkpoint(path, narrow)
    checkpoints.load_params_partial(path, wide)
    assert torch.equal(wide.color_b[:3], narrow.color_b)
    assert not wide.color_b[3:].any()

    # the CLI: a narrow model from the wide checkpoint without map_bias
    rc = fit_one_shot.main(
        ["--synthetic", "--device", "cpu", "--height", "32", "--width", "32",
         "--steps", "1", "data.edge_subdivide=0", f"out_dir={tmp_path}",
         "model.narrow_color_b=true", "fit.weights.vgg=0",
         f"pretrained={tmp_path / 'wide.ckpt'}"] + SMALL_ARGS)
    assert rc == 0
    assert "load_params_partial: restored" in capsys.readouterr().out


def test_port_checkpoint_cli_output_loads_through_pretrained(tmp_path,
                                                             capsys):
    """cli/port_checkpoint.py writes the port's checkpoint from a reference
    one; loaded (``load_params_partial``) into a model of another seed it
    gives back every parameter the reference carried, bit for bit, keeps
    only the identity-code head and says which of the checkpoint's modules
    the avatar does not have. With ``--dinov2`` a seeded Hugging Face state
    dict goes into the generator's image tokenizer, its unmapped key
    printed with a ``dinov2:`` prefix, and comes back to the bit in the
    generator that ``load_point_generator`` builds from the output."""
    source = small_model(False, 0)
    ref = reference_state_dict(source, seed=2)
    src = tmp_path / "pretrain_model.ckpt"
    torch.save({"state_dict": ref, "epoch": 3}, src)
    out = tmp_path / "ported.ckpt"
    assert port_checkpoint.main(["--torch_ckpt", str(src), "--out", str(out),
                                 "--backbone_layers", "1"]) == 0
    said = capsys.readouterr().out
    assert f"ported {len(ref)} tensors" in said
    assert "unmapped" not in said
    n_avatar = len(ref) - 6       # the generator's 4 and the upsampler's 2
    target = small_model(False, 5)
    got = checkpoints.load_params_partial(str(out), target)
    said = capsys.readouterr().out
    assert f"restored {n_avatar}/" in said and ABSENT.format(4) in said
    assert all(k.startswith("identity_code_infer.") for k in got["missing"])
    want = source.state_dict()
    for k in got["restored"]:
        assert torch.equal(target.state_dict()[k], want[k]), k

    hf = hf_dinov2()
    torch.save(hf, tmp_path / "dinov2.bin")
    assert port_checkpoint.main(["--torch_ckpt", str(src), "--out", str(out),
                                 "--backbone_layers", "1", "--dinov2",
                                 str(tmp_path / "dinov2.bin")]) == 0
    said = capsys.readouterr().out
    assert f"ported {len(ref) + len(hf) - 2} tensors" in said
    assert "unmapped source keys (1):\n  dinov2:classifier.weight" in said
    generator = torch_port.load_point_generator(
        str(out), device="cpu", num_pcl=64, backbone_layers=1, width=64,
        layers=2, heads=2)
    n_vit = len(hf) - 2
    assert f"restored {n_vit}/{len(generator.state_dict())}" in \
        capsys.readouterr().out
    own = generator.state_dict()
    for k, v in hf.items():
        if k.startswith("dinov2.") and "mask_token" not in k:
            name = "image_tokenizer.model." + k.removeprefix("dinov2.")
            assert torch.equal(own[name], v), k


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return ih_layout.write_interhand_layout(
        tmp_path_factory.mktemp("interhand"), n_vertices=64, hw=HW)


def test_port_and_eval_dry_run(layout, tmp_path, capsys):
    """tests/test_interhand.py's dry run: the checklist runs the port's
    converter on a state dict of the published key names, marks what the
    layout holds as ok and exits 0; with the fit frame's image gone it
    exits 2 and names its path."""
    sd = {k: torch.zeros(()) for k in SPEC}
    ckpt = tmp_path / "pretrain_model.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    argv = ["--torch_ckpt", str(ckpt), "--data_root", layout["data_root"],
            "--annot_path", layout["annot_path"], "--mano", layout["mano"],
            "--dry_run"]
    assert port_and_eval.main(argv) == 0
    out = capsys.readouterr().out
    assert f"{len(SPEC)} source keys, 0 unmapped" in out
    assert "ready to execute" in out
    image = Path(layout["data_root"]) / "test" / "image" / "capture0" / \
        "cam0" / "frame0.jpg"
    saved = image.read_bytes()
    image.unlink()
    try:
        assert port_and_eval.main(argv) == 2
    finally:
        image.write_bytes(saved)
    out = capsys.readouterr().out
    assert "[MISS] fit frame image" in out and str(image) in out


def test_port_and_eval_runs_its_three_stages(layout, tmp_path):
    """cli/port_and_eval.py end to end on the CPU at a small size: the
    reference checkpoint ported with a DINOv2 state dict (``--dinov2``),
    cli/fit_one_shot.py's InterHand2.6M fit (no --synthetic) from it for 2
    steps, its PLY and checkpoint written, then --run_val over
    oneshot_reg_i's 14 frames into test_metrics.yml with the JAX package's
    keys."""
    src = tmp_path / "pretrain_model.ckpt"
    torch.save({"state_dict": reference_state_dict(small_model(False, 0),
                                                   seed=3)}, src)
    hf = hf_dinov2()
    torch.save(hf, tmp_path / "dinov2.bin")
    argv = ["--torch_ckpt", str(src), "--dinov2", str(tmp_path / "dinov2.bin"),
            "--data_root", layout["data_root"],
            "--annot_path", layout["annot_path"], "--mano", layout["mano"],
            "--backbone_layers", "1", "--steps", "2", "--device", "cpu",
            "--expname", "ih", "data.dataset=interhand",
            "data.edge_subdivide=1", "data.pose_sequence=oneshot_reg_i",
            f"data.height={HW}", f"data.width={HW}",
            "--no_images", f"out_dir={tmp_path}", "fit.weights.vgg=0"]
    assert port_and_eval.main(argv + SMALL_ARGS) == 0
    ported = torch.load(f"{src}.port.ckpt", weights_only=True)["params"]
    key = "embeddings.patch_embeddings.projection.weight"
    assert torch.equal(ported[f"{GENERATOR}image_tokenizer.model.{key}"],
                       hf[f"dinov2.{key}"])
    run = tmp_path / "ih"
    assert (run / "3dgs" / "fitted.ply").is_file()
    assert (run / "ckpts" / "last.ckpt").exists()
    scores = yaml.safe_load((run / "test_metrics.yml").read_text())
    assert set(scores) == JAX_METRIC_KEYS
    assert scores["eval_frames"] == 14
    assert all(np.isfinite(scores[k]) for k in ("psnr", "mse", "ssim"))
