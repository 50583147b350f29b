"""The PyTorch port's evaluation path and the fitted avatar's export held
against the JAX package on the CPU: the image metrics, LPIPS on the seeded
random AlexNet, the rays' box mask, the PLY writer and reader and
``concatenate``, the native image decoder, and the fit CLI's
``--run_val`` and PLY export with the turntable CLI's ``--ckpt``.

Inputs are numpy arrays made from seeds and handed to both packages.
Tolerances, each with its reason:
- mse, psnr, ssim: atol 1e-6 (fp32 sums of a few terms in another order);
- LPIPS: atol 1e-5 (five convolutions, their sums in another order);
- the box mask, its bounds, the PLY bytes, ``concatenate``, the decoded
  pixels: exact (the same numpy arithmetic, or no arithmetic).
"""

import numpy as np
import pytest
import torch
import yaml

from guassianhand_tpu.core import gaussians as jgaussians
from guassianhand_tpu.data import native_loader as jloader
from guassianhand_tpu.data import rays as jrays
from guassianhand_tpu.train import lpips as jlpips
from guassianhand_tpu.train import metrics as jmetrics
from guassianhand_tpu_torch.cli import fit_one_shot, render_360
from guassianhand_tpu_torch.core import gaussians as tgaussians
from guassianhand_tpu_torch.data import native_loader as tloader
from guassianhand_tpu_torch.data import rays as trays
from guassianhand_tpu_torch.train import lpips as tlpips
from guassianhand_tpu_torch.train import metrics as tmetrics
from guassianhand_tpu_torch.utils.saving import save_image
from tests.torch_parity import (close, one_torch_thread,  # noqa: F401
                                randn, to_torch)

TINY_ARGS = ["--synthetic", "--device", "cpu", "--height", "32", "--width",
             "32", "data.edge_subdivide=0", "model.camera_embed_dim=32",
             "model.pose_embed_dim=32", "model.plane_size=8",
             "model.token_channels=32", "model.backbone_layers=1",
             "model.backbone_heads=2", "model.backbone_head_dim=16",
             "model.residual_map_hw=[32,64]"]
# the keys guassianhand_tpu/cli/fit_one_shot.py --run_val writes on a
# device without memory statistics (the CPU), with no LPIPS weights
JAX_METRIC_KEYS = {"psnr", "mse", "ssim", "eval_frames", "eval_wall_s",
                   "eval_frames_per_s", "weights_provenance"}


def test_metrics_match_jax():
    """mse, psnr and ssim of seeded images, and ssim on the crop to a
    mask's bounding box, as the evaluation scores it."""
    rng = np.random.RandomState(0)
    pred = rng.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    tgt = np.clip(pred + randn(rng, 40, 52, 3, scale=0.1), 0, 1)
    mask = np.zeros((40, 52), bool)
    mask[7:31, 11:44] = rng.uniform(size=(24, 33)) > 0.3
    for name in ("mse", "psnr", "ssim"):
        close(getattr(tmetrics, name)(to_torch(pred), to_torch(tgt)),
              getattr(jmetrics, name)(pred, tgt), atol=1e-6, rtol=0)
    crops = [tmetrics.bbox_crop(to_torch(x), mask) for x in (pred, tgt)]
    want = [jmetrics.bbox_crop(x, mask) for x in (pred, tgt)]
    assert crops[0].shape == want[0].shape == (24, 33, 3)
    np.testing.assert_array_equal(crops[0].numpy(), want[0])
    close(tmetrics.ssim(*crops), jmetrics.ssim(*want), atol=1e-6, rtol=0)
    assert tmetrics.bbox_crop(pred, np.zeros_like(mask)) is pred


def test_lpips_random_alexnet_matches_jax(monkeypatch):
    """Without weights both packages build the seeded random AlexNet
    (``_random_params``) and say it is not the published LPIPS."""
    monkeypatch.delenv("GH_LPIPS_WEIGHTS", raising=False)
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 1, (2, 64, 72, 3)).astype(np.float32)
    y = np.clip(x + randn(rng, 2, 64, 72, 3, scale=0.2), 0, 1)
    metric, jmetric = tlpips.LPIPS(), jlpips.LPIPS()
    assert not metric.pretrained and not jmetric.pretrained
    for a, b in zip(tlpips._random_params()[0], jlpips._random_params()[0]):
        np.testing.assert_array_equal(a[0], b[0])
    with torch.no_grad():
        got = tlpips.lpips_from_01(metric, to_torch(x), to_torch(y))
    want = jlpips.lpips_from_01(jmetric, x, y)
    assert got.shape == (2,)
    close(got, want, atol=1e-5, rtol=0)


def test_mask_at_box_and_bounds_equal_jax():
    """The posed points' padded box and the pixels whose rays cross it,
    from the synthetic scene's camera; near and far too."""
    rng = np.random.RandomState(2)
    points = randn(rng, 500, 3, scale=0.04)
    K = np.array([[57.6, 0, 32], [0, 57.6, 24], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 0.6
    bounds = trays.bounds_from_points(points)
    np.testing.assert_array_equal(bounds, jrays.bounds_from_points(points))
    got = trays.get_mask_at_box(bounds, K, w2c[:3, :3], w2c[:3, 3], 48, 64)
    want = jrays.get_mask_at_box(bounds, K, w2c[:3, :3], w2c[:3, 3], 48, 64)
    np.testing.assert_array_equal(got[0], want[0])
    assert 0 < got[0].mean() < 1
    assert got[1:] == want[1:]


def gaussian_arrays(seed: int, n: int, sh: int):
    rng = np.random.RandomState(seed)
    return dict(xyz=randn(rng, n, 3), opacity=rng.uniform(
                    0, 1, (n, 1)).astype(np.float32),
                rotation=randn(rng, n, 4),
                scaling=np.abs(randn(rng, n, 3, scale=0.01)),
                shs=randn(rng, n, sh, 3),
                valid=(rng.uniform(size=n) > 0.3).astype(np.float32))


def test_ply_bytes_round_trip_and_concatenate_equal_jax(tmp_path):
    """``to_ply`` writes the JAX package's bytes (invalid slots dropped,
    opacity as its logit, scales as their logs, 16 SH coefficients);
    ``from_ply`` reads back what JAX's reads; ``concatenate`` joins the
    buffers and their validity as JAX's does, with or without a mask."""
    a, b = gaussian_arrays(3, 50, 16), gaussian_arrays(4, 20, 16)
    ta = tgaussians.Gaussians(**{k: to_torch(v) for k, v in a.items()})
    ja = jgaussians.Gaussians(**a)
    ta.to_ply(str(tmp_path / "port.ply"))
    ja.to_ply(str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
    back = tgaussians.from_ply(str(tmp_path / "port.ply"), device="cpu")
    jback = jgaussians.from_ply(str(tmp_path / "jax.ply"))
    keep = a["valid"] > 0.5
    assert back.n == int(keep.sum()) and back.valid is None
    for name in ("xyz", "opacity", "rotation", "scaling", "shs"):
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(jback, name)))
    np.testing.assert_allclose(back.scaling.numpy(), a["scaling"][keep],
                               rtol=1e-6)
    for second in (b, {k: v for k, v in b.items() if k != "valid"}):
        got = tgaussians.concatenate(ta, tgaussians.Gaussians(
            **{k: to_torch(v) for k, v in second.items()}))
        want = jgaussians.concatenate(ja, jgaussians.Gaussians(**second))
        for name in ("xyz", "opacity", "rotation", "scaling", "shs", "valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))


def test_decode_image_equals_jax(tmp_path):
    """A PNG written by the port's encoder decodes to the same pixels
    through the port's and the JAX package's ``decode_image`` (the same
    native library), exactly the image written; so does the decode pool,
    with the image as its own mask."""
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (37, 45, 3)).astype(np.uint8)
    path = save_image(str(tmp_path / "img.png"), img)
    lib, reason = tloader.native_library()
    assert lib is not None, reason
    got = tloader.decode_image(path)
    np.testing.assert_array_equal(got, jloader.decode_image(path))
    np.testing.assert_array_equal(np.round(got * 255.0).astype(np.uint8), img)
    pool, jpool = tloader.PrefetchPool(2), jloader.PrefetchPool(2)
    try:
        rgb, mask = pool.wait(pool.submit(path, path))
        jrgb, jmask = jpool.wait(jpool.submit(path, path))
    finally:
        pool.close()
        jpool.close()
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.mean() < 1


def test_native_build_failure_is_reported(tmp_path, monkeypatch):
    """Where the library is missing and cannot be built, the reason is
    kept, and without PIL the decoder's error names it."""
    monkeypatch.setattr(tloader, "NATIVE_DIR", str(tmp_path))
    tloader._library.cache_clear()
    monkeypatch.setenv("PATH", str(tmp_path))
    try:
        lib, reason = tloader.native_library()
        assert lib is None and "make" in reason
        monkeypatch.setitem(__import__("sys").modules, "PIL", None)
        with pytest.raises(RuntimeError, match="`make` is not installed"):
            tloader.decode_image(str(tmp_path / "x.png"))
    finally:
        tloader._library.cache_clear()


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A one-step fit at a tiny size on the CPU: its run directory."""
    out = tmp_path_factory.mktemp("runs")
    assert fit_one_shot.main([*TINY_ARGS, "--steps", "1", f"out_dir={out}",
                              "expname=fit"]) == 0
    return out / "fit"


def test_fit_writes_ply_and_run_val_writes_jax_metric_keys(fitted, capsys):
    """The fit's ``3dgs/fitted.ply`` reads in the JAX package, one
    Gaussian a valid slot; ``--run_val --val_frames 2 --no_images``
    evaluates the fit's checkpoint and writes test_metrics.yml with the
    keys JAX writes on the CPU (no LPIPS without its weights)."""
    ply = jgaussians.from_ply(str(fitted / "3dgs" / "fitted.ply"))
    assert ply.n > 0 and np.isfinite(np.asarray(ply.xyz)).all()
    capsys.readouterr()
    assert fit_one_shot.main([*TINY_ARGS, "--run_val", "--val_frames", "2",
                              "--no_images", f"out_dir={fitted.parent}",
                              "expname=fit"]) == 0
    assert "evaluating checkpoint" in capsys.readouterr().out
    metrics = yaml.safe_load((fitted / "test_metrics.yml").read_text())
    assert set(metrics) == JAX_METRIC_KEYS
    assert metrics["eval_frames"] == 2
    assert all(np.isfinite(metrics[k]) for k in ("psnr", "mse", "ssim"))
    assert metrics["weights_provenance"]["lpips_alex"] == \
        "absent (lpips omitted)"
    assert not (fitted / "images").exists()


def test_render_360_renders_the_checkpoint(fitted, tmp_path):
    """``cli/render_360.py --ckpt`` renders the fitted parameters: its
    frames differ from the seeded model's, and a missing file is
    refused."""
    args = ["--views", "2", "--views_per_call", "2", "--height", "32",
            "--width", "32", "--subdivide", "0", "--device", "cpu",
            *TINY_ARGS[7:]]
    ckpt = str(fitted / "ckpts" / "last.ckpt")
    assert render_360.main([*args, "--ckpt", ckpt,
                            f"--out={tmp_path / 'fit'}"]) == 0
    assert render_360.main([*args, f"--out={tmp_path / 'seed'}"]) == 0
    for i in range(2):
        a = (tmp_path / "fit" / f"{i:04d}.png").read_bytes()
        assert a[:4] == b"\x89PNG"
        assert a != (tmp_path / "seed" / f"{i:04d}.png").read_bytes()
    with pytest.raises(SystemExit):
        render_360.main([*args, "--ckpt", str(tmp_path / "none.ckpt")])
