"""The PyTorch port's point-cloud generator held against the JAX package on
the CPU: the image resize that the DINOv2 tokenizer's position embeddings
and ``ImageFeature`` go through, the tokenizer itself (``nn/
image_tokenizer.py``), ``Transformer1D`` with a context and a modulation
condition, ``ImageFeature`` and ``SimplePointGenerator`` (``models/
point_generator.py``: the one-shot bypass ``forward`` and ``generate``), and
``compat/torch_port.port_dinov2_backbone``.

Parameters are made with numpy from a seed (no zero leaf: the zero-
initialised modulations and point head get values too) and carried across
with ``compat/from_jax.load_jax_params``. Tolerance: max |port - JAX| <=
1e-4 * max(1, max |JAX|) in float32 (the resize: 1e-6); the DINOv2
mapping exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.compat.torch_port import port_dinov2_backbone as j_port
from guassianhand_tpu.models import point_generator as jpg
from guassianhand_tpu.nn import image_tokenizer as jtok
from guassianhand_tpu.nn import transformer as jtr
from guassianhand_tpu_torch.compat.from_jax import (load_jax_params,
                                                    state_dict_from_jax)
from guassianhand_tpu_torch.compat.torch_port import port_dinov2_backbone
from guassianhand_tpu_torch.models import point_generator as pg
from guassianhand_tpu_torch.nn import image_tokenizer as tok
from guassianhand_tpu_torch.nn import transformer as tr
from tests.torch_parity import (carry, hf_dinov2, japply,  # noqa: F401
                                one_torch_thread, positive_variances,
                                random_params, scaled_close, to_torch)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_resize_equals_jax_image_resize(method):
    """Up (16 -> 18, the flagship's 252^2 grid) and down (16 -> 3, with
    jax's antialiasing), and odd shapes: the weights as jax computes them,
    where F.interpolate's bicubic (a = -0.75, clamped edges) is 0.27 off."""
    x = np.random.RandomState(0).normal(size=(2, 16, 16, 5)).astype(
        np.float32)
    for h, w in ((18, 18), (3, 3), (7, 23), (256, 256)):
        want = jax.image.resize(x, (2, h, w, 5), method)
        scaled_close(tok.resize(to_torch(x), h, w, method), want, rtol=1e-6)


def test_image_tokenizer_small_width_at_32():
    """A 64-wide, 2-layer tokenizer on a 32^2 image: 3 x 3 patches, so the
    patch embedding pads SAME (5 pixels each side) and the position grid
    shrinks from 16 x 16; modulated by a camera embedding."""
    rng = np.random.RandomState(1)
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 40)).astype(np.float32)
    jm = jtok.ImageTokenizer(width=64, layers=2, heads=2)
    tm = tok.ImageTokenizer(width=64, layers=2, heads=2, cond_dim=40)
    p = carry(jm, tm, img, cond, seed=2)
    with torch.no_grad():
        got = tm(to_torch(img), to_torch(cond))
    assert got.shape == (2, 10, 64)
    scaled_close(got, japply(jm, p, img, cond))


def test_transformer1d_with_context_and_modulation():
    """Cross-attention to 7 context tokens of another width, and the
    AdaLN-continuous norms under a condition vector."""
    rng = np.random.RandomState(3)
    tokens = rng.normal(size=(2, 64, 12)).astype(np.float32)
    cond = rng.normal(size=(2, 20)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, 48)).astype(np.float32)
    jm = jtr.Transformer1D(num_layers=2, heads=2, head_dim=16, norm_groups=8,
                           modulation_dim=20)
    tm = tr.Transformer1D(64, num_layers=2, heads=2, head_dim=16,
                          norm_groups=8, context_dim=48, modulation_dim=20)
    p = carry(jm, tm, tokens, cond, ctx, seed=4)
    with torch.no_grad():
        got = tm(*(to_torch(a) for a in (tokens, cond, ctx)))
    scaled_close(got, japply(jm, p, tokens, cond, ctx))


def test_image_feature():
    """RGB, the tokens (CLS dropped) resized to the image, the mask and its
    distance channel, padded to 773."""
    rng = np.random.RandomState(5)
    rgb = rng.uniform(size=(2, 40, 40, 3)).astype(np.float32)
    tokens = rng.normal(size=(2, 1 + 25, 768)).astype(np.float32)
    mask = np.zeros((2, 40, 40), np.float32)
    mask[0, 10:30, 12:25] = 1
    mask[1, 5:9, 30:38] = 1
    want = japply(jpg.ImageFeature(), {}, rgb, tokens, mask)
    got = pg.ImageFeature()(*(to_torch(a) for a in (rgb, tokens, mask)))
    assert got.shape == (2, 40, 40, 773)
    scaled_close(got, want)


@pytest.fixture(scope="module")
def generators():
    """JAX's SimplePointGenerator at num_pcl 64 with 1 backbone layer (the
    tokenizer is a ViT-B/14, fixed in JAX's generator) on seeded
    parameters, initialised through ``generate`` on one 28^2 image, and
    the port's with them."""
    kw = dict(num_pcl=64, backbone_layers=1, up_factors=(2, 4))
    jm = jpg.SimplePointGenerator(**kw)
    rng = np.random.RandomState(6)
    img = rng.uniform(0, 1, (1, 28, 28, 3)).astype(np.float32)
    cam = rng.normal(size=(1, 25)).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jm.init(k, img, cam, method=jpg.SimplePointGenerator.
                          generate), jax.random.PRNGKey(0))
    params = positive_variances(random_params(shapes, 7))
    tm = pg.SimplePointGenerator(**kw).eval()
    load_jax_params(tm, params)
    return jm, tm, params, img, cam


def test_point_generator_bypass(generators):
    """``forward``: 300 posed points FPS'd to 64, upsampled x8, conditioned
    on the learned point tokens."""
    jm, tm, params, _, _ = generators
    pts = (0.2 * np.random.RandomState(8).normal(size=(1, 300, 3))).astype(
        np.float32)
    want = japply(jm, params, pts)
    with torch.no_grad():
        got = tm(to_torch(pts))
    assert got.shape == (1, 512, 3)
    scaled_close(got, want)


def test_point_generator_generate(generators):
    """``generate``: the modulated DINOv2 tokens of one 28^2 image (2 x 2
    patches and CLS) as the backbone's context, xyz from the point tokens,
    the decoder conditioned on the patch tokens."""
    jm, tm, params, img, cam = generators
    want = japply(jm, params, img, cam, method=jpg.SimplePointGenerator.
                  generate)
    with torch.no_grad():
        got = tm.generate(to_torch(img), to_torch(cam))
    assert got.shape == (1, 512, 3)
    scaled_close(got, want)


def test_port_dinov2_backbone_matches_jax():
    """Every key maps but the mask token (dropped) and the classifier
    (reported), as JAX's converter reports; the ported tensors equal JAX's
    tree carried into the port to the bit; the tokens agree at 224^2."""
    sd = hf_dinov2()
    ported, unmapped = port_dinov2_backbone(sd, num_layers=2)
    j_params, j_unmapped = j_port(sd, num_layers=2)
    assert unmapped == j_unmapped == ["classifier.weight"]
    assert len(ported) == len(sd) - 2
    model = tok.ImageTokenizer(width=64, layers=2, heads=2)
    want = state_dict_from_jax(model, j_params)
    for k, v in ported.items():
        assert torch.equal(v, torch.from_numpy(want[k])), k
    missing, unexpected = model.load_state_dict(ported, strict=False)
    assert unexpected == [] and all(k.startswith("modulations.")
                                    for k in missing)
    img = np.random.RandomState(10).uniform(size=(1, 224, 224, 3)).astype(
        np.float32)
    got = model(to_torch(img))
    scaled_close(got, japply(jtok.ImageTokenizer(width=64, layers=2,
                                                 heads=2),
                             {"params": j_params}, img))
