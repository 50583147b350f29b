"""The port's bf16 compute pipeline (``OneShotConfig.compute_dtype=
"bfloat16"``, ``backbone_softmax_fp32``, ``backbone_attn_remat``,
``VGGLoss(compute_dtype=...)``) held against the JAX package's on the CPU,
the port's mirror of tests/test_bf16.py.

bf16 rounds at other places in the two frameworks (an elementwise SiLU,
GELU or sigmoid in bf16, a softmax's sums), so no bit parity is asked for.
Each module instead runs in bf16 on the same numpy inputs and parameters as
JAX's bf16 and passes two checks: its output has JAX's type, and its
relative error (in norm) against JAX's bf16 is at most twice JAX's own
bf16-vs-fp32 error (``BF16_RATIO``), while the port's bf16 differs from its
fp32 by more than 1e-4, which shows that it ran in bf16. The masked flash
attention's twins are also held element by element against JAX's Pallas
kernel, in bf16 ulps (``FLASH_ULPS``). ``python -m tests.test_torch_bf16
--flash-ulps`` prints those ulps with the twins' forward tile at 64 and 128
keys; with no argument it prints ``JAX_OWN_BF16_ERROR`` anew.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulps
from guassianhand_tpu.nn import heads as jheads
from guassianhand_tpu.nn import pointnet as jpointnet
from guassianhand_tpu.nn import tokenizers as jtokenizers
from guassianhand_tpu.nn import transformer as jtransformer
from guassianhand_tpu.ops.blockwise_attention import \
    blockwise_attention as j_attention
from guassianhand_tpu.train import vgg as jvgg
from guassianhand_tpu_torch.compat.from_jax import load_jax_params
from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from guassianhand_tpu_torch.nn import heads, pointnet, tokenizers, transformer
from guassianhand_tpu_torch.ops.blockwise_attention import blockwise_attention
from guassianhand_tpu_torch.train import losses
from guassianhand_tpu_torch.train.fit import (FitConfig,
                                              attach_static_features,
                                              make_fit_step, make_optimizer)
from guassianhand_tpu_torch.train.vgg import VGGLoss
from tests.test_model import HW, TINY
from tests.torch_parity import (batch_to_torch, carried,  # noqa: F401
                                fit_against_jax, japply, one_torch_thread,
                                port_model_config, randn, to_torch)

BF = torch.bfloat16
# the port's bf16 against JAX's bf16: at most this many times JAX's own
# bf16-vs-fp32 error (relative, in norm)
BF16_RATIO = 2.0
# the port's bf16 against its own fp32: more than this (it ran in bf16)
RAN_IN_BF16 = 1e-4
# the flash twins against JAX's Pallas flash attention, element by element:
# in bf16 ulps of max(|JAX's value|, 1/16 of the array's largest), see
# test_flash_twins_bf16_match_jax_pallas_flash
FLASH_ULPS = 4
FLASH_FLOOR = 2.0 ** -4
# TINY with JAX raster caps wide enough that no pair is dropped (overflow 0)
JTINY = dataclasses.replace(TINY, renderer=dataclasses.replace(
    TINY.renderer, raster=dataclasses.replace(
        TINY.renderer.raster, max_tiles_per_gaussian=32,
        pairs_per_gaussian=16.0)))
TRAINED = ("identity_code_one_shot", "map_bias", "color_w", "color_b",
           "opacity_b")
# JAX's own bf16-vs-fp32 error (relative, in norm) at the bf16_fit
# fixture's setup: the first step's loss and each trained array's first
# moment, of JAX's bf16 fit against JAX's fp32 fit from the same parameters
# on the same batch, rounded down. Fixed here because the fp32 JAX fit would
# cost this file another compile; ``python -m tests.test_torch_bf16``
# prints them anew.
JAX_OWN_BF16_ERROR = {"loss": 6.52e-4, "identity_code_one_shot": 0.105,
                      "map_bias": 0.0661, "color_w": 0.00547,
                      "color_b": 0.00843, "opacity_b": 0.0341}


def rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def f32(x):
    """A JAX array, a torch tensor (any type) or a list of them as float32
    numpy."""
    if isinstance(x, (list, tuple)):
        return np.concatenate([f32(a).ravel() for a in x])
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def dtype_name(x):
    x = x[0] if isinstance(x, (list, tuple)) else x
    return str(x.dtype).removeprefix("torch.")


def assert_bf16_parity(name, port16, port32, jax16, jax32):
    """Output type JAX's; port bf16 vs JAX bf16 within BF16_RATIO x JAX's
    bf16-vs-fp32; port bf16 vs port fp32 over RAN_IN_BF16."""
    assert dtype_name(port16) == dtype_name(jax16), name
    own = rel(f32(jax16), f32(jax32))
    err = rel(f32(port16), f32(jax16))
    assert err <= BF16_RATIO * own, (name, err, own)
    assert rel(f32(port16), f32(port32)) > RAN_IN_BF16, name


def module_pair(flax16, flax32, port16, port32, *args, **kw):
    """The outputs of a flax module in bf16 and fp32 and of the port's, all
    on one set of seeded parameters and the numpy inputs ``args``."""
    params = carried(flax16, port16, *args, **kw)
    load_jax_params(port32, params)
    targs = [to_torch(a) for a in args]
    tkw = {k: to_torch(v) for k, v in kw.items()}
    with torch.no_grad():
        p16, p32 = port16(*targs, **tkw), port32(*targs, **tkw)
    return (p16, p32, japply(flax16, params, *args, **kw),
            japply(flax32, params, *args, **kw))


def case_pointnet_and_upsampler():
    rng = np.random.RandomState(0)
    x = randn(rng, 1, 200, 40)
    x[..., :2] = np.clip(0.5 * x[..., :2], -1.0, 1.0)
    yield "pointnet", module_pair(
        jpointnet.LocalPoolPointnet(c_dim=32, plane_size=8,
                                    dtype=jnp.bfloat16),
        jpointnet.LocalPoolPointnet(c_dim=32, plane_size=8),
        pointnet.LocalPoolPointnet(40, c_dim=32, plane_size=8,
                                   compute_dtype=BF),
        pointnet.LocalPoolPointnet(40, c_dim=32, plane_size=8),
        x)
    planes = randn(rng, 1, 2, 32, 8, 8)
    yield "upsampler", module_pair(
        jtokenizers.TriplaneUpsampler(out_channels=20, dtype=jnp.bfloat16),
        jtokenizers.TriplaneUpsampler(out_channels=20),
        tokenizers.TriplaneUpsampler(32, 20, compute_dtype=BF),
        tokenizers.TriplaneUpsampler(32, 20), planes)


def case_transformer():
    """Transformer1D with the softmax in fp32 and in bf16, the second with
    the attention cores rematerialised."""
    tokens = randn(np.random.RandomState(1), 1, 64, 128)
    for softmax_fp32, remat in ((True, False), (False, True)):
        kw = dict(softmax_fp32=softmax_fp32, attn_remat=remat)
        yield f"transformer softmax_fp32={softmax_fp32}", module_pair(
            jtransformer.Transformer1D(num_layers=2, heads=2, head_dim=16,
                                       dtype=jnp.bfloat16, **kw),
            jtransformer.Transformer1D(num_layers=2, heads=2, head_dim=16),
            transformer.Transformer1D(64, 2, 2, 16, compute_dtype=BF, **kw),
            transformer.Transformer1D(64, 2, 2, 16), tokens)


def case_self_attn_and_vgg():
    """SelfAttn on the chunked route, and VGGLoss's slice features (and
    its loss)."""
    rng = np.random.RandomState(2)
    x = randn(rng, 1, 300, 131)
    mask = rng.uniform(size=(1, 300)) < 0.6
    yield "self_attn", module_pair(
        jheads.SelfAttn(dropout=0.0, dtype=jnp.bfloat16),
        jheads.SelfAttn(dropout=0.0), heads.SelfAttn(131, compute_dtype=BF),
        heads.SelfAttn(131), x, mask=mask)
    img, tgt = (rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
                for _ in range(2))
    j16, j32 = jvgg.VGGLoss(compute_dtype="bfloat16"), jvgg.VGGLoss()
    t16, t32 = VGGLoss(compute_dtype="bfloat16"), VGGLoss()
    with torch.no_grad():
        features = [m.features(to_torch(img)) for m in (t16, t32)]
        loss = [m(to_torch(img), to_torch(tgt)) for m in (t16, t32)]
    # JAX's slices are NHWC
    yield "vgg features", (*features, *(
        [a.transpose(0, 3, 1, 2) for a in jax.jit(m.features)(img)]
        for m in (j16, j32)))
    # the loss, a mean over the slices, is float32 in both and within one
    # bf16 rounding (2^-9) of JAX's bf16 loss: a ratio of two such means'
    # errors, each an average of many roundings, says nothing
    want = jax.jit(j16.__call__)(img, tgt)
    assert loss[0].dtype == torch.float32 and want.dtype == jnp.float32
    assert abs(float(loss[0]) - float(want)) <= 2.0 ** -9 * abs(float(want))


@pytest.mark.parametrize("case", [case_pointnet_and_upsampler,
                                  case_transformer, case_self_attn_and_vgg],
                         ids=lambda c: c.__name__[5:])
def test_bf16_modules_match_jax(case):
    """Each module in bf16 against JAX's in bf16 (``assert_bf16_parity``)."""
    for name, outs in case():
        assert_bf16_parity(name, *outs)


def qkv_mask(n, seed):
    rng = np.random.RandomState(seed)
    q, k, v, tgt = (randn(rng, n, 4, 32) for _ in range(4))
    return q, k, v, rng.uniform(size=n) < 0.6, tgt


def jax_attention(q, k, v, mask, tgt, flash, dtype):
    """JAX's attention output and gradients of sum(f32(out) * tgt), as
    float32 numpy, with its output's type."""
    def loss(a, b, c):
        o = j_attention(a, b, c, jnp.asarray(mask), q_chunk=256, k_chunk=256,
                        flash=flash)
        return jnp.sum(o.astype(jnp.float32) * tgt), o
    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return o, list(g)


def port_attention(q, k, v, mask, tgt, flash):
    leaves = [to_torch(x).to(BF).requires_grad_() for x in (q, k, v)]
    o = blockwise_attention(*leaves, to_torch(mask), flash=flash)
    grads = torch.autograd.grad((o.float() * to_torch(tgt)).sum(), leaves)
    return o.detach(), list(grads)


def flash_twins_against_jax_pallas():
    """The bf16 flash route on the CPU and JAX's Pallas flash attention in
    bf16 (TPU interpret mode) on the same inputs, n = 512: for out, dq, dk
    and dv, (the port's, JAX's bf16, JAX's fp32 from the scan path); the
    mask."""
    from jax.experimental.pallas import tpu as pltpu
    q, k, v, mask, tgt = qkv_mask(512, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention(q, k, v, mask, tgt, True, jnp.bfloat16)
    want32 = jax_attention(q, k, v, mask, tgt, False, jnp.float32)
    got = port_attention(q, k, v, mask, tgt, flash=True)
    return (dict(zip(("out", "dq", "dk", "dv"),
                     zip([got[0], *got[1]], [want[0], *want[1]],
                         [want32[0], *want32[1]]))), mask)


def flash_ulps(arrays) -> dict:
    """The largest |port - JAX| of each array in bf16 ulps of max(|JAX's
    value|, FLASH_FLOOR x the array's largest)."""
    return {name: float(bf16_ulps(a, torch.tensor(f32(b)), FLASH_FLOOR).max())
            for name, (a, b, _) in arrays.items()}


def test_flash_twins_bf16_match_jax_pallas_flash():
    """The bf16 flash route on the CPU (gather, the bf16 twins through
    ``FlashAttention``, scatter) against JAX's Pallas flash attention in
    bf16, in TPU interpret mode, n = 512: out, dq, dk and dv bf16 as JAX's,
    each element within FLASH_ULPS = 4 bf16 ulps of max(|JAX's value|, 1/16
    of the array's largest |value|). The twins round P to bf16 against the
    running maximum of 128-key tiles, JAX's default block_k
    (``tests/test_torch_attention_tile.py``), so the points where P is rounded
    are JAX's own when the keys are not gathered. JAX's kernel runs over the
    padded, ungathered keys with the mask as segment ids, so with a mask its
    blocks hold fewer live keys than the twins' tiles: P is then rounded
    against another maximum, and each P so rounded apart moves a sum by 2^-8
    of its term, which near 0 is several ulps of the value. Also within
    BF16_RATIO x JAX's own bf16-vs-fp32 error in norm (its fp32 from the
    scan path, which JAX's tests hold equal to its flash path); masked rows
    0."""
    arrays, mask = flash_twins_against_jax_pallas()
    ulps = flash_ulps(arrays)
    for name, (a, b, b32) in arrays.items():
        assert dtype_name(a) == dtype_name(b) == "bfloat16", name
        assert ulps[name] <= FLASH_ULPS, (name, ulps[name])
        assert rel(a, f32(b)) <= BF16_RATIO * rel(f32(b), f32(b32)), name
        np.testing.assert_array_equal(f32(a)[~mask], 0.0)


def test_chunked_route_bf16_matches_jax_scan():
    """The chunked route on bf16 q, k, v against JAX's scan path
    (``blockwise_attention(flash=False)``) in bf16: a float32 output in
    both, and the output and gradients within BF16_RATIO x JAX's own
    bf16-vs-fp32 error."""
    q, k, v, mask, tgt = qkv_mask(700, seed=2)
    got = port_attention(q, k, v, mask, tgt, flash=False)
    want = jax_attention(q, k, v, mask, tgt, False, jnp.bfloat16)
    want32 = jax_attention(q, k, v, mask, tgt, False, jnp.float32)
    assert got[0].dtype == torch.float32 and want[0].dtype == jnp.float32
    for name, a, b, b32 in zip(("out", "dq", "dk", "dv"), [got[0], *got[1]],
                               [want[0], *want[1]], [want32[0], *want32[1]]):
        assert rel(a, f32(b)) <= BF16_RATIO * rel(f32(b), f32(b32)), name


def test_attn_remat_is_bit_exact():
    """Transformer1D with the attention cores rematerialised against
    without, in fp32 and in bf16 (softmax in fp32 and in bf16): the output
    and the tokens' gradient equal to the bit."""
    rng = np.random.RandomState(3)
    tokens, tgt = randn(rng, 1, 64, 128), randn(rng, 1, 64, 128)
    for dtype, softmax_fp32 in ((None, True), (BF, True), (BF, False)):
        results = []
        for remat in (False, True):
            torch.manual_seed(0)
            m = transformer.Transformer1D(64, 2, 2, 16, compute_dtype=dtype,
                                          softmax_fp32=softmax_fp32,
                                          attn_remat=remat)
            x = to_torch(tokens).requires_grad_()
            y = m(x)
            (g,) = torch.autograd.grad((y * to_torch(tgt)).sum(), [x])
            results.append((y.detach(), g))
        (y0, g0), (y1, g1) = results
        assert torch.equal(y0, y1) and torch.equal(g0, g1), (dtype,
                                                             softmax_fp32)


@pytest.fixture(scope="module")
def bf16_fit():
    """One fit step of the TINY model in bf16 in both packages, from one
    set of parameters on one batch (``fit_against_jax``), and the port's
    fp32 and bf16 models on those parameters: their renders and one fit
    step's gradients."""
    run = fit_against_jax(dataclasses.replace(JTINY, compute_dtype="bfloat16"),
                          dataclasses.replace(TINY, compute_dtype="bfloat16"),
                          HW, 1)
    port = {}
    for dtype in (None, "bfloat16"):
        cfg = dataclasses.replace(port_model_config(dataclasses.replace(
            TINY, renderer=JTINY.renderer)), compute_dtype=dtype)
        model = OneShotAvatarModel(cfg).eval()
        load_jax_params(model, run["params"])
        fit_cfg = FitConfig(weights=losses.LossWeights(vgg=0.1),
                            steps_per_epoch=1, epochs=1)
        opt, sched = make_optimizer(model, fit_cfg)
        step = make_fit_step(model, VGGLoss(), opt, sched, fit_cfg,
                             height=HW, width=HW)
        batch = attach_static_features(model, batch_to_torch(run["batch"]))
        with torch.no_grad():
            out = model(batch, HW, HW)
        loss, _ = step(batch)
        port[dtype] = {"model": model, "out": out, "loss": float(loss),
                       "grads": {n: opt.state[p]["exp_avg"].numpy()
                                 for n, p in model.named_parameters()
                                 if p in opt.state}}
    return run, port


def test_bf16_parameters_are_float32_and_load_alike(bf16_fit):
    """compute_dtype bf16 leaves the parameters as they are: the same
    state_dict names and shapes, all float32, and one flax tree
    (``load_jax_params``) loads into the bf16 and the fp32 model alike."""
    _, port = bf16_fit
    sd32 = port[None]["model"].state_dict()
    sd16 = port["bfloat16"]["model"].state_dict()
    assert list(sd32) == list(sd16)
    for name, a in sd32.items():
        b = sd16[name]
        assert a.dtype == b.dtype == torch.float32, name
        assert a.shape == b.shape, name
    fresh = [OneShotAvatarModel(port_model_config(dataclasses.replace(
        TINY, compute_dtype=dt))) for dt in (None, "bfloat16")]
    for model in fresh:
        load_jax_params(model, bf16_fit[0]["params"])
    for name, a in fresh[0].state_dict().items():
        assert torch.equal(a, fresh[1].state_dict()[name]), name


def test_bf16_model_render_and_fit_step_match_jax(bf16_fit):
    """The TINY model in bf16, mirroring tests/test_bf16.py's forward and
    gradient tests on the fit's setup:
    - ``hidden`` is float32 and within 5 % of its scale of the fp32
      model's, the render float32 with a mean |difference| under 5e-3
      (test_bf16_forward_close_to_fp32's bounds; its max bound of 0.06 is
      stated for its smaller scene: JAX's own bf16 render differs from its
      fp32 by 0.10 at the worst pixel of this one);
    - one fit step in bf16 against JAX's in bf16: the loss, and each
      trained array's gradient (Adam's first moment), within BF16_RATIO x
      JAX's own bf16-vs-fp32 error (``JAX_OWN_BF16_ERROR``);
    - the bf16 gradients finite, nonzero and pointing as the fp32 ones:
      cosine > 0.98, norm ratio in (0.8, 1.25)
      (test_bf16_fit_gradients_flow_and_match_fp32_direction's bounds)."""
    run, port = bf16_fit
    p32, p16 = port[None], port["bfloat16"]
    h32, h16 = p32["out"]["hidden"], p16["out"]["hidden"]
    assert h16.dtype == torch.float32
    assert float((h16 - h32).abs().max()) <= 0.05 * float(h32.abs().max())
    rgb16, rgb32 = p16["out"]["comp_rgb"], p32["out"]["comp_rgb"]
    assert rgb16.dtype == torch.float32
    assert float((rgb16 - rgb32).abs().mean()) < 5e-3
    assert p16["loss"] == run["t_losses"][0]
    assert (abs(p16["loss"] - run["j_losses"][0]) / abs(run["j_losses"][0])
            <= BF16_RATIO * JAX_OWN_BF16_ERROR["loss"])
    for key in TRAINED:
        g16, g32 = p16["grads"][key], p32["grads"][key]
        assert np.isfinite(g16).all() and np.abs(g16).max() > 0, key
        assert (rel(g16, run["j_mu"][key])
                <= BF16_RATIO * JAX_OWN_BF16_ERROR[key]), key
        a, b = g32.ravel().astype(np.float64), g16.ravel().astype(np.float64)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.98, (key, cos)
        assert 0.8 < np.linalg.norm(b) / np.linalg.norm(a) < 1.25, key


def jax_own_bf16_error() -> dict:
    """``JAX_OWN_BF16_ERROR`` measured: JAX's bf16 fit step against its
    fp32 one on the bf16_fit fixture's parameters and batch."""
    runs = [fit_against_jax(dataclasses.replace(JTINY, compute_dtype=dt),
                            dataclasses.replace(TINY, compute_dtype=dt),
                            HW, 1) for dt in ("bfloat16", None)]
    (l16,), (l32,) = (r["j_losses"] for r in runs)
    return {"loss": abs(l16 - l32) / abs(l32),
            **{key: rel(runs[0]["j_mu"][key], runs[1]["j_mu"][key])
               for key in TRAINED}}


def flash_ulps_by_tile(tiles=(64, 128)) -> dict:
    """``test_flash_twins_bf16_match_jax_pallas_flash``'s largest ulps of
    out, dq, dk and dv with the twins' forward tile set to each of
    ``tiles``."""
    from guassianhand_tpu_torch.ops import flash_attention_cuda
    saved = flash_attention_cuda.KERNEL_TILE
    try:
        out = {}
        for tile in tiles:
            flash_attention_cuda.KERNEL_TILE = tile
            out[tile] = flash_ulps(flash_twins_against_jax_pallas()[0])
        return out
    finally:
        flash_attention_cuda.KERNEL_TILE = saved


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--flash-ulps"]:
        print(flash_ulps_by_tile())
    else:
        print(jax_own_bf16_error())
