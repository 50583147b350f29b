"""Every key of the JAX package's config tree loads into the port, and the
routes and losses those keys select compute what JAX computes, on the CPU:

- every leaf field of JAX's ``ExperimentConfig``, set to JAX's default in a
  YAML file of its own, loads in the port's ``load_config`` and keeps its
  value;
- ``pix_loss``'s top-K keys (``l1top<P>``, ``l2top<P>``) in value and
  gradient, at rtol 1e-6 on continuous random data (no tie decides the
  top K);
- ``model.attn_dense`` and ``model.attn_chunk`` load with no effect: the
  port's one ``SelfAttn`` route computes what JAX's dense route computes
  in eval mode (fp32 within atol 1e-5; bf16 within 4 bf16 ulps of
  max(|JAX's value|, 1/16 of the array's largest) on JAX's own q, k, v)
  and what its ``chunk_size=128`` route computes at N = 300;
- ``render_360 --synthetic`` parses and renders, as the JAX CLI's flag.
"""
import dataclasses
import json
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulps
from guassianhand_tpu import config as jconfig
from guassianhand_tpu.nn import heads as jheads
from guassianhand_tpu.train import losses as jlosses
from guassianhand_tpu_torch import config as tconfig
from guassianhand_tpu_torch.cli import render_360
from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel
from guassianhand_tpu_torch.nn import heads
from guassianhand_tpu_torch.train import losses
from tests.test_cli import TINY_OVERRIDES
from tests.torch_parity import (carried, close, japply,  # noqa: F401
                                one_torch_thread, randn, to_torch)

BF = torch.bfloat16
BF16_ULPS = 4
BF16_FLOOR = 2.0 ** -4


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_leaves(cls, prefix=()):
    """(path, JAX's default) of every leaf field of the dataclass ``cls``,
    nested dataclasses walked through."""
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        if dataclasses.is_dataclass(hints[f.name]) or \
                dataclasses.is_dataclass(default):
            yield from jax_leaves(type(default), prefix + (f.name,))
        else:
            yield prefix + (f.name,), default


def test_every_jax_config_key_loads(tmp_path):
    """Each leaf of JAX's ExperimentConfig, set explicitly to JAX's default
    in its own YAML file, loads in the port and keeps that value; a key no
    dataclass has still raises."""
    import yaml
    keys = list(jax_leaves(jconfig.ExperimentConfig))
    assert len(keys) > 90
    failed = []
    for i, (path, default) in enumerate(keys):
        value = list(default) if isinstance(default, tuple) else default
        doc = value
        for k in reversed(path):
            doc = {k: doc}
        f = tmp_path / f"key{i}.yaml"
        f.write_text(yaml.safe_dump(doc))
        try:
            got = tconfig.load_config(str(f))
            for k in path:
                got = getattr(got, k)
            if got != default:
                failed.append((".".join(path), f"{got!r} != {default!r}"))
        except Exception as e:  # noqa: BLE001 - each failure is named
            failed.append((".".join(path), repr(e)))
    assert not failed, failed
    for bad in ("model.bogus=1", "model.renderer.raster.bogus=1",
                "fit.weights.bogus=1"):
        with pytest.raises(KeyError, match="bogus"):
            tconfig.load_config(None, [bad])


def test_top_k_pixel_losses_match_jax():
    """l1top20 and l2top5 (with l1 beside them) through pix_loss: each term
    and the gradient of their sum against JAX's."""
    rng = np.random.RandomState(4)
    src = rng.uniform(0, 1, (2, 3, 16, 24)).astype(np.float32)
    tar = rng.uniform(0, 1, (2, 3, 16, 24)).astype(np.float32)
    weights = {"l1": 1.0, "l1top20": 0.5, "l2top5": 2.0}
    want = jlosses.pix_loss(jnp.asarray(src), jnp.asarray(tar), weights)
    want_grad = jax.grad(lambda s: sum(jlosses.pix_loss(
        s, jnp.asarray(tar), weights).values()))(jnp.asarray(src))
    s = to_torch(src).requires_grad_()
    got = losses.pix_loss(s, to_torch(tar), weights)
    assert set(got) == set(want) == {"l1", "l1top20", "l2top5"}
    for k in got:
        close(got[k], want[k], atol=0, rtol=1e-6)
    (grad,) = torch.autograd.grad(sum(got.values()), [s])
    close(grad, want_grad, atol=0, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_attn_dense_matches_jax(dtype):
    """The port's SelfAttn (its one route; model.attn_dense is stored with
    no effect) against JAX's SelfAttn(dense=True) in eval mode (its dropout
    off), at N = 200 with 2 samples and a key mask; masked rows pass
    through unchanged. fp32: the output within atol 1e-5. bf16, where
    JAX's two routes differ by a rounding (its dense route keeps the
    probabilities in float32, its chunked route and the port's round them
    to bf16): the attention of JAX's own bf16 q, k, v through the output
    projection, at the interacting rows, within BF16_ULPS bf16 ulps of
    max(|JAX's value|, BF16_FLOOR times the largest) of JAX's chunked
    route, and no further from JAX's dense route than JAX's chunked route
    is (6 ulps on these inputs); the whole module, whose bf16 MLP block
    after the attention turns a flipped rounding of its input into several
    ulps, within twice JAX's own bf16-vs-fp32 error of the dense route in
    norm, the measure of tests/test_torch_bf16.py."""
    assert tconfig.load_config(None, ["model.attn_dense=true"]).model \
        .attn_dense
    rng = np.random.RandomState(5)
    x = randn(rng, 2, 200, 131)
    mask = rng.uniform(size=(2, 200)) < 0.6
    bf16 = dtype == "bfloat16"
    jm = jheads.SelfAttn(dense=True, dtype=jnp.bfloat16 if bf16 else None)
    tm = heads.SelfAttn(131, compute_dtype=BF if bf16 else None)
    params = carried(jm, tm, x, mask)
    want, state = jax.jit(lambda p, x, m: jm.apply(
        p, x, m, capture_intermediates=True, mutable=["intermediates"]))(
            params, x, mask)
    with torch.no_grad():
        got = tm(to_torch(x), mask=to_torch(mask))
    np.testing.assert_array_equal(got.float().numpy()[~mask], x[~mask])
    if not bf16:
        close(got, want, atol=1e-5, rtol=0)
        return
    q, k, v = (to_torch(np.asarray(state["intermediates"][f"Dense_{i}"]
                                   ["__call__"][0].astype(jnp.float32)))
               .to(BF).reshape(2, 200, 4, 32) for i in range(3))
    tmask = to_torch(mask)
    with torch.no_grad():
        o = torch.stack([heads.blockwise_attention(q[i], k[i], v[i],
                                                   tmask[i])
                         for i in range(2)])
        routed = tm.fc(o.reshape(2, 200, 128))[tmask]

    def projected(route):
        _, st = jax.jit(lambda p, x, m: route.apply(
            p, x, m, capture_intermediates=True, mutable=["intermediates"]))(
                params, x, mask)
        return to_torch(np.asarray(st["intermediates"]["Dense_3"]["__call__"]
                                   [0].astype(jnp.float32)))[tmask]

    dense = projected(jm)
    chunked = projected(jheads.SelfAttn(dtype=jnp.bfloat16))
    ulps = float(bf16_ulps(routed, chunked, BF16_FLOOR).max())
    assert ulps <= BF16_ULPS, ulps
    jax_gap = float(bf16_ulps(chunked, dense, BF16_FLOOR).max())
    assert float(bf16_ulps(routed, dense, BF16_FLOOR).max()) <= jax_gap
    want32 = japply(jheads.SelfAttn(dense=True), params, x, mask)
    own = rel(np.asarray(want), np.asarray(want32))
    assert rel(got.float().numpy(), np.asarray(want)) <= 2.0 * own


def test_attn_chunk_reaches_the_attention():
    """model.attn_chunk = 128 loads (stored with no effect) and the model
    builds with it; at N = 300, where JAX's chunked route takes
    min(128, max(128, 300)) = 128-row query and key chunks, the port's
    SelfAttn equals JAX's SelfAttn(chunk_size=128)."""
    cfg = tconfig.load_config(None, ["model.attn_chunk=128",
                                     *TINY_OVERRIDES])
    assert cfg.model.attn_chunk == 128
    OneShotAvatarModel(cfg.model)
    rng = np.random.RandomState(6)
    x = randn(rng, 2, 300, 131)
    mask = rng.uniform(size=(2, 300)) < 0.5
    jm = jheads.SelfAttn(chunk_size=128)
    tm = heads.SelfAttn(131)
    params = carried(jm, tm, x, mask)
    with torch.no_grad():
        got = tm(to_torch(x), mask=to_torch(mask))
    close(got, japply(jm, params, x, mask), atol=1e-5, rtol=0)


def test_render_360_accepts_synthetic(tmp_path, capsys):
    """render_360 --synthetic (the JAX CLI's flag, on by default there and
    here) parses and renders the synthetic scene at a small size."""
    out = tmp_path / "frames"
    assert render_360.main(["--synthetic", "--device", "cpu", "--views", "1",
                            "--views_per_call", "1", f"--out={out}",
                            *TINY_OVERRIDES]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 1
