"""The port's sharded path on 4 gloo CPU ranks, held against the JAX
package and the port's unsharded step.

One module-scoped spawn of 4 ranks (``tests/torch_parallel_ranks.py``)
runs every case once, while this process computes the JAX references; the
tests assert on the ranks' saved results:

- ``sharded_rasterize_batch`` on data 2 x model 2 and data 1 x model 4 at
  tests/test_parallel.py's multiview SH case (48 px, B 2, V 2, 128
  Gaussians, SH degree 1), and ``sharded_rasterize`` at its single-view
  row-band case (64 px, 256 Gaussians), against JAX's ``rasterize_multiview``
  / ``rasterize`` (Pallas in interpret mode, no tile cap reached):
  forward atol 1e-5, gradients atol 1e-4 * scale + rtol 1e-3;
- a capacity of half the busiest bucket: overflow > 0, the pairs it
  dropped;
- ``ring_blockwise_attention`` at D = 4 against JAX's under shard_map on 4
  of the conftest's 8 virtual devices, atol 2e-5, rtol 1e-4;
- the sharded fit step at data 2 x model 2 on tests/test_parallel.py's
  config (HW 32, 64-vertex scene, vgg 0), without the exchange through the
  static prefix and with it: loss rtol 1e-4, color_w, opacity_b and
  map_bias after the update atol 1e-5 against the port's unsharded
  ``make_fit_step`` on the B = 2 batch (poses from seeds 0 and 1; held
  against JAX's by tests/test_torch_train.py), and the reduced gradients of every trainable
  at the gradient tolerance above (Adam's first update is lr * sign(g),
  blind to a gradient's scale);
- ``parallel/dryrun.py``'s step, with the JAX dryrun's assertions.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from guassianhand_tpu.ops.blockwise_attention import \
    ring_blockwise_attention as j_ring
from guassianhand_tpu.ops.rasterize import rasterize as j_rasterize
from guassianhand_tpu.ops.rasterize import rasterize_multiview as j_multiview
from guassianhand_tpu_torch.parallel.dryrun import join
from tests import torch_parallel_ranks as ranks
from tests.test_torch_rasterize import JCFG
from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.utils import make_camera, make_gaussians

FWD_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3


def multiview_inputs():
    """tests/test_parallel.py::test_sharded_rasterize_batch_multiview_sh's
    inputs."""
    hw, b, v = 48, 2, 2
    cam = make_camera(hw, hw)
    rng = np.random.RandomState(0)
    gs = [make_gaussians(128, seed=7 + i, sh_degree=1) for i in range(b)]
    w2c2 = np.asarray(cam.w2c).copy()
    w2c2[0, 3] += 0.05
    w2cs = np.stack([np.asarray(cam.w2c), w2c2])[None].repeat(b, axis=0)
    ks = np.broadcast_to(np.asarray(cam.K), (b, v, 3, 3)).copy()
    bg = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (b, v, hw, hw, 3)).astype(np.float32)
    arrays = {k: np.stack([np.asarray(getattr(g, k)) for g in gs])
              for k in ("xyz", "opacity", "rotation", "scaling", "shs")}
    return {**arrays, "w2cs": w2cs.astype(np.float32),
            "Ks": ks.astype(np.float32), "bg": bg, "tgt": tgt,
            "hw": np.array(hw)}


def single_view_inputs():
    """tests/test_parallel.py::test_sharded_rasterize_matches_unsharded's
    inputs, keys prefixed ``sv_``."""
    hw = 64
    cam = make_camera(hw, hw)
    g = make_gaussians(256, seed=4)
    out = {k: np.asarray(getattr(g, k)) for k in
           ("xyz", "opacity", "rotation", "scaling", "shs")}
    out.update(w2c=np.asarray(cam.w2c), K=np.asarray(cam.K),
               bg=np.array([0.2, 0.1, 0.3], np.float32),
               tgt=np.random.RandomState(0).uniform(
                   0, 1, (hw, hw, 3)).astype(np.float32), hw=np.array(hw))
    return {f"sv_{k}": v for k, v in out.items()}


def ring_inputs():
    """tests/test_parallel.py::test_ring_attention_matches_dense's."""
    n, h, d = 64, 2, 8
    rng = np.random.RandomState(0)
    q, k, v = (rng.normal(size=(n, h, d)).astype(np.float32)
               for _ in range(3))
    return {"ring_q": q, "ring_k": k, "ring_v": v,
            "ring_mask": rng.uniform(size=n) > 0.3}


def jax_multiview(p):
    """JAX's rasterize_multiview of each sample, and the gradients of the
    batch's mean |rgb - tgt| with respect to xyz and shs."""
    from guassianhand_tpu.core.gaussians import Gaussians
    hw = int(p["hw"])

    def render(xyz, shs):
        g = Gaussians(xyz=xyz, opacity=jnp.asarray(p["opacity"]),
                      rotation=jnp.asarray(p["rotation"]),
                      scaling=jnp.asarray(p["scaling"]), shs=shs)
        return jax.vmap(lambda gg, w, k, bg: j_multiview(
            gg, w, k, height=hw, width=hw, background=bg, sh_degree=1,
            use_rgb=False, config=JCFG))(g, jnp.asarray(p["w2cs"]),
                                         jnp.asarray(p["Ks"]),
                                         jnp.asarray(p["bg"]))

    def loss(xyz, shs):
        out = render(xyz, shs)
        return jnp.abs(out["comp_rgb"] - p["tgt"]).mean(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(p["xyz"]),
                                             jnp.asarray(p["shs"]))
    assert int(np.asarray(out["overflow"]).sum()) == 0
    return {"rgb": np.asarray(out["comp_rgb"]),
            "mask": np.asarray(out["comp_mask"]),
            "grad_xyz": np.asarray(grads[0]),
            "grad_shs": np.asarray(grads[1])}


def jax_single_view(p):
    from guassianhand_tpu.core.camera import Camera
    from guassianhand_tpu.core.gaussians import Gaussians
    p = {k[3:]: v for k, v in p.items() if k.startswith("sv_")}
    hw = int(p["hw"])
    cam = Camera.from_w2c(jnp.asarray(p["w2c"]), jnp.asarray(p["K"]), hw, hw)

    def loss(xyz, shs, opacity):
        g = Gaussians(xyz=xyz, opacity=opacity,
                      rotation=jnp.asarray(p["rotation"]),
                      scaling=jnp.asarray(p["scaling"]), shs=shs)
        out = j_rasterize(g, cam, height=hw, width=hw,
                          background=jnp.asarray(p["bg"]), use_rgb=True,
                          config=JCFG)
        return (jnp.abs(out["comp_rgb"] - p["tgt"]).mean()
                + 0.3 * (out["comp_mask"] ** 2).mean()), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(p[k]) for k in ("xyz", "shs", "opacity")))
    assert int(out["overflow"]) == 0
    return {"rgb": np.asarray(out["comp_rgb"]),
            "mask": np.asarray(out["comp_mask"]),
            **{f"grad_{k}": np.asarray(g)
               for k, g in zip(("xyz", "shs", "opacity"), grads)}}


def jax_ring(p):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.asarray(jax.devices()[:ranks.WORLD]), ("model",))
    fn = shard_map(lambda q, k, v, m: j_ring(q, k, v, m, "model",
                                             ranks.WORLD),
                   mesh=mesh, in_specs=(P("model"),) * 4,
                   out_specs=P("model"), check_rep=False)
    return np.asarray(jax.jit(fn)(*(jnp.asarray(p[f"ring_{k}"])
                                    for k in ("q", "k", "v", "mask"))))


def unsharded_fit(static: bool):
    """The port's unsharded fit step on the B = 2 batch, from the seeded
    tiny model with noise on its trainables: loss, the gradients and the
    updated trainables."""
    import dataclasses
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.parallel.dryrun import (HW, tiny_batch,
                                                        tiny_config)
    from guassianhand_tpu_torch.train.fit import (FitConfig,
                                                  attach_static_features,
                                                  make_fit_step,
                                                  make_optimizer)
    from guassianhand_tpu_torch.train.losses import LossWeights
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, renderer=dataclasses.replace(
        cfg.renderer, sharded_exchange=False,
        sharded_exchange_required=False))
    model = build_model(cfg, seed=0, device="cpu")
    ranks.perturb_trainables(model)
    fit_cfg = FitConfig(weights=LossWeights(vgg=0.0))
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    batch = tiny_batch(2, "cpu")
    if static:
        batch = attach_static_features(model, batch)
    step = make_fit_step(model, None, optimizer, scheduler, fit_cfg,
                         height=HW, width=HW)
    grads = ranks.capture_grads(model, optimizer)
    loss, _ = step(batch)
    return {"loss": float(loss), **{k: v.numpy() for k, v in grads.items()},
            **{k: getattr(model, k).detach().numpy()
               for k in ("color_w", "opacity_b", "map_bias")}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The ranks' results (one dict a rank) and the references computed
    while they ran."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = {**multiview_inputs(), **single_view_inputs(), **ring_inputs()}
    np.savez(tmp / "inputs.npz", **inputs)
    ctx = ranks.spawn_cases(str(tmp))
    try:
        ref = {"multiview": jax_multiview(inputs),
               "single_view": jax_single_view(inputs),
               "ring": jax_ring(inputs),
               "fit_plain_static": unsharded_fit(static=True),
               "fit_exchange": unsharded_fit(static=False)}
    finally:
        # a rank that fails raises here; one that hangs is killed
        join(ctx, 240)
    return ranks.load_results(str(tmp)), ref, inputs


def grad_close(got, want, name):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL * scale,
                               rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("case", ["render_multiview_2x2",
                                  "render_multiview_1x4"])
def test_sharded_rasterize_batch_matches_jax(spawned, case):
    """Every rank's render of its data shard equals JAX's for those
    samples, overflow 0, pairs received on every rank of the group; the
    gradients, summed over the model group, equal JAX's."""
    results, ref, _ = spawned
    want = ref["multiview"]
    for r, res in enumerate(results):
        res = {k.split("/", 1)[1]: v for k, v in res.items()
               if k.startswith(case + "/")}
        bl = res["rgb"].shape[0]
        rows = slice(int(res["data_index"]) * bl,
                     (int(res["data_index"]) + 1) * bl)
        assert int(res["overflow"]) == 0
        assert (res["exchange_pairs"] > 0).all(), res["exchange_pairs"]
        np.testing.assert_allclose(res["rgb"], want["rgb"][rows],
                                   atol=FWD_ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["mask"], want["mask"][rows],
                                   atol=FWD_ATOL, err_msg=f"rank {r}")
        for k in ("xyz", "shs"):
            grad_close(res[f"grad_{k}"], want[f"grad_{k}"][rows],
                       f"rank {r} {k}")


def test_sharded_rasterize_row_bands_matches_jax(spawned):
    """The single-view row-band variant: image and xyz, shs, opacity
    gradients equal JAX's rasterize on every rank."""
    results, ref, _ = spawned
    want = ref["single_view"]
    for r, res in enumerate(results):
        res = {k.split("/", 1)[1]: v for k, v in res.items()
               if k.startswith("render_single_view/")}
        assert int(res["overflow"]) == 0
        for k in ("rgb", "mask"):
            np.testing.assert_allclose(res[k], want[k], atol=FWD_ATOL,
                                       err_msg=f"rank {r} {k}")
        for k in ("xyz", "shs", "opacity"):
            grad_close(res[f"grad_{k}"], want[f"grad_{k}"], f"rank {r} {k}")


def test_capacity_drops_and_counts(spawned):
    """With a capacity under the busiest (src, dst) bucket the exchange
    drops pairs and counts them: overflow > 0, and the pairs received plus
    the pairs dropped are the live pairs enumerated."""
    results, _, _ = spawned
    res = {k.split("/", 1)[1]: v for k, v in results[0].items()
           if k.startswith("capacity_overflow/")}
    overflow = int(res["overflow"])
    assert overflow > 0
    assert int(res["exchange_pairs"].sum()) + overflow == int(
        res["live_pairs"])
    for other in results[1:]:
        assert int(other["capacity_overflow/overflow"]) == overflow


def test_ring_attention_matches_jax(spawned):
    results, ref, _ = spawned
    got = np.concatenate([res["ring_attention/out"] for res in results])
    np.testing.assert_allclose(got, ref["ring"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ["fit_step_plain_static",
                                  "fit_step_exchange"])
def test_sharded_fit_step_matches_unsharded(spawned, case):
    """The loss and the updated trainables on every rank equal the port's
    unsharded step on the whole batch; through the exchange every rank
    received live pairs and nothing overflowed."""
    results, ref, _ = spawned
    want = ref["fit_" + case.split("_", 2)[2]]
    for r, res in enumerate(results):
        res = {k.split("/", 1)[1]: v for k, v in res.items()
               if k.startswith(case + "/")}
        np.testing.assert_allclose(float(res["loss"]), want["loss"],
                                   rtol=1e-4, err_msg=f"rank {r}")
        for name in ("color_w", "opacity_b", "map_bias"):
            np.testing.assert_allclose(res[name], want[name], atol=1e-5,
                                       err_msg=f"rank {r} {name}")
        # Adam's first update is lr * sign(g): the reduced gradients
        # themselves are held too, so that a gradient counted twice shows
        for name in ranks.TRAINABLES:
            grad_close(res[f"grad_{name}"], want[f"grad_{name}"],
                       f"rank {r} grad {name}")
        assert float(res["overflow"]) == 0
        if case == "fit_step_exchange":
            assert res["exchange_pairs"].shape == (ranks.WORLD,)
            assert (res["exchange_pairs"] > 0).all()
        # the replicated parameters stayed equal across the ranks
        for name in ("color_w", "opacity_b", "map_bias"):
            np.testing.assert_array_equal(
                res[name], results[0][f"{case}/{name}"])


def test_dryrun_step(spawned):
    """parallel/dryrun.py's step on data 2 x model 2: the JAX dryrun's
    assertions (an all_to_all ran, live pairs moved, the loss is finite)
    and the same loss on every rank."""
    from guassianhand_tpu_torch.parallel.dryrun import check_dryrun
    results, _, _ = spawned
    outs = [json.loads(bytes(res["dryrun/json"]).decode())
            for res in results]
    for out in outs:
        check_dryrun(out)
        assert out["mesh"] == {"data": 2, "model": 2}
        assert out["loss"] == outs[0]["loss"]
        assert out["exchange_pairs"] == outs[0]["exchange_pairs"]
