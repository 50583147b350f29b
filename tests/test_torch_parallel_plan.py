"""The host side of the port's sharded path, in this process (no ranks):
tile ownership and the exchange's balance figures against the JAX
package's, the placement of a batch, the thread-local exchange context,
the mesh's rank layout against JAX's, and the model's refusal to render
unsharded when the exchange is required (exact comparisons: integers,
slices and dicts)."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.parallel import raster_shard as jrs
from guassianhand_tpu.parallel.mesh import make_mesh as j_make_mesh
from guassianhand_tpu_torch.core.gaussians import Gaussians
from guassianhand_tpu_torch.parallel import raster_shard as trs
from guassianhand_tpu_torch.parallel.mesh import (Mesh, exchange_mesh,
                                                  rank_layout,
                                                  use_exchange_mesh)
from guassianhand_tpu_torch.parallel.step import shard_batch
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_owner_slot_equals_jax():
    """The diagonal shift and every tile's (owner, slot) equal JAX's, on
    numpy ids and on torch ids, for n_model 1, 2, 3, 4, 8 and ntx 3, 16;
    the ownership is a bijection onto (owner, slot)."""
    for n_model in (1, 2, 3, 4, 8):
        assert trs._diag_shift(n_model) == jrs._diag_shift(n_model)
        for ntx in (3, 16):
            tiles = np.arange(ntx * 7)
            want = [np.asarray(a) for a in jrs._owner_slot(
                jnp.asarray(tiles), ntx, n_model)]
            got_np = trs._owner_slot(tiles, ntx, n_model)
            got_t = trs._owner_slot(torch.as_tensor(tiles), ntx, n_model)
            for w, g_np, g_t in zip(want, got_np, got_t):
                np.testing.assert_array_equal(g_np, w)
                np.testing.assert_array_equal(g_t.numpy(), w)
            pairs = set(zip(*(a.tolist() for a in got_np)))
            assert len(pairs) == tiles.size


def test_exchange_balance_stats_equal_jax():
    """exchange_balance_stats on the 64-vertex scene's Gaussians (its points
    and a copy offset by 1e-3: 756), two views at 64^2, n_model 4: the
    same dict as JAX's, key for key (no Gaussian reaches JAX's 16-tile
    cap at this size, so both enumerate the same pairs)."""
    from guassianhand_tpu.data.synthetic import (SyntheticHandScene,
                                                 synthetic_batch)
    hw = 64
    scene = SyntheticHandScene.build(n_vertices=64, subdivide=1, height=hw,
                                     width=hw)
    batch = jax.jit(lambda: synthetic_batch(scene, seed=0,
                                            with_target=False))()
    pts = batch["points"][0]
    g = scene.decoration_gaussians(jnp.concatenate([pts, pts + 1e-3]))
    w2c = np.asarray(batch["w2c_render"][0, 0])
    w2c2 = w2c.copy()
    w2c2[0, 3] += 0.05
    w2cs = np.stack([w2c, w2c2])[None]
    ks = np.broadcast_to(np.asarray(batch["K_render"][0, 0]),
                         (1, 2, 3, 3)).copy()
    want = jrs.exchange_balance_stats(
        jax.tree.map(lambda a: a[None], g), jnp.asarray(w2cs),
        jnp.asarray(ks), height=hw, width=hw, n_model=4)
    tg = Gaussians(**{k: torch.from_numpy(np.array(getattr(g, k))) for k in
                      ("xyz", "opacity", "rotation", "scaling", "shs")})
    got = trs.exchange_balance_stats(
        [tg], torch.from_numpy(w2cs), torch.from_numpy(ks), height=hw,
        width=hw, n_model=4)
    assert got == want
    assert got["live_pairs"] > 0


def test_shard_batch_slices_data_shards():
    """Each rank of data 2 x model 2 gets samples [d, d + 1) of every
    array, the nested static_feats included; the points axis and scalars
    stay whole; a batch that does not split raises."""
    rng = np.random.RandomState(0)
    batch = {"points": torch.from_numpy(rng.normal(size=(4, 10, 3))),
             "target_rgb": torch.from_numpy(rng.uniform(size=(4, 8, 8, 3))),
             "static_feats": {
                 "uv_pe": torch.from_numpy(rng.normal(size=(4, 10, 6))),
                 "fingerprint": torch.tensor(3.0)},
             "note": "kept"}
    for rank in range(4):
        mesh = Mesh(n_data=2, n_model=2, rank=rank)
        got = shard_batch(batch, mesh)
        rows = slice(2 * mesh.data_index, 2 * mesh.data_index + 2)
        assert mesh.data_index == rank // 2 and mesh.model_index == rank % 2
        assert torch.equal(got["points"], batch["points"][rows])
        assert torch.equal(got["target_rgb"], batch["target_rgb"][rows])
        assert torch.equal(got["static_feats"]["uv_pe"],
                           batch["static_feats"]["uv_pe"][rows])
        assert got["static_feats"]["fingerprint"] is \
            batch["static_feats"]["fingerprint"]
        assert got["note"] == "kept"
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": torch.zeros(3, 2)},
                    Mesh(n_data=2, n_model=1, rank=0))


def test_exchange_mesh_stack_is_thread_local():
    """use_exchange_mesh nests and restores; another thread sees None and
    its own pushes do not reach this thread."""
    a = Mesh(n_data=1, n_model=2, rank=0)
    b = Mesh(n_data=2, n_model=1, rank=1)
    seen = {}

    def other():
        seen["before"] = exchange_mesh()
        with use_exchange_mesh(b):
            seen["inside"] = exchange_mesh()

    assert exchange_mesh() is None
    with use_exchange_mesh(a):
        assert exchange_mesh() is a
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with use_exchange_mesh(None):
            assert exchange_mesh() is None
        assert exchange_mesh() is a
    assert exchange_mesh() is None
    assert seen == {"before": None, "inside": b}


def test_rank_layout_equals_jax_mesh():
    """rank = d * n_model + m: the port's layout of each shape equals the
    device ids of JAX's make_mesh over the conftest's 8 devices, and its
    defaults (n_data 1) too."""
    for n_data, n_model in ((1, 8), (2, 4), (4, 2), (8, 1)):
        jmesh = j_make_mesh(n_data=n_data, n_model=n_model)
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        np.testing.assert_array_equal(rank_layout(n_data, n_model),
                                      ids - ids.min())
    assert dict(j_make_mesh().shape) == {"data": 1, "model": 8}


def test_sharded_exchange_without_mesh_refuses_or_warns():
    """With sharded_exchange_required and no mesh published the forward
    raises JAX's RuntimeError; with sharded_exchange alone it warns and
    renders unsharded, equal to the model without the flag."""
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.parallel.dryrun import (HW, tiny_batch,
                                                        tiny_config)
    cfg = tiny_config()
    batch = tiny_batch(1, "cpu")
    model = build_model(cfg, seed=0, device="cpu")
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="sharded_exchange_required"):
        model(batch, HW, HW)
    warn_cfg = dataclasses.replace(cfg, renderer=dataclasses.replace(
        cfg.renderer, sharded_exchange_required=False))
    plain_cfg = dataclasses.replace(cfg, renderer=dataclasses.replace(
        cfg.renderer, sharded_exchange=False,
        sharded_exchange_required=False))
    with torch.no_grad():
        with pytest.warns(RuntimeWarning, match="UNSHARDED"):
            got = build_model(warn_cfg, seed=0, device="cpu")(batch, HW, HW)
        want = build_model(plain_cfg, seed=0, device="cpu")(batch, HW, HW)
    assert torch.equal(got["comp_rgb"], want["comp_rgb"])
    assert "exchange_pairs" not in got
