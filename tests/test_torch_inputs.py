"""The PyTorch port's input pipeline held against the JAX package on the CPU:
the synthetic MANO model, LBS, subdivision, the UV atlas, kNN and the
interaction mask, the synthetic batch, orbit cameras and the frame writer.

Exact where both sides do the same arithmetic in numpy or by gathers. LBS
is compared at atol 1e-6: its rodrigues sin/cos and its matrix products
round differently in XLA and PyTorch (about 1 ulp). Because the mesh has
exactly tied neighbour distances, that ulp can reorder tied kNN neighbours,
so the interaction mask is compared on the same points.
"""
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from guassianhand_tpu.data.rays import orbit_cameras as j_orbit
from guassianhand_tpu.data.synthetic import SyntheticHandScene as JScene
from guassianhand_tpu.data.synthetic import synthetic_batch as j_batch
from guassianhand_tpu.mano.lbs import lbs as j_lbs
from guassianhand_tpu.mano.uv import normalize_uv as j_normalize_uv
from guassianhand_tpu.ops.knn import interaction_mask as j_interaction
from guassianhand_tpu.ops.knn import knn as j_knn
from guassianhand_tpu.ops.subdivision import subdivide_n as j_subdivide_n
from guassianhand_tpu.utils.saving import _to_uint8 as j_to_uint8
from guassianhand_tpu_torch.data.rays import orbit_cameras
from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                   synthetic_batch)
from guassianhand_tpu_torch.mano.lbs import lbs
from guassianhand_tpu_torch.mano.uv import normalize_uv
from guassianhand_tpu_torch.ops.knn import interaction_mask, knn
from guassianhand_tpu_torch.ops.subdivision import subdivide_n
from guassianhand_tpu_torch.utils.saving import save_image, to_uint8
from tests.torch_parity import one_torch_thread, to_torch  # noqa: F401

HW = 64


@pytest.fixture(scope="module")
def scenes():
    jscene = JScene.build(n_vertices=96, subdivide=1, height=HW, width=HW)
    tscene = SyntheticHandScene.build(n_vertices=96, subdivide=1, height=HW,
                                      width=HW, device="cpu")
    # jitted: op-by-op dispatch of the JAX batch takes several times longer
    jb = {k: np.asarray(v) for k, v in
          jax.jit(lambda: j_batch(jscene, seed=3, with_target=False))().items()}
    tb = {k: v.numpy() for k, v in synthetic_batch(tscene, seed=3).items()}
    return jscene, tscene, jb, tb


def test_synthetic_mano_model_matches(scenes):
    jscene, tscene, _, _ = scenes
    for hand in ("model_r", "model_l"):
        jm, tm = getattr(jscene, hand), getattr(tscene, hand)
        for name in ("v_template", "shapedirs", "posedirs", "j_regressor",
                     "lbs_weights"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))
        np.testing.assert_array_equal(tm.faces, np.asarray(jm.faces))
        np.testing.assert_array_equal(tm.parents, np.asarray(jm.parents))


def test_subdivision_matches(scenes):
    jscene, tscene, _, _ = scenes
    for jp, tp in zip(jscene.plans_r, tscene.plans_r):
        np.testing.assert_array_equal(tp.edges, jp.edges)
        np.testing.assert_array_equal(tp.faces_out, jp.faces_out)
        assert tp.n_vertices_out == jp.n_vertices_out
    v = np.random.RandomState(0).normal(size=(96, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        subdivide_n(to_torch(v), tscene.plans_r).numpy(),
        np.asarray(j_subdivide_n(jnp.asarray(v), jscene.plans_r)))


def test_lbs_matches(scenes):
    jscene, tscene, _, _ = scenes
    rng = np.random.RandomState(4)
    pose = rng.uniform(-0.5, 0.5, 48).astype(np.float32)
    betas = rng.normal(size=10).astype(np.float32)
    trans = rng.normal(size=3).astype(np.float32)
    jv, jj = jax.jit(lambda p, b, t: j_lbs(jscene.model_r, b, p, t))(
        pose, betas, trans)
    tv, tj = lbs(tscene.model_r, to_torch(betas), to_torch(pose),
                 to_torch(trans))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-6)


def test_synthetic_batch_matches(scenes):
    _, _, jb, tb = scenes
    assert set(tb) == set(jb)
    np.testing.assert_array_equal(tb["vert_uv"], jb["vert_uv"])
    for key in ("mano_pose", "c2w", "intrinsic_normed", "w2c_render",
                "K_render", "background"):
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    for key in ("points", "points_tar"):
        np.testing.assert_allclose(tb[key], jb[key], atol=1e-6, err_msg=key)
    assert tb["inter_mask"].dtype == bool
    assert tb["inter_mask"].shape == jb["inter_mask"].shape
    # the points' last-ulp differences reorder neighbours at exact distance
    # ties and flip the mask of a few points (ROADMAP.md, Queue C)
    assert np.mean(tb["inter_mask"] != jb["inter_mask"]) < 0.02


def test_interaction_mask_matches_on_same_points(scenes):
    """kNN neighbour order, ties included, and so the mask, equal the JAX
    package's on the same points."""
    jscene, _, jb, _ = scenes
    pts = jb["points"][0]
    tpose = np.asarray(jax.jit(lambda: jscene.pose_points(jnp.zeros(48),
                                                          jnp.zeros(48)))())
    k = min(100, pts.shape[0] // 4)
    got = interaction_mask(to_torch(pts), to_torch(tpose), k=k).numpy()
    np.testing.assert_array_equal(got, jb["inter_mask"][0])
    want = np.asarray(jax.jit(j_interaction, static_argnames="k")(
        jnp.asarray(pts), jnp.asarray(tpose), k=k))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    jd, ji = jax.jit(j_knn, static_argnums=2)(jnp.asarray(pts),
                                              jnp.asarray(pts), 25)
    td, ti = knn(to_torch(pts), to_torch(pts), 25)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_orbit_cameras_and_uv_match():
    K = np.array([[50, 0, 32], [0, 50, 32], [0, 0, 1]], np.float32)
    center = np.array([0.01, 0.05, 0.0])
    for got, want in zip(orbit_cameras(center, 0.6, K, n_views=5),
                         j_orbit(center, 0.6, K, n_views=5)):
        np.testing.assert_array_equal(got, want)
    uv = np.random.RandomState(5).uniform(0, 1, (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(normalize_uv(to_torch(uv)).numpy(),
                                  np.asarray(j_normalize_uv(jnp.asarray(uv))))


def test_png_writer_round_trips(tmp_path):
    img = np.random.RandomState(6).uniform(-0.1, 1.1, (5, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(to_uint8(img), j_to_uint8(img))
    path = save_image(str(tmp_path / "f.png"), img)
    blob = open(path, "rb").read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", blob[16:24])
    assert (w, h) == (7, 5)
    idat = blob.index(b"IDAT")
    n = struct.unpack(">I", blob[idat - 4:idat])[0]
    raw = zlib.decompress(blob[idat + 4:idat + 4 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(h, w, 3), to_uint8(img))
