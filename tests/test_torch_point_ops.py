"""The PyTorch port's point operations held against the JAX package on the
CPU: farthest point sampling, ball query and grouping (``ops/fps.py``),
the chamfer distance transform (``ops/distance_transform.py``), the point
z-buffer (``ops/zbuffer.py``) and the mesh helpers (``ops/mesh.py``).

Tolerances: FPS indices, ball-query indices, z-buffer winners and the
numpy mesh helpers exact; the normalised distance channel within 1e-6,
the raw distances within 1e-6 + 2e-6 * |JAX| (compiled, XLA rounds a few
of the sweeps' sums some ulps apart; run eagerly, the two are equal);
depths, fetched features and vertex normals within
1e-4 * max(1, max |JAX|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.core.camera import Camera as JCamera
from guassianhand_tpu.ops import distance_transform as jdt
from guassianhand_tpu.ops import fps as jfps
from guassianhand_tpu.ops import mesh as jmesh
from guassianhand_tpu.ops import zbuffer as jzb
from guassianhand_tpu_torch.core.camera import Camera
from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                   synthetic_batch)
from guassianhand_tpu_torch.ops import distance_transform as dt
from guassianhand_tpu_torch.ops import fps
from guassianhand_tpu_torch.ops import mesh
from guassianhand_tpu_torch.ops import zbuffer
from tests.torch_parity import (one_torch_thread,  # noqa: F401
                                scaled_close, to_torch)


def grid_points(n: int = 11, step: float = 0.1) -> np.ndarray:
    """A regular n^3 grid: every distance comes in exact ties."""
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    return (g.reshape(-1, 3) * step).astype(np.float32)


def subdivided_hands() -> np.ndarray:
    """The synthetic two-hand scene's posed points, its mesh subdivided
    once: every edge midpoint is equidistant from the edge's two ends."""
    scene = SyntheticHandScene.build(n_vertices=200, subdivide=1, height=32,
                                     width=32, device="cpu")
    return synthetic_batch(scene, seed=0)["points"][0].numpy()


@pytest.mark.parametrize("cloud", ["random", "grid", "subdivided_mesh"])
def test_farthest_point_sample_indices_equal_jax(cloud):
    pts = {"random": lambda: np.random.RandomState(0).normal(
               size=(2000, 3)).astype(np.float32),
           "grid": grid_points, "subdivided_mesh": subdivided_hands}[cloud]()
    n = min(512, pts.shape[0] // 2)
    want = np.asarray(jfps.farthest_point_sample(jnp.asarray(pts), n))
    got = fps.farthest_point_sample(to_torch(pts), n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        fps.fps_subsample(to_torch(pts), n).numpy(),
        np.asarray(jfps.fps_subsample(jnp.asarray(pts), n)))


def test_ball_query_and_group_points():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    query = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    feats = rng.normal(size=(300, 6)).astype(np.float32)
    for radius in (0.1, 0.3, 5.0):
        want_idx, want_in = jfps.ball_query(jnp.asarray(query),
                                            jnp.asarray(pts), radius, 16)
        idx, inside = fps.ball_query(to_torch(query), to_torch(pts),
                                     radius, 16)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(inside.numpy(), np.asarray(want_in))
        np.testing.assert_array_equal(
            fps.group_points(to_torch(feats), idx).numpy(),
            np.asarray(jfps.group_points(jnp.asarray(feats), want_idx)))


def masks() -> np.ndarray:
    """(4, 40, 56): blobs with holes, a mask on every edge, sparse specks,
    an empty mask (every pixel at the cap)."""
    rng = np.random.RandomState(2)
    m = np.zeros((4, 40, 56), np.float32)
    m[0, 8:30, 10:40] = 1
    m[0, 14:20, 18:26] = 0            # a hole
    m[0, 22:24, 30:33] = 0            # another
    m[1, 0, :] = m[1, :, 0] = m[1, -1, 5:9] = m[1, 12:15, -1] = 1
    m[2] = rng.uniform(size=(40, 56)) > 0.985
    m[2, 20:23, 27:31] = 0.7          # above the 0.5 threshold
    return m


def test_distance_transform_equals_jax():
    m = masks()
    want = np.asarray(jax.jit(jax.vmap(jdt.chamfer_distance_transform))(m))
    got = dt.chamfer_distance_transform(to_torch(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2e-6)
    want = np.asarray(jax.jit(jdt.mask_distance_channel)(m))
    got = dt.mask_distance_channel(to_torch(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[3] == 1.0).all() and (got[0][m[0] > 0] == 0).all()


def cameras():
    K = np.array([[40.0, 0, 20], [0, 40.0, 15], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = (0.05, -0.02, 1.5)
    return (JCamera.from_w2c(w2c, K, 30, 40),
            Camera.from_w2c(w2c, K, 30, 40, device="cpu"))


def test_zbuffer_rasterize_and_fetch():
    """Many points a pixel, points behind the camera and off the image;
    the winner of each pixel as JAX picks it (among the nearest, the
    highest index), duplicates of a point included."""
    jcam, cam = cameras()
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.6, 0.6, (3000, 3)).astype(np.float32)
    pts[:, 2] *= 2.0                   # some behind the camera (z < -1.5)
    pts[100:110] = pts[50]             # exact depth ties
    want_idx, want_depth = jzb.rasterize_points(jnp.asarray(pts), jcam, 30,
                                                40)
    idx, depth = zbuffer.rasterize_points(to_torch(pts), cam, 30, 40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    scaled_close(depth, want_depth)
    assert (idx.numpy() >= 0).sum() > 300 and (idx.numpy() == -1).any()

    fm = rng.uniform(size=(30, 40, 5)).astype(np.float32)
    scaled_close(zbuffer.fetch_image_features(to_torch(pts), cam,
                                              to_torch(fm)),
                 jzb.fetch_image_features(jnp.asarray(pts), jcam,
                                          jnp.asarray(fm)))


def test_mesh_seal_normals_concat():
    rng = np.random.RandomState(4)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    faces = rng.randint(0, 300, (500, 3)).astype(np.int32)
    for left in (False, True):
        got = mesh.seal(verts, faces, left=left)
        want = jmesh.seal(verts, faces, left=left)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    v, f = jmesh.seal(verts, faces)
    scaled_close(mesh.vertex_normals(to_torch(v), to_torch(f)),
                 jmesh.vertex_normals(jnp.asarray(v), jnp.asarray(f)))
    parts = [(verts[:100], faces[:50] % 100), (verts[100:], faces[50:] % 200)]
    for g, w in zip(mesh.concat_meshes(parts), jmesh.concat_meshes(parts)):
        np.testing.assert_array_equal(g, w)
