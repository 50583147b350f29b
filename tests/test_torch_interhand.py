"""The PyTorch port's InterHand2.6M data path held against the JAX package
on the CPU, on a fake layout (``tests/torch_interhand_layout.py``: 64-vertex
synthetic MANO pickles, 64^2 JPEGs, edge_subdivide 1): the MANO loader,
the UV atlas and the projection onto it, ``load_sample`` on the train and
test splits, with colour jitter and in edit mode, and the renderer's
``exact_duplicate_uv``. The fit on this layout is held against JAX in
tests/test_torch_interhand_fit.py; the fit CLI's InterHand2.6M fit and
``--run_val`` run in tests/test_torch_checkpoint_port.py through
cli/port_and_eval.py.

Tolerances, each with its reason:
- MANO arrays, atlas files, images, masks, bbox_mask, mask_at_box,
  cameras, the MANO pose: exact (the same numpy arithmetic or none);
- the UV projection: atol 1e-6 (fp32 dot products in another order);
- points: atol 1e-5, and the interaction mask: at most 2 % of the points
  flipped (LBS rounds 1 ulp apart from XLA, and the kNN's exact distance
  ties turn such a difference into a flip; ROADMAP.md Queue C);
- exact_duplicate_uv: atol 1e-5 (tests/test_renderer.py's own).
"""
import dataclasses
import functools
import pickle
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guassianhand_tpu.data import interhand as jinterhand
from guassianhand_tpu.mano.lbs import mano_forward as j_mano_forward
from guassianhand_tpu.mano import model as jmano
from guassianhand_tpu.mano import uv as juv
from guassianhand_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from guassianhand_tpu.render import renderer as jrenderer
from guassianhand_tpu_torch.cli import fit_one_shot
from guassianhand_tpu_torch.compat.from_jax import load_jax_params
from guassianhand_tpu_torch.config import load_config
from guassianhand_tpu_torch.data import interhand
from guassianhand_tpu_torch.mano import lbs, model as tmano, uv
from guassianhand_tpu_torch.ops.subdivision import (build_subdivision_plans,
                                                    subdivide_n)
from guassianhand_tpu_torch.render.renderer import GSRenderer, RendererConfig
from tests.torch_parity import one_torch_thread, random_params  # noqa: F401
from tests import torch_interhand_layout as ih_layout

POINT_ATOL = 1e-5
FLIP_SHARE = 0.02
UV_ATOL = 1e-6


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("interhand")
    return ih_layout.write_interhand_layout(root, n_vertices=64, hw=64,
                                             modes=("test", "train"))


def test_load_mano_model_matches_jax(layout, monkeypatch, tmp_path):
    """Both hands' pickles load to the same arrays, the left hand's
    shapedirs with the sign fix against the pickle's own; no file gives
    None."""
    for hand in ("right", "left"):
        got = tmano.load_mano_model(hand, layout["mano"], device="cpu")
        want = jmano.load_mano_model(hand, layout["mano"])
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f.name)),
                np.asarray(getattr(want, f.name)), err_msg=f.name)
    left = tmano.load_mano_model("left", layout["mano"], device="cpu")
    with open(Path(layout["mano"]) / "MANO_LEFT.pkl", "rb") as f:
        raw = pickle.load(f)["shapedirs"]
    np.testing.assert_array_equal(left.shapedirs[:, 0].numpy(),
                                  -raw[:, 0])
    np.testing.assert_array_equal(left.shapedirs[:, 1:].numpy(), raw[:, 1:])
    monkeypatch.delenv("MANO_MODELS_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    assert tmano.load_mano_model("right") is None

    rng = np.random.RandomState(0)
    betas, orient, pose, trans = (rng.uniform(-0.3, 0.3, n).astype(np.float32)
                                  for n in (10, 3, 45, 3))
    got = lbs.mano_forward(left, *(torch.from_numpy(x) for x in
                                   (betas, orient, pose, trans)))
    want = jax.jit(j_mano_forward)(jmano.load_mano_model("left",
                                                         layout["mano"]),
                                   betas, orient, pose, trans)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=POINT_ATOL)


def tie_mesh():
    """Two triangles mirrored across x = 0 that share the edge x = 0, with
    corner UVs that differ, and a point above the shared edge: its closest
    point lies on both at the same distance."""
    tri_xyz = np.array([[[-1, 0, 0], [0, 0, 0], [0, 1, 0]],
                        [[1, 0, 0], [0, 0, 0], [0, 1, 0]]], np.float32)
    tri_uv = np.array([[[0.1, 0.1], [0.2, 0.1], [0.2, 0.3]],
                       [[0.4, 0.1], [0.3, 0.1], [0.3, 0.35]]], np.float32)
    return tri_xyz, tri_uv, np.array([[0.0, 0.5, 1.0]], np.float32)


def test_uv_projection_and_atlas_match_jax(tmp_path):
    """get_uvd and project_to_faces against JAX on seeded points and
    triangles (2,100 points: chunks of 1,024), static_vertex_uv and
    get_uvd on the synthetic hand's mesh (whose strip topology holds every
    triangle twice, once a winding: rounding picks one of the pair, so the
    face, its barycentrics and the sign of the distance may differ there
    while the UV and |distance| agree), an equidistant tie, which both break
    to the first face, and read_obj_uv, vertex_uv_table and load_uv_atlas on
    a small hand.obj with its change_*.npy. The barycentrics of random
    triangles within 1e-5: they divide differences of products that nearly
    cancel, which XLA's CPU code fuses into multiply-adds."""
    rng = np.random.RandomState(0)
    tri_xyz = rng.normal(size=(40, 3, 3)).astype(np.float32)
    tri_uv = rng.uniform(0, 0.5, (40, 3, 2)).astype(np.float32)
    points = rng.normal(size=(2100, 3)).astype(np.float32)
    t_uv, t_d = uv.get_uvd(*map(torch.from_numpy, (points, tri_xyz, tri_uv)))
    j_uv, j_d = juv.get_uvd(*map(jnp.asarray, (points, tri_xyz, tri_uv)))
    np.testing.assert_allclose(t_uv.numpy(), np.asarray(j_uv), atol=UV_ATOL)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=UV_ATOL)
    t_fi, t_bary = uv.project_to_faces(torch.from_numpy(points),
                                       torch.from_numpy(tri_xyz))
    j_fi, j_bary = juv.project_to_faces(points, tri_xyz)
    np.testing.assert_array_equal(t_fi, j_fi)
    np.testing.assert_allclose(t_bary, j_bary, atol=1e-5)

    hand = tmano.synthetic_mano_model(64, seed=0, device="cpu")
    rest = subdivide_n(hand.v_template, build_subdivision_plans(
        hand.faces, 64, 1)).numpy()
    tri_xyz = hand.v_template.numpy()[hand.faces]
    tri_uv = uv.synthetic_uv_atlas(hand.v_template.numpy())[hand.faces]
    np.testing.assert_allclose(
        uv.static_vertex_uv(rest, tri_xyz, tri_uv),
        juv.static_vertex_uv(rest, tri_xyz, tri_uv), atol=UV_ATOL)
    off = (rest + rng.normal(scale=1e-3, size=rest.shape)).astype(np.float32)
    t_uv, t_d = uv.get_uvd(*map(torch.from_numpy, (off, tri_xyz, tri_uv)))
    j_uv, j_d = juv.get_uvd(*map(jnp.asarray, (off, tri_xyz, tri_uv)))
    np.testing.assert_allclose(t_uv.numpy(), np.asarray(j_uv), atol=UV_ATOL)
    np.testing.assert_allclose(t_d.abs().numpy(), np.abs(np.asarray(j_d)),
                               atol=UV_ATOL)

    tri_xyz, tri_uv, point = tie_mesh()
    for order in ([0, 1], [1, 0]):
        t_fi, _ = uv.project_to_faces(torch.from_numpy(point),
                                      torch.from_numpy(tri_xyz[order]))
        j_fi, _ = juv.project_to_faces(point, tri_xyz[order])
        assert t_fi.tolist() == j_fi.tolist() == [0]
        t_uv, _ = uv.get_uvd(*map(torch.from_numpy,
                                  (point, tri_xyz[order], tri_uv[order])))
        # the first face's UV: the midpoint of its corners 1 and 2
        np.testing.assert_allclose(t_uv.numpy()[0],
                                   tri_uv[order][0, 1:].mean(0), atol=UV_ATOL)

    obj = tmp_path / "hand.obj"
    obj.write_text("# a square of two faces\nv 0 0 0\nv 1 0 0\nv 1 1 0\n"
                   "v 0 1 0\nvt 0.0 0.0\nvt 1.0 0.0\nvt 1.0 1.0\nvt 0.0 1.0\n"
                   "vt 0.5 0.5\nf 1/1 2/2 3/3\nf 1/5 3/3 4/4\n")
    np.save(tmp_path / "change_r.npy", np.array([0, 1, 2, 3, 0]))
    np.save(tmp_path / "change_l.npy", np.array([3, 2, 1, 0, 1]))
    for got, want in zip(uv.read_obj_uv(str(obj)), juv.read_obj_uv(str(obj))):
        np.testing.assert_array_equal(got, want)
    vt, ft, f = juv.read_obj_uv(str(obj))
    np.testing.assert_array_equal(uv.vertex_uv_table(4, f, ft, vt),
                                  juv.vertex_uv_table(4, f, ft, vt))
    got, want = uv.load_uv_atlas(str(tmp_path)), juv.load_uv_atlas(
        str(tmp_path))
    assert sorted(got) == sorted(want) == ["change_l", "change_r", "f", "ft_r",
                                           "vt"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def edit_image(tmp_path) -> str:
    """A 48^2 RGBA edit target (alpha half on), resized to 64^2 on load."""
    import PIL.Image
    rng = np.random.RandomState(3)
    rgba = rng.randint(0, 255, (48, 48, 4)).astype(np.uint8)
    rgba[..., 3] = np.where(rng.uniform(size=(48, 48)) > 0.5, 255, 0)
    path = str(tmp_path / "edit.png")
    PIL.Image.fromarray(rgba, "RGBA").save(path)
    return path


# (config fields, the frame index loaded, the split's length)
SAMPLE_CASES = {
    "train_jitter": (dict(split="train", color_jitter=True), 0, 50),
    "test_oneshot_reg_i": (dict(split="test", pose_sequence="oneshot_reg_i",
                                mask_sa=False), 1, 14),
    "edit_custom_image": (dict(split="train", mode="test", edit=True,
                               render_mask=False), 0, 100),
    # the fit CLI's dataset: the edit image at the run's 64^2, not the
    # config's data.height x data.width (256^2)
    "edit_at_the_cli_size": (dict(split="train", edit=True,
                                  render_mask=False), 0, 100),
}


@pytest.mark.parametrize("case", SAMPLE_CASES)
def test_load_sample_matches_jax(layout, case, tmp_path):
    """The split's length and one frame's batch against JAX's: images,
    masks, bbox_mask, mask_at_box, cameras and the pose exact, points
    within 1e-5, the interaction mask within 2 % flips, the UVs within
    1e-6; the batch's tensors on the dataset's device. The last case
    builds the port's dataset as the fit CLI does, at the run's size."""
    fields, index, length = SAMPLE_CASES[case]
    if case.startswith("edit"):
        fields = dict(fields, image_path=edit_image(tmp_path))
    kw = dict(data_root=layout["data_root"], annot_path=layout["annot_path"],
              mano_models_path=layout["mano"], edge_subdivide=1, height=64,
              width=64, **fields)
    if case == "edit_at_the_cli_size":
        cfg = load_config(None, [
            f"data.{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in kw.items() if k not in ("split", "height", "width")])
        assert cfg.data.height != 64
        tds = fit_one_shot.interhand_dataset(cfg, "train", "cpu", 64, 64)
    else:
        tds = interhand.InterHandDataset(interhand.InterHandConfig(**kw),
                                         device="cpu")
    jds = jinterhand.InterHandDataset(jinterhand.InterHandConfig(**kw))
    assert len(tds) == len(jds) == length
    assert tds.cfg.mode == jds.cfg.mode
    got, want = tds.load_sample(index), jds.load_sample(index)
    assert sorted(got) == sorted(want)
    for k in ("target_rgb", "target_mask", "bbox_mask", "mask_at_box",
              "c2w", "intrinsic_normed", "w2c_render", "K_render",
              "mano_pose", "background"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("capture_id", "frame_idx", "cam"):
        assert got[k] == want[k], k
    for k in ("points", "points_tar"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=POINT_ATOL, err_msg=k)
    np.testing.assert_allclose(got["vert_uv"].numpy(),
                               np.asarray(want["vert_uv"]), atol=UV_ATOL)
    flips = (got["inter_mask"].numpy() != np.asarray(want["inter_mask"]))
    assert flips.mean() <= FLIP_SHARE, flips.sum()
    assert 0 < int(got["inter_mask"].sum()) < got["inter_mask"].numel()
    assert all(got[k].device.type == "cpu" for k in got
               if isinstance(got[k], torch.Tensor))
    assert got["target_mask"].min() == 0 and got["target_mask"].max() == 1


def test_exact_duplicate_uv_matches_jax():
    """tests/test_renderer.py's case: with exact_duplicate_uv all 2N points
    (duplicates too) re-project through the UV mesh, as JAX does from the
    same seeded weights (on-mesh points to their triangle's interpolated
    UV); without the mesh the duplicates copy their parents' UV; the model
    hands a batch's tri_xyz / tri_uv to the renderer."""
    tri_xyz = jnp.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    tri_uv = jnp.asarray([[[0.0, 0], [0.5, 0], [0.0, 1]]])
    pts = np.array([[0.25, 0.25, 0.0], [0.1, 0.2, 0.05], [0.5, 0.0, 0.0],
                    [0.0, 0.5, 0.0]], np.float32)
    feats = np.zeros((4, 131), np.float32)
    vert_uv = np.full((4, 2), 0.77, np.float32)
    jr = jrenderer.GSRenderer(cfg=jrenderer.RendererConfig(
        exact_duplicate_uv=True, raster=JRasterizeConfig(interpret=True)))
    shapes = jax.eval_shape(functools.partial(
        jr.init, tri_xyz=tri_xyz, tri_uv=tri_uv,
        method=jrenderer.GSRenderer.build_gaussians),
        jax.random.PRNGKey(0), feats, pts, vert_uv)
    params = random_params(shapes, 0)
    j_gs, j_uv = jr.apply(params, feats, pts, vert_uv, tri_xyz=tri_xyz,
                          tri_uv=tri_uv,
                          method=jrenderer.GSRenderer.build_gaussians)
    tr = GSRenderer(RendererConfig(exact_duplicate_uv=True)).eval()
    load_jax_params(tr, params, strict=False)
    args = [torch.from_numpy(x) for x in (feats, pts, vert_uv)]
    tris = [torch.from_numpy(np.array(x)) for x in (tri_xyz, tri_uv)]
    with torch.no_grad():
        t_gs, t_uv = tr.build_gaussians(*args, *tris)
        _, plain_uv = tr.build_gaussians(*args)
    np.testing.assert_allclose(t_gs.xyz.numpy(), np.asarray(j_gs.xyz),
                               atol=1e-5)
    np.testing.assert_allclose(t_uv.numpy(), np.asarray(j_uv), atol=1e-5)
    np.testing.assert_array_equal(
        t_uv.numpy(), uv.get_uvd(t_gs.xyz, *tris)[0].numpy())
    # on-mesh points take their triangle's interpolated UV
    np.testing.assert_allclose(
        uv.get_uvd(args[1], *tris)[0].numpy()[[0, 2, 3]],
        [[0.125, 0.25], [0.25, 0.0], [0.0, 0.5]], atol=1e-5)
    assert abs(float(t_uv[4, 0]) - 0.77) > 0.1
    assert (plain_uv.numpy() == 0.77).all()

    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model
    from tests.torch_parity import port_model_config
    from tests.test_model import TINY
    scene = SyntheticHandScene.build(n_vertices=32, subdivide=0, height=32,
                                     width=32, device="cpu")
    batch = synthetic_batch(scene)
    batch["tri_xyz"], batch["tri_uv"] = tris[0][None], tris[1][None]
    model = build_model(port_model_config(TINY), device="cpu")
    seen = mock.Mock(wraps=model.renderer.build_gaussians)
    with mock.patch.object(model.renderer, "build_gaussians", seen), \
            torch.no_grad():
        model(batch, 32, 32)
    np.testing.assert_array_equal(seen.call_args.args[3].numpy(), tri_xyz)
    np.testing.assert_array_equal(seen.call_args.args[4].numpy(), tri_uv)
