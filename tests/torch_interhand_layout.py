"""A fake InterHand2.6M layout and a reference-layout checkpoint, made
from seeds, for the port's InterHand2.6M tests on the CPU and for
chip_smoke.py's InterHand phase on the card (which loads this file by its
path). Imports no JAX.

- ``write_interhand_layout``: the processed layout data/interhand.py reads,
  with synthetic MANO pickles and images written through PIL;
- ``add_noise``: seeded noise on every tensor of a model;
- ``reference_state_dict``: a model's state dict in the reference
  checkpoint's layout.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np
import torch


def write_interhand_layout(root, n_vertices: int = 778, hw: int = 256,
                           test_frames: int = 14, modes=("test",),
                           seed: int = 0) -> dict:
    """A fake InterHand2.6M layout under ``root`` in the processed form
    data/interhand.py reads, for each of ``modes``: MANO pickles in the
    smplx layout of ``synthetic_mano_model(n_vertices)`` (seeds 0 and 1;
    the root's parent stored as 2^32 - 1, as MANO stores it), the
    annotation JSONs of one capture, the one-shot fit frame (test:
    index_identity_test_i_one_shot/2.pkl, train: the edit frame
    index_identity0_train_i/11388.pkl) and ``test_frames`` frames of the
    stride-10 sequence ({i*10}.pkl: the test split's oneshot_reg_i, the
    train mode's edit drive), each frame with seeded MANO parameters (the
    left hand 5 cm to the right: the hands overlap in part), a camera at
    0.35 looking at the hands, and hw^2 JPEGs written by PIL: an image of
    seeded 8-pixel blocks, the mask and mask_sa an ellipse around the
    hands, bbox_mask a box around it. Returns data_root, annot_path and
    mano (the pickles' directory)."""
    import PIL.Image
    from guassianhand_tpu_torch.mano.model import (MANO_PARENTS,
                                                   synthetic_mano_model)
    root = Path(root)
    mano_dir = root / "mano"
    mano_dir.mkdir(parents=True, exist_ok=True)
    kintree = np.stack([MANO_PARENTS, np.arange(16)]).astype(np.int64)
    kintree[0, 0] = 2 ** 32 - 1
    for hand, s in (("RIGHT", 0), ("LEFT", 1)):
        m = synthetic_mano_model(n_vertices, seed=s, device="cpu")
        with open(mano_dir / f"MANO_{hand}.pkl", "wb") as f:
            pickle.dump({"v_template": m.v_template.numpy(),
                         "shapedirs": m.shapedirs.numpy(),
                         "posedirs": m.posedirs.numpy(),
                         "J_regressor": m.j_regressor.numpy(),
                         "weights": m.lbs_weights.numpy(),
                         "kintree_table": kintree, "f": m.faces}, f)
    rng = np.random.RandomState(seed)
    frames = [0] + [100 + i for i in range(test_frames)]
    params = {str(fr): {h: {"pose": rng.uniform(-0.3, 0.3, 48).tolist(),
                            "shape": rng.uniform(-0.5, 0.5, 10).tolist(),
                            "trans": [0.05 if h == "left" else 0.0, 0.0,
                                      0.0]}
                        for h in ("right", "left")} for fr in frames}
    f = 0.9 * hw
    camera = {"R": np.eye(3, dtype=np.float32),
              "t": np.array([-0.025, -0.06, 0.35], np.float32),
              "in_K": np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]],
                               np.float32)}
    yy, xx = np.mgrid[:hw, :hw] / hw - 0.5
    ellipse = np.where((xx / 0.3) ** 2 + (yy / 0.38) ** 2 <= 1, 255, 0)
    box = np.where((np.abs(xx) < 0.4) & (np.abs(yy) < 0.45), 255, 0)
    sub = {"test": ("index_identity_test_i_one_shot", 2),
           "train": ("index_identity0_train_i", 11388)}
    seq = {"test": "index_identity_test_i_one_shot",
           "train": "index_identity_all_train_i"}
    for mode in modes:
        ann = root / "annotations" / mode
        ann.mkdir(parents=True, exist_ok=True)
        cap = {"0": params}
        (ann / f"InterHand2.6M_{mode}_MANO_NeuralAnnot.json").write_text(
            json.dumps(cap))
        (ann / f"InterHand2.6M_{mode}_joint_3d.json").write_text(json.dumps(
            {"0": {fr: {"world_coord": np.zeros((42, 3)).tolist()}
                   for fr in params}}))
        proc = root / "processed" / mode
        records = {sub[mode]: frames[0]}
        records.update({(seq[mode], 10 * i): fr
                        for i, fr in enumerate(frames[1:])})
        for (index_dir, i), fr in records.items():
            (proc / index_dir).mkdir(parents=True, exist_ok=True)
            with open(proc / index_dir / f"{i}.pkl", "wb") as fh:
                pickle.dump({"idx": i, "frame": fr, "capture": 0, "cam": 0},
                            fh)
        blocks = -(-hw // 8)
        for fr in frames:
            d = proc / "annotation" / "capture0" / "cam0"
            d.mkdir(parents=True, exist_ok=True)
            with open(d / f"frame{fr}.pkl", "wb") as fh:
                pickle.dump({"camera": camera, "image_info": {}}, fh)
            image = np.kron(rng.randint(0, 256, (blocks, blocks, 3)),
                            np.ones((8, 8, 1)))[:hw, :hw]
            for kind, arr in (("image", image), ("mask", ellipse),
                              ("mask_sa", ellipse), ("bbox_mask", box)):
                d = proc / kind / "capture0" / "cam0"
                d.mkdir(parents=True, exist_ok=True)
                PIL.Image.fromarray(arr.astype(np.uint8)).save(
                    d / f"frame{fr}.jpg")
    return {"data_root": str(root / "processed"),
            "annot_path": str(root / "annotations"), "mano": str(mano_dir)}


def add_noise(model, seed: int, scale: float = 0.05):
    """``model`` with seeded normal noise of ``scale`` added to every
    tensor of its state dict, in place: the seeded init leaves the
    per-identity maps constant (0, color_w 1), which would let a map that
    failed to load pass for loaded."""
    gen = None
    with torch.no_grad():
        for v in model.state_dict().values():
            if gen is None:
                gen = torch.Generator(device=v.device).manual_seed(seed)
            v.add_(scale * torch.randn(v.shape, generator=gen,
                                       device=v.device))
    return model


def reference_state_dict(model) -> dict:
    """``model``'s state dict on the host in the reference checkpoint's
    layout: Lightning's ``model.`` prefix, the identity codes as
    (*, 1, C, H, W), color_b in the reference's 48 channels (the narrow
    model's 3 and 45 zeros), four point-cloud generator keys, and no
    identity-code head (the reference has none)."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("identity_code_infer."):
            continue
        v = v.detach().cpu()
        if k in ("identity_code_book", "identity_code_one_shot"):
            v = v[:, None]
        if k == "color_b" and v.shape[0] == 3:
            v = torch.cat([v, torch.zeros((45,) + v.shape[1:])])
        sd[f"model.{k}"] = v
    gen = torch.Generator().manual_seed(0)
    for k in ("tokenizer.pcl_embeddings.weight", "post_processor.point_layer"
              ".weight", "post_processor.point_layer.bias",
              "camera_embedder.layers.0.weight"):
        sd[f"model.pointcloud_generator.{k}"] = torch.randn(
            8, 4, generator=gen)
    return sd
