"""InterHand2.6M one-shot data (counterpart of ``data/interhand.py``),
from the processed layout the reference reads:

  processed_dataset/{mode}/index_identity_*/{i}.pkl       index records
  processed_dataset/{mode}/annotation/capture{c}/cam{cam}/frame{f}.pkl
  processed_dataset/{mode}/{image,mask,mask_sa,bbox_mask}/capture{c}/...jpg
  InterHand2.6M/annotations/{mode}/InterHand2.6M_{mode}_joint_3d.json
  InterHand2.6M/annotations/{mode}/InterHand2.6M_{mode}_MANO_NeuralAnnot.json

The host reads the pickles, the images and the MANO parameters; the
posing (LBS and edge subdivision of each hand, ``pose_sample``) and the kNN
interaction mask run on the dataset's device. The static topology (the
subdivision plans and the per-vertex UV table, from the real UV atlas where
``load_uv_atlas`` finds one, else the synthetic one) is built once, on the
host.

Splits as in the reference: 'train' refits the one-shot frame (index 2)
for 50 steps an epoch (100 in edit mode, on the fixed edit frame); the
test sequences 'oneshot_reg_i' (14 frames), 'oneshot_nv' (50) and the
default (349, stride 10).

Images decode through the native loader (``data/native_loader.py``) where
it loads, as uint8 by ``(decode * 255).astype(uint8)``, the JAX package's
truncation; else through PIL, which is imported only then, for an edit
image or mask, and for a ``ratio`` other than 1.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from guassianhand_tpu_torch.data.native_loader import (decode_image,
                                                       native_library,
                                                       pil_image)
from guassianhand_tpu_torch.data.rays import (bounds_from_points,
                                              get_mask_at_box)
from guassianhand_tpu_torch.mano.lbs import lbs
from guassianhand_tpu_torch.mano.model import load_mano_model
from guassianhand_tpu_torch.mano.uv import (load_uv_atlas, static_vertex_uv,
                                            synthetic_uv_atlas)
from guassianhand_tpu_torch.ops.knn import interaction_mask
from guassianhand_tpu_torch.ops.subdivision import (build_subdivision_plans,
                                                    subdivide_n)

HANDS = ("right", "left")


def color_jitter(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Brightness, contrast and saturation jitter of (H, W, 3) float [0, 1],
    drawn from ``rng`` in that order (the reference's ranges)."""
    b = rng.uniform(0.2, 2.0)
    c = rng.uniform(0.3, 2.0)
    s = rng.uniform(0.2, 2.0)
    out = np.clip(img * b, 0, 1)
    mean = out.mean()
    out = np.clip((out - mean) * c + mean, 0, 1)
    gray = out.mean(-1, keepdims=True)
    return np.clip((out - gray) * s + gray, 0, 1).astype(np.float32)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """The mask with its holes filled (what the border's flood fill does
    not reach)."""
    from scipy import ndimage
    return ndimage.binary_fill_holes(mask.astype(bool)).astype(mask.dtype)


@dataclasses.dataclass
class InterHandConfig:
    data_root: str = "./processed_dataset"
    annot_path: str = "./InterHand2.6M/annotations"
    mode: str = "test"
    split: str = "train"                  # train / val / test
    pose_sequence: Optional[str] = None   # oneshot_reg_i / oneshot_nv / ...
    edge_subdivide: int = 2
    mask_sa: bool = True
    render_mask: bool = True
    ratio: float = 1.0
    height: int = 256
    width: int = 256
    mano_models_path: Optional[str] = None
    mano_uv_path: Optional[str] = None
    # edit mode: the train split's fixed fit frame
    # (index_identity0_train_i/11388.pkl), an optional custom target image
    # and mask (an RGBA image's alpha is the mask), the drive sequence
    # index_identity_all_train_i on the test split
    edit: bool = False
    image_path: Optional[str] = None
    mask_path: Optional[str] = None
    color_jitter: bool = False
    use_native_loader: bool = True


class InterHandDataset:
    """Host-side loading and on-device posing of InterHand2.6M frames;
    ``load_sample`` gives the model's batch (B = 1) on ``device`` (default
    ``cuda``)."""

    def __init__(self, cfg: InterHandConfig, device=None):
        if cfg.edit and cfg.mode != "train":
            # the reference edits on the train mode's frames
            cfg = dataclasses.replace(cfg, mode="train")
        self.cfg = cfg
        self.device = torch.device(device or "cuda")
        self._rng = np.random.RandomState(0)
        self.mano = {h: load_mano_model(h, cfg.mano_models_path,
                                        device=self.device) for h in HANDS}
        if any(m is None for m in self.mano.values()):
            raise FileNotFoundError(
                "MANO model pickles not found (set $MANO_MODELS_PATH or "
                "cfg.mano_models_path)")
        ann = os.path.join(cfg.annot_path, cfg.mode)
        with open(os.path.join(
                ann, f"InterHand2.6M_{cfg.mode}_joint_3d.json")) as f:
            self.joints = json.load(f)
        with open(os.path.join(
                ann, f"InterHand2.6M_{cfg.mode}_MANO_NeuralAnnot.json")) as f:
            self.manos = json.load(f)
        lib, _ = native_library()
        self.decoder = ("native" if cfg.use_native_loader and lib is not None
                        else "PIL")
        self._build_topology()

    def _build_topology(self) -> None:
        cfg = self.cfg
        self.plans, self.uv_tables = {}, {}
        atlas = load_uv_atlas(cfg.mano_uv_path)
        for hand in HANDS:
            model = self.mano[hand]
            v_template = model.v_template.cpu()
            faces = model.faces
            plans = build_subdivision_plans(faces, v_template.shape[0],
                                            cfg.edge_subdivide)
            self.plans[hand] = plans
            rest_sub = subdivide_n(v_template, plans).numpy()
            v_template = v_template.numpy()
            if atlas is not None and "change_r" in atlas:
                # the coarse UV mesh of the atlas: change_* maps a UV vertex
                # to its mesh vertex, ft_* are faces over the UV vertices
                change = atlas["change_r" if hand == "right" else "change_l"]
                ft = atlas["ft_r"] if hand == "right" else atlas.get(
                    "face_left", atlas["ft_r"])
                vt = atlas["vt"]
                n_uv = vt.shape[0] // 2
                vt_hand = vt[:n_uv] if hand == "right" else vt[n_uv:]
                ft = np.asarray(ft).astype(int)
                tri_xyz = v_template[np.asarray(change).astype(int)][ft]
                tri_uv = vt_hand[ft]
            else:
                uv = synthetic_uv_atlas(v_template, right=(hand == "right"))
                tri_xyz, tri_uv = v_template[faces], uv[faces]
            self.uv_tables[hand] = static_vertex_uv(rest_sub, tri_xyz, tri_uv)
        self.vert_uv = np.concatenate([self.uv_tables[h] for h in HANDS])

    def __len__(self) -> int:
        cfg = self.cfg
        if cfg.split == "train":
            return 100 if cfg.edit else 50
        if cfg.split == "val":
            return 1
        if cfg.pose_sequence == "oneshot_reg_i":
            return 14
        if cfg.pose_sequence == "oneshot_nv":
            return 50
        if cfg.pose_sequence == "oneshot_train":
            return 1
        return 10000 if cfg.edit else 349

    def _index_record(self, index: int) -> Dict:
        cfg = self.cfg
        if cfg.split in ("train", "val") or cfg.pose_sequence == "oneshot_train":
            if cfg.edit:
                sub, idx = "index_identity0_train_i", 11388
            else:
                sub, idx = "index_identity_test_i_one_shot", 2
        elif cfg.pose_sequence == "oneshot_nv":
            sub, idx = "index_identity_os_i_test_nv", index
        elif cfg.edit:
            sub, idx = "index_identity_all_train_i", index * 10
        else:
            sub, idx = "index_identity_test_i_one_shot", index * 10
        path = os.path.join(cfg.data_root, cfg.mode, sub, f"{idx}.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    def pose_sample(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """MANO parameters ({hand}_{pose,shape,trans}) -> the posed,
        subdivided points of both hands (N, 3), right hand first."""
        return torch.cat([
            subdivide_n(lbs(self.mano[h], params[f"{h}_shape"],
                            params[f"{h}_pose"], params[f"{h}_trans"])[0],
                        self.plans[h]) for h in HANDS])

    def _mano_params(self, capture_id, frame_idx, t_pose: bool = False):
        """The frame's MANO parameters on the device; with ``t_pose`` the
        canonical pose (zero pose, the left hand at +0.5 so that the hands
        never meet)."""
        rec = self.manos[str(capture_id)][str(frame_idx)]
        out = {}
        for hand in HANDS:
            h = rec[hand]
            if h is None:
                pose = np.zeros(48, np.float32)
                shape = np.zeros(10, np.float32)
                trans = np.zeros(3, np.float32)
            else:
                pose = np.asarray(h["pose"], np.float32).reshape(-1)[:48]
                shape = np.asarray(h["shape"], np.float32).reshape(-1)[:10]
                trans = np.asarray(h["trans"], np.float32).reshape(-1)[:3]
            if t_pose:
                pose = np.zeros(48, np.float32)
                trans = np.full(3, 0.5 if hand == "left" else 0.0, np.float32)
            for name, x in (("pose", pose), ("shape", shape),
                            ("trans", trans)):
                out[f"{hand}_{name}"] = torch.as_tensor(x, device=self.device)
        return out

    def _load_images(self, capture_id, cam, frame_idx):
        """(rgb (H, W, 3) float32, black outside the mask; mask (H, W)
        float32; bbox_mask (H, W) float32), numpy."""
        cfg = self.cfg
        base = os.path.join(cfg.data_root, cfg.mode)
        stem = f"capture{capture_id}/cam{cam}/frame{frame_idx}.jpg"

        def read(kind):
            p = os.path.join(base, kind, stem)
            if not os.path.exists(p):
                return None
            if self.decoder == "native":
                # masks are thresholded below, so RGB serves them too
                return (decode_image(p) * 255.0).astype(np.uint8)
            return np.asarray(pil_image().open(p))

        alpha_mask = None
        if cfg.edit and cfg.image_path:
            pim = pil_image().open(cfg.image_path)
            if pim.size != (cfg.width, cfg.height):
                pim = pim.resize((cfg.width, cfg.height))
            arr = np.asarray(pim)
            if arr.ndim == 3 and arr.shape[-1] == 4:
                alpha_mask = arr[..., 3]
                arr = arr[..., :3]
            img = arr.astype(np.float32) / 255.0
        else:
            img = read("image").astype(np.float32) / 255.0
        if cfg.color_jitter and cfg.split == "train" and not cfg.edit:
            img = color_jitter(img, self._rng)
        if alpha_mask is not None and not cfg.mask_path:
            mask = alpha_mask
        elif cfg.edit and cfg.mask_path:
            mask = np.asarray(pil_image().open(cfg.mask_path))
        elif cfg.edit:
            mask = read("mask")
        else:
            mask = read("mask_sa" if cfg.mask_sa else "mask")
            if mask is None:
                mask = read("mask")
        mask = (mask >= 100).astype(np.uint8)
        if mask.ndim == 3:
            mask = (mask.mean(-1) > 0.5).astype(np.uint8)
        if cfg.render_mask:
            mask = fill_holes(mask)
            mask_mano = read("mask")
            if mask_mano is not None:
                mm = (mask_mano >= 100).astype(np.uint8)
                if mm.ndim == 3:
                    mm = mm[..., 0]
                mask[mm == 0] = 0
        bbox_mask = read("bbox_mask")
        if bbox_mask is None:
            bbox_mask = np.ones_like(mask)
        else:
            bbox_mask = (bbox_mask >= 100).astype(np.uint8)
            if bbox_mask.ndim == 3:
                bbox_mask = bbox_mask[..., 0]

        if cfg.ratio != 1.0:
            image = pil_image()
            h, w = img.shape[:2]
            size = (int(w * cfg.ratio), int(h * cfg.ratio))
            img = np.asarray(image.fromarray(
                (img * 255).astype(np.uint8)).resize(size),
                np.float32) / 255.0
            mask = (np.asarray(image.fromarray(
                (mask * 255).astype(np.uint8)).resize(
                    size, image.NEAREST)) > 127).astype(np.uint8)
            bbox_mask = np.asarray(image.fromarray(
                (bbox_mask * 255).astype(np.uint8)).resize(
                    size, image.NEAREST)).astype(np.float32) / 255.0

        img = img * (mask > 0)[..., None]
        return img, mask.astype(np.float32), bbox_mask.astype(np.float32)

    def load_sample(self, index: int) -> Dict:
        """The model's batch (B = 1) for frame ``index``, its targets and
        the evaluation's extras: tensors on the device, except bbox_mask,
        mask_at_box (numpy), capture_id, frame_idx, cam, znear and zfar."""
        cfg = self.cfg
        rec = self._index_record(index)
        capture_id, frame_idx, cam = rec["capture"], rec["frame"], rec["cam"]
        path = os.path.join(
            cfg.data_root, cfg.mode, "annotation",
            f"capture{capture_id}/cam{cam}/frame{frame_idx}.pkl")
        with open(path, "rb") as f:
            anno = pickle.load(f)
        in_R = np.asarray(anno["camera"]["R"], np.float32).reshape(3, 3)
        in_t = np.asarray(anno["camera"]["t"], np.float32).reshape(3)
        K = np.asarray(anno["camera"]["in_K"], np.float32).reshape(3, 3)

        img, mask, bbox_mask = self._load_images(capture_id, cam, frame_idx)
        h, w = img.shape[:2]

        mp = self._mano_params(capture_id, frame_idx)
        points = self.pose_sample(mp)
        points_t = self.pose_sample(
            self._mano_params(capture_id, frame_idx, t_pose=True))
        inter = interaction_mask(points, points_t)

        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = in_R
        w2c[:3, 3] = in_t
        c2w = np.linalg.inv(w2c)
        K_normed = K.copy()
        K_normed[0] /= w
        K_normed[1] /= h
        mask_at_box, znear, zfar = get_mask_at_box(
            bounds_from_points(points.cpu().numpy()), K, in_R, in_t, h, w)

        def dev(x):
            return torch.as_tensor(x, device=self.device)

        return {
            "points": points[None],
            "points_tar": points[None],
            "vert_uv": dev(self.vert_uv)[None],
            "inter_mask": inter[None],
            "mano_pose": torch.cat([mp["right_pose"], mp["left_pose"]])[None],
            "c2w": dev(c2w)[None],
            "intrinsic_normed": dev(K_normed)[None],
            "w2c_render": dev(w2c)[None, None],
            "K_render": dev(K)[None, None],
            "background": torch.zeros((1, 3), device=self.device),
            "target_rgb": dev(img)[None],
            "target_mask": dev(mask)[None],
            "bbox_mask": bbox_mask,
            "mask_at_box": mask_at_box,
            "capture_id": capture_id,
            "frame_idx": frame_idx,
            "cam": cam,
            "znear": znear,
            "zfar": zfar,
        }
