"""MANO models (counterpart of ``mano/model.py``): the licensed MANO
pickles, and a synthetic MANO-like hand for running every stage without
them.

``load_mano_model`` reads ``MANO_RIGHT.pkl`` / ``MANO_LEFT.pkl`` in the
smplx layout from the path given, ``$MANO_MODELS_PATH``, ``./assets/mano``
or ``./smplx/models/mano``, in that order. The published pickles hold
chumpy arrays, which unpickle only where the ``chumpy`` package is
installed; a pickle of numpy arrays (or scipy sparse ones) needs nothing
more.

The synthetic hand's strip topology emits every triangle twice, once per
winding, exactly as the JAX package does; the port reproduces that because
it is held to the JAX package.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from guassianhand_tpu_torch.mano.lbs import N_JOINTS, ManoModel

MANO_PARENTS = np.array(
    [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int64)


def _to_np(x) -> np.ndarray:
    """chumpy arrays expose ``.r``, scipy sparse ones ``.toarray()``."""
    if hasattr(x, "r"):
        return np.asarray(x.r)
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def load_mano_model(hand: str = "right", path: Optional[str] = None,
                    device=None) -> Optional[ManoModel]:
    """The MANO pickle of ``hand`` as a ManoModel on ``device`` (default
    the CPU), or None where no candidate file exists. ``path`` is the
    pickle or its directory. The left hand's shapedirs take smplx's sign
    fix (the first coordinate negated)."""
    name = f"MANO_{hand.upper()}.pkl"
    candidates = []
    if path:
        candidates.append(os.path.join(path, name) if os.path.isdir(path)
                          else path)
    env = os.environ.get("MANO_MODELS_PATH")
    for base in filter(None, [env, "./assets/mano", "./smplx/models/mano"]):
        candidates.append(os.path.join(base, name))
    fn = next((c for c in candidates if os.path.exists(c)), None)
    if fn is None:
        return None
    with open(fn, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    shapedirs = _to_np(data["shapedirs"]).astype(np.float32)
    if hand == "left" and np.abs(shapedirs[:, 0, :]).sum() > 0:
        shapedirs = shapedirs.copy()
        shapedirs[:, 0, :] *= -1
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    if "kintree_table" in data:
        # the root's parent is stored as 2^32 - 1: int32 wraps it to -1
        parents = (_to_np(data["kintree_table"])[0].astype(np.int64)
                   .clip(-1, None).astype(np.int32).astype(np.int64))
    else:
        parents = MANO_PARENTS

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return ManoModel(
        v_template=dev(_to_np(data["v_template"])),
        shapedirs=dev(shapedirs[..., :10]),
        posedirs=dev(posedirs.reshape(posedirs.shape[0], 3, -1)),
        j_regressor=dev(_to_np(data["J_regressor"])),
        lbs_weights=dev(_to_np(data["weights"])),
        parents=parents,
        faces=_to_np(data["f"]).astype(np.int32))


def synthetic_mano_model(n_vertices: int = 778, seed: int = 0,
                         device=None) -> ManoModel:
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 1, n_vertices)
    base = np.stack([0.03 * np.cos(40 * np.pi * t), 0.12 * t,
                     0.03 * np.sin(40 * np.pi * t)], axis=1)
    v_template = (base + 0.005 * rng.normal(size=(n_vertices, 3))).astype(
        np.float32)

    nf = 2 * (n_vertices - 2)
    faces = np.zeros((nf, 3), np.int32)
    for i in range(n_vertices - 2):
        faces[2 * i] = (i, i + 1, i + 2)
        faces[2 * i + 1] = (i + 2, i + 1, i)
    faces = faces[:1538] if nf >= 1538 else faces

    joints_y = np.linspace(0, 0.11, N_JOINTS)
    j_reg = np.zeros((N_JOINTS, n_vertices), np.float32)
    for j in range(N_JOINTS):
        w = np.exp(-np.abs(v_template[:, 1] - joints_y[j]) * 80)
        j_reg[j] = w / w.sum()
    d_all = np.abs(v_template[:, 1][:, None] - joints_y[None, :])
    lbs_w = np.exp(-d_all * 60)
    lbs_w = (lbs_w / lbs_w.sum(1, keepdims=True)).astype(np.float32)
    shapedirs = 0.01 * rng.normal(size=(n_vertices, 3, 10)).astype(np.float32)
    posedirs = 0.001 * rng.normal(size=(n_vertices, 3, 135)).astype(np.float32)

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return ManoModel(v_template=dev(v_template), shapedirs=dev(shapedirs),
                     posedirs=dev(posedirs), j_regressor=dev(j_reg),
                     lbs_weights=dev(lbs_w), parents=MANO_PARENTS,
                     faces=faces)
