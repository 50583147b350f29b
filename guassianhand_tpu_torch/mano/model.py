"""Synthetic MANO-like hand (counterpart of ``mano/model.py::
synthetic_mano_model``): a deterministic fake hand with MANO's shapes, for
running every stage without the licensed MANO assets.

Its strip topology emits every triangle twice, once per winding, exactly
as the JAX package does; the port reproduces that because it is held to
the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from guassianhand_tpu_torch.mano.lbs import N_JOINTS, ManoModel

MANO_PARENTS = np.array(
    [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int64)


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
