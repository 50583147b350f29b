"""The benchmark's synthetic MANO-shaped hand, with MANO's surface topology.

The licensed MANO pickles are not in the repository, and the program's own
synthetic hand is a triangle strip (each face emitted twice), whose few
edges make edge subdivision yield far fewer vertices than MANO's surface
does. This hand is a tube of ``rings`` rings of ``ring`` vertices, open at
the wrist and closed at the tip by a band down to a ring of ``cap_ring``
vertices and a fan round one apex vertex: with 48 rings of 16 and a cap
ring of 9 it has MANO's 778 vertices, 1,538 faces, 2,315 edges and
16-vertex wrist loop, so that edge subdivision 2 and 3 times gives MANO's
12,337 and 49,281 vertices a hand. Skinning weights and the joint
regressor follow the position along the hand's axis; shape and pose
blend shapes are drawn from the seed.

``hand_mesh`` gives the raw arrays, the input that the benchmark hands to
both the program and the reference; ``mano_model`` makes the reference's
ManoModel of them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.mano.lbs import N_JOINTS, ManoModel

MANO_PARENTS = np.array(
    [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int64)
LENGTH, RADIUS = 0.12, 0.03


def tube_faces(rings: int, ring: int, cap_ring: int) -> np.ndarray:
    """(F, 3) int32 faces of the closed-tip tube: ring k holds the vertices
    k * ring ... (k + 1) * ring - 1, the cap ring follows them, then the
    apex. F = 2 ring (rings - 1) + ring + 2 cap_ring."""
    faces = []
    for k in range(rings - 1):
        a, b = k * ring, (k + 1) * ring
        for i in range(ring):
            j = (i + 1) % ring
            faces += [(a + i, a + j, b + i), (a + j, b + j, b + i)]
    # the band from the last ring to the cap ring: walk both rings by
    # angle, one triangle a step, ring + cap_ring steps in all
    outer, inner = (rings - 1) * ring, rings * ring
    i = j = 0
    while i < ring or j < cap_ring:
        t_outer = (i + 1) / ring
        t_inner = (j + 0.5) / cap_ring
        o0, o1 = outer + i % ring, outer + (i + 1) % ring
        c0, c1 = inner + j % cap_ring, inner + (j + 1) % cap_ring
        if j >= cap_ring or (i < ring and t_outer <= t_inner):
            faces.append((o0, o1, c0))
            i += 1
        else:
            faces.append((o0, c1, c0))
            j += 1
    apex = inner + cap_ring
    faces += [(inner + j, inner + (j + 1) % cap_ring, apex)
              for j in range(cap_ring)]
    return np.asarray(faces, np.int32)


def hand_mesh(rings: int = 48, ring: int = 16, cap_ring: int = 9,
              seed: int = 0) -> Dict[str, np.ndarray]:
    """One hand's MANO arrays (numpy, float32 but parents and faces):
    v_template (V, 3), shapedirs (V, 3, 10), posedirs (V, 3, 135),
    j_regressor (16, V), lbs_weights (V, 16), parents (16,), faces."""
    rng = np.random.RandomState(seed)
    ang = 2 * np.pi * np.arange(ring) / ring
    ys = LENGTH * np.arange(rings) / (rings - 1)
    tube = np.stack([np.broadcast_to(RADIUS * np.cos(ang), (rings, ring)),
                     np.broadcast_to(ys[:, None], (rings, ring)),
                     np.broadcast_to(RADIUS * np.sin(ang), (rings, ring))],
                    axis=-1).reshape(-1, 3)
    ang_c = 2 * np.pi * (np.arange(cap_ring) + 0.5) / cap_ring
    cap = np.stack([0.6 * RADIUS * np.cos(ang_c),
                    np.full(cap_ring, LENGTH + 0.3 * RADIUS),
                    0.6 * RADIUS * np.sin(ang_c)], axis=1)
    apex = np.array([[0.0, LENGTH + 0.45 * RADIUS, 0.0]])
    base = np.concatenate([tube, cap, apex])
    n = base.shape[0]
    v_template = (base + 0.001 * rng.normal(size=(n, 3))).astype(np.float32)

    joints_y = np.linspace(0, 0.11, N_JOINTS)
    j_reg = np.zeros((N_JOINTS, n), np.float32)
    for j in range(N_JOINTS):
        w = np.exp(-np.abs(v_template[:, 1] - joints_y[j]) * 80)
        j_reg[j] = w / w.sum()
    d_all = np.abs(v_template[:, 1][:, None] - joints_y[None, :])
    lbs_w = np.exp(-d_all * 60)
    lbs_w = (lbs_w / lbs_w.sum(1, keepdims=True)).astype(np.float32)
    return {"v_template": v_template,
            "shapedirs": (0.01 * rng.normal(size=(n, 3, 10))).astype(
                np.float32),
            "posedirs": (0.001 * rng.normal(size=(n, 3, 135))).astype(
                np.float32),
            "j_regressor": j_reg, "lbs_weights": lbs_w,
            "parents": MANO_PARENTS.copy(),
            "faces": tube_faces(rings, ring, cap_ring)}


def mano_model(arrays: Dict[str, np.ndarray], device=None) -> ManoModel:
    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return ManoModel(v_template=dev(arrays["v_template"]),
                     shapedirs=dev(arrays["shapedirs"]),
                     posedirs=dev(arrays["posedirs"]),
                     j_regressor=dev(arrays["j_regressor"]),
                     lbs_weights=dev(arrays["lbs_weights"]),
                     parents=arrays["parents"], faces=arrays["faces"])
