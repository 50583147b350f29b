"""MANO linear blend skinning (a frozen copy of the program's ``mano/lbs.py``):

  v_shaped = v_template + shapedirs @ betas
  J        = J_regressor @ v_shaped
  v_posed  = v_shaped + posedirs @ (R(pose) - I)
  T_k      = global rigid transforms down the kinematic tree
  v        = (sum_k w_k T_k) * v_posed + trans
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference.core.transforms import rodrigues

N_JOINTS = 16  # root + 15 finger joints


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """One hand's MANO tensors; ``parents`` and ``faces`` are numpy."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, n_betas)
    posedirs: torch.Tensor     # (V, 3, 135)
    j_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: np.ndarray        # (J,) int, parents[0] == -1
    faces: np.ndarray          # (F, 3) int32


def lbs(model: ManoModel, betas: torch.Tensor, pose: torch.Tensor,
        trans: Optional[torch.Tensor] = None):
    """betas (n_betas,), pose (J*3,) axis-angle incl. global orient,
    trans (3,) or None -> (vertices (V, 3), joints (J, 3))."""
    v_shaped = model.v_template + torch.einsum("vdb,b->vd", model.shapedirs,
                                               betas)
    joints = model.j_regressor @ v_shaped
    rots = rodrigues(pose.reshape(N_JOINTS, 3))
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_feature = (rots[1:] - eye).reshape(-1)
    v_posed = v_shaped + torch.einsum("vdp,p->vd", model.posedirs,
                                      pose_feature)

    parents = model.parents
    rel_joints = torch.cat([joints[:1], joints[1:] - joints[parents[1:]]])
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=rots.dtype,
                          device=rots.device).expand(N_JOINTS, 1, 4)
    local_tf = torch.cat([torch.cat([rots, rel_joints[:, :, None]], dim=2),
                          bottom], dim=1)                     # (J, 4, 4)
    chain = [local_tf[0]]
    for i in range(1, N_JOINTS):
        chain.append(chain[parents[i]] @ local_tf[i])
    global_tf = torch.stack(chain)

    posed_joints = global_tf[:, :3, 3]
    joints_h = torch.cat([joints, torch.zeros_like(joints[:, :1])], dim=1)
    correction = torch.einsum("jab,jb->ja", global_tf, joints_h)
    rel_tf = global_tf.clone()
    rel_tf[:, :, 3] -= correction

    T = torch.einsum("vj,jab->vab", model.lbs_weights, rel_tf)
    v = torch.einsum("vab,vb->va", T[:, :3, :3], v_posed) + T[:, :3, 3]
    if trans is not None:
        v = v + trans[None, :]
        posed_joints = posed_joints + trans[None, :]
    return v, posed_joints
