"""The synthetic two-hand scene on the program's side, of the same hands
as the reference's (``reference/mano/model.py::hand_mesh``, the
benchmark's MANO-topology mesh): the program's
``data/synthetic.py::SyntheticHandScene`` with the program's own MANO
model, subdivision plans and UV atlas made of those arrays, as its
``build`` makes them of the program's strip hand."""
from __future__ import annotations

import numpy as np
import torch


def program_scene(mesh: dict, subdivide: int, height: int, width: int,
                  seed: int, device):
    from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene
    from guassianhand_tpu_torch.mano.lbs import ManoModel
    from guassianhand_tpu_torch.mano.uv import synthetic_uv_atlas
    from guassianhand_tpu_torch.ops.subdivision import \
        build_subdivision_plans
    from benchmark.reference.mano.model import hand_mesh
    device = torch.device(device)

    def hand(s, right):
        a = hand_mesh(**mesh, seed=s)
        model = ManoModel(
            **{k: torch.as_tensor(a[k], dtype=torch.float32, device=device)
               for k in ("v_template", "shapedirs", "posedirs",
                         "j_regressor", "lbs_weights")},
            parents=a["parents"], faces=a["faces"])
        n = a["v_template"].shape[0]
        plans = build_subdivision_plans(a["faces"], n, subdivide)
        uv = synthetic_uv_atlas(a["v_template"], right)
        for plan in plans:
            e = plan.edges
            uv = np.concatenate([uv, 0.5 * (uv[e[:, 0]] + uv[e[:, 1]])])
        return model, plans, uv

    model_r, plans_r, uv_r = hand(seed, True)
    model_l, plans_l, uv_l = hand(seed + 1, False)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 0.6
    return SyntheticHandScene(model_r, model_l, plans_r, plans_l, uv_r, uv_l,
                              height, width, K, w2c, device)
