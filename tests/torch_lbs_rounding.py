"""Where the port's LBS and the JAX package's round apart (not a test).

  JAX_PLATFORMS=cpu python -m tests.torch_lbs_rounding

On the synthetic scene of tests/test_torch_inputs.py (96 vertices,
subdivide 1, pose seed 3) it prints, stage by stage, how many values of the
port's ``mano/lbs.py`` differ from JAX's on the same inputs; how many
outputs of the joint regression ``j_regressor @ v_shaped`` each of several
summation orders reproduces; and the points that differ and the interaction
mask flips when JAX's rodrigues and JAX's joint regression replace the
port's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from guassianhand_tpu.core.transforms import rodrigues as j_rodrigues
from guassianhand_tpu.data.synthetic import SyntheticHandScene as JScene
from guassianhand_tpu.data.synthetic import synthetic_batch as j_batch
from guassianhand_tpu_torch.core.transforms import rodrigues
from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene
from guassianhand_tpu_torch.mano import lbs as port_lbs
from guassianhand_tpu_torch.ops.knn import interaction_mask
from guassianhand_tpu_torch.ops.subdivision import subdivide_n


def differ(a, b) -> str:
    a, b = np.asarray(a), np.asarray(b)
    return f"{int((a != b).sum())}/{a.size} differ, max {np.abs(a - b).max():.3g}"


def summation_orders(J, V):
    def sequential(fma):
        out = np.zeros((J.shape[0], V.shape[1]), np.float32)
        for k in range(J.shape[1]):
            prod = J[:, k:k + 1].astype(np.float64) * V[k][None]
            out = ((out + prod) if fma else
                   (out + prod.astype(np.float32))).astype(np.float32)
        return out

    def lanes(n):
        acc = np.zeros((n, J.shape[0], V.shape[1]), np.float32)
        for k in range(J.shape[1]):
            acc[k % n] = (acc[k % n] + J[:, k:k + 1] * V[k][None])
        while acc.shape[0] > 1:
            acc = (acc[:acc.shape[0] // 2] + acc[acc.shape[0] // 2:])
        return acc[0]

    return {"torch.matmul": (torch.from_numpy(J) @ torch.from_numpy(V)).numpy(),
            "numpy": J @ V, "sequential": sequential(False),
            "sequential fma": sequential(True),
            **{f"{n} lanes, tree": lanes(n) for n in (2, 4, 8, 16)},
            "float64, rounded": (J.astype(np.float64) @ V).astype(np.float32)}


def main():
    jax.config.update("jax_platforms", "cpu")
    js = JScene.build(n_vertices=96, subdivide=1, height=64, width=64)
    ts = SyntheticHandScene.build(n_vertices=96, subdivide=1, height=64,
                                  width=64, device="cpu")
    jb = {k: np.asarray(v) for k, v in jax.jit(
        lambda: j_batch(js, seed=3, with_target=False))().items()}
    rng = np.random.RandomState(3)
    poses = [rng.uniform(-0.3, 0.3, 48).astype(np.float32) for _ in range(2)]
    rv = poses[0].reshape(16, 3)
    theta = np.linalg.norm(rv, axis=-1)
    print("sin", differ(jax.jit(jnp.sin)(theta), torch.sin(torch.tensor(theta))))
    print("cos", differ(jax.jit(jnp.cos)(theta), torch.cos(torch.tensor(theta))))
    print("rodrigues", differ(jax.jit(j_rodrigues)(rv),
                              rodrigues(torch.from_numpy(rv))))
    J = np.asarray(js.model_r.j_regressor)
    V = np.asarray(js.model_r.v_template)
    want = np.asarray(jax.jit(lambda a, b: a @ b)(J, V))
    for name, got in summation_orders(J, V).items():
        print(f"j_regressor @ v_template, {name}: {differ(want, got)}")

    def port_points(jax_rodrigues: bool, jax_joints: bool):
        class JaxDot:
            def __init__(self, m):
                self.m = m

            def __matmul__(self, v):
                return torch.from_numpy(np.asarray(jax.jit(
                    lambda a, b: a @ b)(self.m.numpy(), v.numpy())))

        def rod(x):
            if jax_rodrigues:
                return torch.from_numpy(np.asarray(
                    jax.jit(j_rodrigues)(x.numpy())))
            return rodrigues(x)

        saved, port_lbs.rodrigues = port_lbs.rodrigues, rod
        pts = []
        for model, plans, pose, mirror in (
                (ts.model_r, ts.plans_r, poses[0], False),
                (ts.model_l, ts.plans_l, poses[1], True)):
            if jax_joints:
                model = dataclasses.replace(model,
                                            j_regressor=JaxDot(model.j_regressor))
            v, _ = port_lbs.lbs(model, torch.zeros(10), torch.from_numpy(pose))
            if mirror:
                v = v * torch.tensor([-1.0, 1.0, 1.0]) \
                    + torch.tensor([0.08, 0.0, 0.0])
            pts.append(subdivide_n(v, plans))
        port_lbs.rodrigues = saved
        return torch.cat(pts)

    tpose = ts.pose_points(torch.zeros(48), torch.zeros(48))
    for jr in (False, True):
        for jj in (False, True):
            p = port_points(jr, jj)
            mask = interaction_mask(p, tpose, k=min(100, p.shape[0] // 4))
            pts_differ = int((p.numpy() != jb["points"][0]).any(-1).sum())
            flips = int((mask.numpy() != jb["inter_mask"][0]).sum())
            print(f"JAX rodrigues {jr}, JAX joints {jj}: points "
                  f"{pts_differ}/{p.shape[0]} differ, mask flips {flips}")


if __name__ == "__main__":
    main()
