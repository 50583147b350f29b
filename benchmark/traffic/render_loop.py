"""render_loop: V views of a fixed set of Gaussians a call, calls back to
back.

Set-up builds the scene with the reference copy of the synthetic two-hand
scene (the configuration's ``scene``), draws ``poses`` poses from the seed
around the bent-finger pose (joint 3 bent by 0.4 rad, each axis-angle
component moved by a uniform draw in [-pose_jitter, pose_jitter]), builds
each pose's decoration Gaussians once (colours from the seed), and places
``views`` orbit cameras around the bent pose at ``orbit_radius_factor``
times its largest distance from its mean. The program's
``rasterize_multiview`` then renders every pose once (the warm-up). The
window renders pose after pose, in order, until the time is up, keeping
each pose's last output. The check renders a seeded sample of
``check_calls`` poses with the reference and compares images, masks and
pair counts.

Traffic keys: poses, pose_jitter, check_calls, trace_seconds.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import oneshot


class State:
    pass


def make_scene(run):
    """(the pose list of reference Gaussians, w2cs, Ks)."""
    from benchmark.reference.data.rays import orbit_cameras
    from benchmark.reference.data.synthetic import SyntheticHandScene
    sc, t, dev = run.config["scene"], run.traffic, run.device
    scene = SyntheticHandScene.build(
        sc["mesh"], subdivide=sc["subdivide"], height=sc["height"],
        width=sc["width"], seed=sc["scene_seed"], device=dev)
    bent = np.zeros((16, 3), np.float32)
    bent[3, 2] = 0.4
    rng = np.random.RandomState(oneshot.np_seed(run.seed))
    colour_seed = int(rng.randint(1 << 31))
    poses = [bent + rng.uniform(-t["pose_jitter"], t["pose_jitter"],
                                (2, 16, 3)).astype(np.float32)
             for _ in range(t["poses"])]
    with torch.no_grad():
        pts = scene.pose_points(torch.as_tensor(bent.reshape(-1), device=dev),
                                torch.as_tensor(bent.reshape(-1), device=dev))
        center = pts.mean(0)
        radius = float(torch.linalg.norm(pts - center[None], dim=1).max()) \
            * sc["orbit_radius_factor"]
        w2cs, Ks = orbit_cameras(center.cpu().numpy(), radius, scene.K,
                                 n_views=sc["views"])
        gs = [scene.decoration_gaussians(
            scene.pose_points(torch.as_tensor(p[0].reshape(-1), device=dev),
                              torch.as_tensor(p[1].reshape(-1), device=dev)),
            seed=colour_seed) for p in poses]
    return gs, torch.as_tensor(w2cs, device=dev), torch.as_tensor(Ks,
                                                                   device=dev)


def setup(run) -> State:
    from guassianhand_tpu_torch.core.gaussians import Gaussians
    from guassianhand_tpu_torch.ops.rasterize import (RasterizeConfig,
                                                      rasterize_multiview)
    s = State()
    sc = run.config["scene"]
    run.mark("imports")
    s.ref_gs, s.w2cs, s.Ks = make_scene(run)
    run.mark("scene and gaussians")
    s.gs = [Gaussians(xyz=g.xyz, opacity=g.opacity, rotation=g.rotation,
                      scaling=g.scaling, shs=g.shs) for g in s.ref_gs]
    raster = RasterizeConfig(**run.config.get("raster", {}))
    s.hw = (sc["height"], sc["width"])

    def render(g):
        with torch.inference_mode():
            return rasterize_multiview(g, s.w2cs, s.Ks, height=s.hw[0],
                                       width=s.hw[1], use_rgb=True,
                                       config=raster)
    s.render = render
    for g in s.gs:
        render(g)
    run.mark("warm-up renders")
    return s


def window(s: State, run) -> dict:
    n, k = 0, len(s.gs)
    s.kept: Dict[int, dict] = {}
    per_pose = [0] * k
    while not run.expired():
        out = s.render(s.gs[n % k])
        s.kept[n % k] = out
        per_pose[n % k] += 1
        n += 1
    seconds = run.stop()
    views = n * s.w2cs.shape[0]
    return {"e2e": {"views_per_s": views / seconds}, "attempted": n,
            "failed": 0, "layer": {"calls": n, "per_pose": per_pose}}


def reference_render(s: State, i: int, work: bool = False) -> dict:
    from benchmark.reference.ops.rasterize import rasterize_multiview
    with torch.no_grad():
        return rasterize_multiview(s.ref_gs[i], s.w2cs, s.Ks,
                                   height=s.hw[0], width=s.hw[1], work=work)


def sample(s: State, run) -> List[int]:
    rng = np.random.RandomState(oneshot.np_seed(run.seed) ^ 0x5EED)
    kept = sorted(s.kept)
    n = min(run.traffic["check_calls"], len(kept))
    return sorted(rng.choice(kept, n, replace=False).tolist())


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    return {"rgb_gap": float((prog["comp_rgb"] - ref["comp_rgb"])
                             .abs().max()),
            "mask_gap": float((prog["comp_mask"] - ref["comp_mask"])
                              .abs().max()),
            "pairs_gap": float(abs(int(prog["n_pairs"])
                                   - int(ref["n_pairs"])))}


def _worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def check(s: State, run) -> Dict[str, float]:
    from benchmark.reference import precision
    precision.set_mode("reference")
    picked = sample(s, run)
    s.kept = {i: s.kept[i] for i in picked}
    gc.collect()
    rows = []
    for i in picked:
        rows.append(compare(s.kept[i], reference_render(s, i)))
        gc.collect()
    return _worst(rows)


def counts(s: State, run, win: dict) -> dict:
    """Per pose rendered in the traced window: its calls and the forward
    composite's work at the reference's binning of it."""
    calls = []
    for i, n in enumerate(win["layer"]["per_pose"]):
        if not n:
            continue
        r = reference_render(s, i, work=True)
        calls.append((n, {"n_tiles": r["n_tiles"], "n_pairs": r["n_pairs"],
                          "n_rows": s.w2cs.shape[0] * s.gs[i].n,
                          "height": s.w2cs.shape[0] * (-(-s.hw[0] // 16) * 16),
                          "width": s.hw[1],
                          "fp32_ops": r["work"]["forward_ops"]}))
    return {"k1_calls": calls}


def control(run, fault=None) -> Dict[str, float]:
    """The check's numbers with the reference one precision step down
    (TF32 products) in the program's place, on a sample of the poses."""
    from benchmark.reference import precision
    s = State()
    s.ref_gs, s.w2cs, s.Ks = make_scene(run)
    s.hw = (run.config["scene"]["height"], run.config["scene"]["width"])
    s.kept = dict.fromkeys(range(len(s.ref_gs)))
    rows = []
    for i in sample(s, run):
        precision.set_mode("control")
        low = reference_render(s, i)
        precision.set_mode("reference")
        rows.append(compare(low, reference_render(s, i)))
    return _worst(rows)
