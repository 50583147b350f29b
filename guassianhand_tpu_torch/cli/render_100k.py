"""BASELINE.json config #2 on the port (counterpart of
``scripts/render_100k.py``): the posed two-hand scene's Gaussians rendered
in V novel views at 512^2 through the stacked multi-view rasterizer, the
per-view forward latency printed as one JSON line.

  python -m guassianhand_tpu_torch.cli.render_100k [--views 8] [--interpret]

The scene is the synthetic two-hand one (MANO-shaped geometry, no licensed
assets): 778-vertex hands subdivided 3 times (27,700 vertices a hand, so
55,400 Gaussians, one a vertex: ``decoration_gaussians``, about 2 px
across at any resolution), posed by LBS with one bent finger, seen by
``orbit_cameras`` at 3 times the Gaussians' bounding radius. All views go
through one ``rasterize_multiview`` call (one binning, one composite
launch), with colours as RGB and the default ``RasterizeConfig``. Timed as
the JAX script times it: one warm-up call, then 5 calls, the device
synchronised after the last. Runs on ``cuda`` and fails where there is
none; ``--interpret`` keeps the JAX script's meaning of a smoke run at a
reduced size (128^2, one subdivision, one timed call), on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from guassianhand_tpu_torch.core.gaussians import Gaussians
from guassianhand_tpu_torch.data.rays import orbit_cameras
from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene
from guassianhand_tpu_torch.ops.rasterize import (RasterizeConfig,
                                                  rasterize_multiview)

FULL = {"hw": 512, "subdivide": 3, "reps": 5}
SMOKE = {"hw": 128, "subdivide": 1, "reps": 1}


def baseline_scene(hw: int, subdivide: int, views: int, device):
    """(Gaussians, w2cs (V, 4, 4), Ks (V, 3, 3)) of the scene: both hands
    in the bent-finger pose (joint 3's third axis-angle component 0.4),
    and ``views`` orbit cameras around the Gaussians' mean at 3 times
    their largest distance from it."""
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=subdivide,
                                     height=hw, width=hw, device=device)
    pose = torch.zeros((16, 3), device=scene.device)
    pose[3, 2] = 0.4
    g = scene.decoration_gaussians(scene.pose_points(pose.reshape(-1),
                                                     pose.reshape(-1)))
    center = g.xyz.mean(0)
    radius = float(torch.linalg.norm(g.xyz - center[None], dim=1).max()) \
        * 3.0
    w2cs, Ks = orbit_cameras(center.cpu().numpy(), radius, scene.K,
                             n_views=views)
    return (g, torch.as_tensor(w2cs, device=scene.device),
            torch.as_tensor(Ks, device=scene.device))


def render(g: Gaussians, w2cs: torch.Tensor, Ks: torch.Tensor, hw: int,
           config: RasterizeConfig = RasterizeConfig()) -> dict:
    """The views of ``g`` in one ``rasterize_multiview`` call."""
    with torch.inference_mode():
        return rasterize_multiview(g, w2cs, Ks, height=hw, width=hw,
                                   use_rgb=True, config=config)


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def run(views: int = 8, interpret: bool = False):
    """The benchmark: (the JSON line's fields, {"gaussians", "w2cs", "Ks",
    "out": the last render, "hw"})."""
    size = SMOKE if interpret else FULL
    device = "cpu" if interpret else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("render_100k: no CUDA device (--interpret runs the "
                         "smoke size on the CPU)")
    hw = size["hw"]
    g, w2cs, Ks = baseline_scene(hw, size["subdivide"], views, device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = render(g, w2cs, Ks, hw)
    sync()
    t0 = time.perf_counter()
    for _ in range(size["reps"]):
        out = render(g, w2cs, Ks, hw)
    sync()
    dt = (time.perf_counter() - t0) / size["reps"]
    n = g.n
    line = {
        "metric": f"novel-view render {hw}x{hw}, {n} gaussians, "
                  f"{views} views (BASELINE config #2)",
        "ms_per_view": round(1e3 * dt / views, 2),
        "n_pairs": int(out["n_pairs"]),
        "overflow": int(out["overflow"]),
        "backend": "cuda" if device == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu"),
        "power_limit": power_limit() if device == "cuda" else None,
    }
    return line, {"gaussians": g, "w2cs": w2cs, "Ks": Ks, "out": out,
                  "hw": hw}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("guassianhand-tpu-torch BASELINE config #2")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--interpret", action="store_true",
                    help="smoke run on the CPU at a reduced size (128^2, "
                         "one subdivision, one timed call)")
    args = ap.parse_args(argv)
    line, _ = run(args.views, args.interpret)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
