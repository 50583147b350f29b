#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

  python3 chip_smoke.py

Phases, each reported on its own line:
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the render path's CUDA kernel compiled from csrc/ with nvcc
     for sm_90a;
  3. kernel vs plain: each kernel held against its plain PyTorch twin on
     the card at the bench scene (49,152 random Gaussians, 512^2), at edge
     cases the main path does not reach (odd image sizes, stacked views,
     tiles of more than 256 pairs, transparent and empty tiles) and at the
     avatar's own Gaussians, tolerance atol 2e-5 + rtol 1e-4 * |ref|; kernel
     and twin timed with CUDA events;
  4. the slice: the full-width one-shot avatar model (seeded weights)
     serves R = 4 requests, each one pose rendered in V = 4 orbit views at
     256^2; kernel launch counts are zeroed just before and read just after;
  5. reference: a small model rendered on the card and on the CPU with the
     same weights must agree.

Prints the kernel table as one JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}. Any failure raises: exit code != 0
and no result line. Needs a CUDA card; never falls back to the CPU.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
ATOL, RTOL = 2e-5, 1e-4
REQUESTS, VIEWS, HW = 4, 4, 256


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    info = {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    log("device", **info)
    return info


def phase_build() -> None:
    from guassianhand_tpu_torch.ops import rasterize_cuda
    t0 = time.perf_counter()
    text = rasterize_cuda.build_library()
    ptxas = [ln.strip() for ln in text.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", kernel="composite_forward", ptxas=ptxas,
        seconds=time.perf_counter() - t0)


def scene_inputs(n: int, height: int, width: int, *, views: int = 1,
                 seed: int = 0, spread: float = 0.5,
                 scale=(0.002, 0.01), opacity=(0.3, 0.9),
                 focal: float = 1.1, dist: float = 1.8):
    """Composite inputs of ``n`` random Gaussians in a cube of half-size
    ``spread``, seen by ``views`` cameras at distance ``dist`` turned 0.4
    rad apart about the y axis (focal length ``focal`` * width). One view
    keeps its own height x width canvas, as ``rasterize`` does; more views
    are stacked on one canvas of tile-aligned bands, as
    ``rasterize_multiview`` does. The defaults are bench.py::main's scene."""
    from guassianhand_tpu_torch.core.camera import Camera
    from guassianhand_tpu_torch.core.gaussians import Gaussians
    from guassianhand_tpu_torch.ops.projection import project_gaussians
    from guassianhand_tpu_torch.ops.rasterize import (composite_inputs,
                                                      multiview_composite_inputs)
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-spread, spread, (n, 3))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    arrays = {"xyz": xyz, "rotation": q,
              "opacity": rng.uniform(*opacity, (n, 1)),
              "scaling": rng.uniform(*scale, (n, 3)),
              "shs": rng.uniform(0, 1, (n, 1, 3))}
    gs = Gaussians(**{k: torch.as_tensor(v.astype(np.float32), device="cuda")
                      for k, v in arrays.items()})
    f = focal * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (views, 1, 1))
    for i in range(views):
        a = 0.4 * i
        w2cs[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]]
        w2cs[i, 2, 3] = dist
    if views == 1:
        cam = Camera.from_w2c(w2cs[0], K, height, width, device="cuda")
        p = project_gaussians(gs.xyz, gs.scaling, gs.rotation, cam)
        return composite_inputs(p.mean2d, p.conic, gs.shs[:, 0],
                                gs.opacity[:, 0], p.depth, p.radius,
                                p.visible, height=height, width=width)
    return multiview_composite_inputs(
        gs, torch.as_tensor(w2cs, device="cuda"),
        torch.as_tensor(np.stack([K] * views), device="cuda"), height=height,
        width=width, use_rgb=True)


# The kernel's edge cases at small shapes, each held against the twin:
# (label, scene_inputs arguments, what the case must contain)
EDGE_SCENES = (
    ("odd_100x60", dict(n=300, height=60, width=100, scale=(0.005, 0.05),
                        opacity=(0.2, 0.99), focal=0.87, dist=2.5), None),
    ("stacked_3x40x48", dict(n=400, height=40, width=48, views=3,
                             scale=(0.005, 0.05), opacity=(0.2, 0.99),
                             focal=0.87, dist=2.5), None),
    ("dense_64", dict(n=4000, height=64, width=64, scale=(0.005, 0.05),
                      opacity=(0.2, 0.99), focal=0.87, dist=2.5),
     "a tile of more than 256 pairs"),
    ("transparent_48", dict(n=50, height=48, width=48, scale=(0.005, 0.05),
                            opacity=(0.0, 0.0), focal=0.87, dist=2.5),
     "pairs, all under the alpha gate"),
    ("behind_camera_48", dict(n=50, height=48, width=48, dist=-2.0), "no pair"),
)


def phase_edges() -> None:
    """K1 against its twin at shapes the main path does not reach."""
    for label, kwargs, needs in EDGE_SCENES:
        inputs = scene_inputs(**kwargs)
        n_pairs = inputs.pair_gid.shape[0]
        counts = inputs.tile_range[1:] - inputs.tile_range[:-1]
        holds = {None: True,
                 "a tile of more than 256 pairs": int(counts.max()) > 256,
                 "pairs, all under the alpha gate": n_pairs > 0,
                 "no pair": n_pairs == 0}[needs]
        if not holds:
            raise AssertionError(f"edge scene {label} lacks {needs}")
        check_composite(label, inputs, reps=2)


def check_composite(label: str, inputs, reps: int = 20) -> dict:
    """Kernel vs plain twin on the card at ``inputs``; raises on
    disagreement. Returns the measured numbers and the bound."""
    from guassianhand_tpu_torch.ops import rasterize_cuda as rc
    args = (inputs.tile_range, inputs.pair_gid, inputs.attrs)
    kw = {"height": inputs.height, "width": inputs.width}
    launches_before = rc.composite_forward.launches
    rgb_k, t_k = rc.composite_forward(*args, **kw)
    rgb_p, t_p, ops = rc.composite_plain(*args, **kw, count_ops=True)
    torch.cuda.synchronize()
    err = {}
    bad = 0
    for name, got, want in (("rgb", rgb_k, rgb_p), ("final_t", t_k, t_p)):
        diff = (got - want).abs()
        err[name] = float(diff.max())
        over = diff > ATOL + RTOL * want.abs()
        if name == "rgb":
            over = over.any(dim=-1)
        bad = max(bad, int(over.sum()))
    # a gate decided differently at a threshold shows as a final-T mismatch
    flipped = int(((t_k - t_p).abs() > ATOL + RTOL * t_p.abs()).sum())
    ms = time_cuda(lambda: rc.composite_forward(*args, **kw), reps=reps)
    plain_ms = time_cuda(lambda: rc.composite_plain(*args, **kw), reps=2,
                         warmup=1)
    n_ops = int(ops.sum())
    tile_pairs = inputs.tile_range[1:] - inputs.tile_range[:-1]
    n_gauss = inputs.attrs.shape[0]
    n_pairs = inputs.pair_gid.shape[0]
    bytes_moved = (4 * (inputs.tile_range.numel() + n_pairs)
                   + 4 * inputs.attrs.numel()
                   + 16 * inputs.height * inputs.width)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    row = {"scene": label, "canvas": [inputs.height, inputs.width],
           "gaussians": n_gauss, "n_pairs": n_pairs,
           "tiles": tile_pairs.numel(),
           "tiles_nonempty": int((tile_pairs > 0).sum()),
           "max_tile_pairs": int(tile_pairs.max()),
           "max_abs_err_rgb": err["rgb"], "max_abs_err_final_t": err["final_t"],
           "pixels_over_tol": bad, "final_t_gate_flips": flipped,
           "ms": ms, "plain_ms": plain_ms, "fp32_ops": n_ops,
           "bytes": bytes_moved, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "check_launches": rc.composite_forward.launches - launches_before}
    log("kernel_vs_plain", **row)
    if bad:
        raise AssertionError(f"composite_forward disagrees with its plain "
                             f"twin at {label}: {bad} pixels over atol {ATOL} "
                             f"+ rtol {RTOL}, {flipped} final-T gate flips")
    return row


def phase_slice():
    """R requests of V views of the full-width avatar; returns the last
    request's composite inputs (the avatar's projected Gaussians) and the
    measured numbers."""
    from guassianhand_tpu_torch.cli.render_360 import (MODEL_CONFIG,
                                                       orbit_batch,
                                                       render_request)
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.ops import rasterize_cuda as rc
    from guassianhand_tpu_torch.ops.rasterize import multiview_composite_inputs

    cfg = MODEL_CONFIG
    t0 = time.perf_counter()
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    model = build_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("slice_setup", seconds=time.perf_counter() - t0,
        n_points=scene.n_points, gaussian_slots=2 * scene.n_points,
        params=n_params)

    def request(seed):
        t_a = time.perf_counter()
        batch = orbit_batch(scene, synthetic_batch(scene, seed=seed), 0,
                            VIEWS, VIEWS)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        out = render_request(model, batch, HW, HW)
        torch.cuda.synchronize()
        return batch, out, (t_b - t_a) * 1e3, (time.perf_counter() - t_b) * 1e3

    request(1000)                                  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rc.composite_forward.launches = 0
    results = [request(r) for r in range(REQUESTS)]
    launches = rc.composite_forward.launches
    peak = torch.cuda.max_memory_allocated()
    rows = []
    for r, (batch, out, batch_ms, model_ms) in enumerate(results):
        rgb, mask = out["comp_rgb"], out["comp_mask"]
        row = {"request": r, "batch_ms": batch_ms, "model_ms": model_ms,
               "n_pairs": int(out["n_pairs"][0]),
               "interacting": int(batch["inter_mask"].sum()),
               "comp_mask_mean": float(mask.mean()),
               "comp_rgb_mean": float(rgb.mean()),
               "finite": bool(torch.isfinite(rgb).all()
                              and torch.isfinite(mask).all()),
               "shape": list(rgb.shape)}
        log("request", **row)
        rows.append(row)
        if not row["finite"] or row["shape"] != [1, VIEWS, HW, HW, 3]:
            raise AssertionError(f"request {r}: bad output {row}")
        if not 0.0 < row["comp_mask_mean"] < 1.0:
            raise AssertionError(f"request {r}: empty or full render {row}")
    log("slice", requests=REQUESTS, views=VIEWS,
        model_ms=[x["model_ms"] for x in rows],
        model_ms_mean=float(np.mean([x["model_ms"] for x in rows])),
        composite_forward_launches=launches, peak_bytes=peak)
    if launches == 0:
        raise AssertionError("the slice ran without launching "
                             "composite_forward")
    batch, out = results[-1][0], results[-1][1]
    phase_profile(lambda: request(REQUESTS),
                  lambda: model.features(batch), rows)
    gs = out["3dgs"][0]
    rcfg = cfg.renderer
    inputs = multiview_composite_inputs(
        gs, batch["w2c_render"][0], batch["K_render"][0], height=HW,
        width=HW, sh_degree=rcfg.sh_degree, use_rgb=rcfg.use_rgb,
        config=rcfg.raster)
    return inputs, launches


def _device_us(event) -> float:
    return float(event.self_device_time_total)


def phase_profile(run_request, run_features, rows) -> None:
    """Where a request's time goes: one request under torch.profiler (the
    kernels' device time by name, and the device's busy share of the
    unprofiled request time), and the feature pipeline timed alone."""
    from torch.profiler import ProfilerActivity, profile
    from guassianhand_tpu_torch.models.one_shot import no_tf32
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_request()
    # kernel rows only: an operator's row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:12]
    request_ms = float(np.mean([r["batch_ms"] + r["model_ms"] for r in rows]))
    with torch.inference_mode(), no_tf32():
        features_ms = time_cuda(run_features, reps=3, warmup=1)
    log("profile", device_busy_ms=busy_ms, request_ms_unprofiled=request_ms,
        device_busy_share=busy_ms / request_ms,
        features_ms=features_ms,
        model_ms_mean=float(np.mean([r["model_ms"] for r in rows])),
        batch_ms_mean=float(np.mean([r["batch_ms"] for r in rows])),
        top_device_ms=[[e.key[:60], _device_us(e) / 1e3, e.count]
                       for e in top])


def phase_reference() -> None:
    """A small model on the card and on the CPU with the same weights: the
    card's kernel path must agree with the CPU's plain path."""
    from guassianhand_tpu_torch.cli.render_360 import (orbit_batch,
                                                       render_request)
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import (OneShotConfig,
                                                        build_model)
    cfg = OneShotConfig(camera_embed_dim=64, pose_embed_dim=64, plane_size=8,
                        token_channels=64, backbone_layers=1,
                        backbone_heads=2, backbone_head_dim=16,
                        residual_map_hw=(64, 128))
    hw = 64
    # one batch, made on the CPU: kNN ties decide the interaction mask, so
    # both devices get the very same inputs
    scene = SyntheticHandScene.build(n_vertices=96, subdivide=1, height=hw,
                                     width=hw, device="cpu")
    batch = orbit_batch(scene, synthetic_batch(scene, seed=0), 0, 2, 2)
    outs = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, seed=0, device="cuda").to(device)
        outs[device] = render_request(
            model, {k: v.to(device) for k, v in batch.items()}, hw, hw)
    diff = {k: float((outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max())
            for k in ("comp_rgb", "comp_mask", "hidden")}
    log("reference", cuda_vs_cpu_max_abs=diff)
    if max(diff.values()) > 1e-4:
        raise AssertionError(f"card and CPU renders disagree: {diff}")


def main() -> int:
    info = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    bench_row = check_composite("bench_512_49152", scene_inputs(49152, 512, 512))
    phase_edges()
    avatar_inputs, launches = phase_slice()
    avatar_row = check_composite("avatar_4x256", avatar_inputs)
    phase_reference()
    kernels = [{
        "name": "composite_forward", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "guassianhand_tpu/ops/rasterize_pallas.py:395",
        "launches": launches,
        "max_abs_err": max(avatar_row["max_abs_err_rgb"],
                           avatar_row["max_abs_err_final_t"],
                           bench_row["max_abs_err_rgb"],
                           bench_row["max_abs_err_final_t"]),
        "ms": avatar_row["ms"], "plain_ms": avatar_row["plain_ms"],
        "bound_ms": avatar_row["bound_ms"],
        "bound_by": avatar_row["bound_by"], "library_ms": None}]
    if any(not math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("kernel timing failed")
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": info["kind"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
