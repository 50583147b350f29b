#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

  python3 chip_smoke.py

Phases, each reported on its own line:
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the six CUDA sources (composite_fwd.cu, composite_bwd.cu,
     segment_reduce.cu, projection.cu, flash_attention.cu,
     flash_attention_bf16.cu) compiled from csrc/ with nvcc for sm_90a, one
     nvcc each, all at once, with ptxas' registers, shared memory and
     spills;
  3. kernel vs plain: the forward kernel held against its plain PyTorch
     twin at the bench scene (49,152 random Gaussians, 512^2), at edge
     cases the main path does not reach (odd image sizes, stacked views,
     tiles of more than 256 pairs, transparent and empty tiles, a tile of
     several chunks where one pixel stops on a chunk boundary and most
     never stop, tiles just under and just over the whole-tile threshold,
     a stacked canvas with a cut tile in every view) and at the avatar's
     own Gaussians, atol 2e-5 + rtol 1e-4 * |ref|;
  4. grad vs plain: the forward's training mode, its chunk plan, the
     backward and the segment sum against their twins at the bench scene,
     the edge cases, the avatar's and the fit's own Gaussians, with
     bench.py's loss: per-Gaussian gradients of mean2d, conic, opacity and
     colour within atol 2e-4 * scale + rtol 2e-3, n_contrib and the plan
     exact, the checkpoints within the forward tolerance, training mode's
     rgb and final T bit-identical to render mode's, the backward's output
     the same in two runs;
  5. projection vs plain: the fused projection's forward and adjoint
     kernels against their twins at the bench scene, the edge scene
     (near-plane rows, both sides of the 1.3 tan clamp, det <= 0, quaternions
     far from unit norm, radii at integers) and the kernel fit's own
     Gaussians: every output and gradient equal to the twin's to the bit
     (and reported against atol 2e-5 + rtol 1e-4 * |ref| on visible rows,
     gradients against atol 2e-4 * scale + rtol 2e-3, exactly 0 on rows
     that are not visible); under a stack of V = 1, 2 and 4 cameras, one of
     which sees nothing, at the edge scene and at one Gaussian, and at a
     request's own 4 views: one launch each way, every output equal to the
     twin's to the bit; then the sorted-segment sum at its edge cases
     (empty leading, interior and trailing segments, ids >= n, a run of
     1,500 pairs, runs across CTAs, no items, no segments), read through
     the stable order and on the pairs gathered into it: within the
     gradient tolerance of its twin, the two ways and two calls equal to
     the bit;
  6. attention vs plain: the flash attention's forward, dkv and dq kernels
     against their twins at edge cases (L = 1, L = N, no mask, N no block
     divides; 15, 16, 17, 63, 64, 65 and 129 live rows of 150, on the edges
     of a warp's 16 rows and a CTA's 64; q and k scaled so that |score|
     reaches about 30) and at the kernel fit's own q, k, v and mask: out
     within atol 2e-5 + rtol 1e-4 * |ref|, masked rows exactly 0, dq, dk,
     dv within 1e-4 * scale, a second call of each kernel equal to the first
     to the bit; beside them the default chunked route and torch's
     scaled_dot_product_attention, and each kernel's bound on the tensor
     cores in split TF32 beside its bound as fp32 FMAs; then the bf16
     kernels against their bf16 twins at the same edge cases and at 127,
     128, 129, 255, 256 and 257 live rows of 300 (the edges of their
     128-row CTAs and 128-key tiles): out, dq, dk and dv within 4 bf16 ulps
     of max(|ref|, 1/16 of the array's largest) and, in norm, no further
     from the float32 function than 1.25 times the twins, lse within the
     forward tolerance, two calls equal to the bit;
  7. raster fwd+bwd: bench.py::main's step (project, bin, composite forward
     and backward at the bench scene), ms per step and rays/s, and the
     composite wrappers' host time a call;
  8. the serving slice: the full-width one-shot avatar model (seeded
     weights) serves R = 4 requests, each one pose in V = 4 orbit views at
     256^2; then again with both kernel switches on
     (projection_impl="pallas", GH_FLASH_ATTN=1), where each request
     launches the projection once for its 4 views; on each route one
     request more under torch.profiler (device busy share, top kernels);
  9. the fit slice: the full-width model fits its per-identity parameters
     to the synthetic target (15,404 points, 256^2, Adam, vgg 0.1, fp32),
     one warm-up step and then 10 steps, once on the default route and once
     with both switches on, which launches all nine kernel functions; the
     warm-up losses of the two (the same parameters) agree within 1e-5;
     then the flagship configuration (configs/one_shot.yaml: the bf16
     feature pipeline, the backbone softmax in bf16, its attention cores
     rematerialised) with both switches on: 10 fit steps and 4 requests of
     4 views, which launch the bf16 flash attention and not the float32
     one, logged beside the float32 model's; the bf16 kernels against
     their twins at its fit's own q, k, v (L = 14,914), timed beside SDPA
     in bf16 (all rows with the key mask, and the gathered live rows with
     no mask on its flash backend) and their bounds (bf16 tensor cores,
     exp on the SFUs at the card's maximum SM clock, bytes); and
     scripts/bf16_psnr_gate.py's gate:
     50 fit steps from one init in fp32, in bf16 and in the flagship's
     bf16, each bf16 fit's rendered PSNR within 0.1 dB of the fp32 fit's;
 10. reference: a small model rendered, and fitted for 2 steps, on the card
     and on the CPU with the same weights must agree, with the switches off
     and on.
Kernel launch counts are zeroed just before each slice and read just after;
kernels and twins are timed with CUDA events, beside the launch floor (an
empty launch, torch.cuda._sleep(0), timed the same way). With --parent DIR
the port package of the checkout DIR is imported beside this tree's,
builds its own kernels, and its composite kernels and raster step are timed
beside this tree's on the same inputs, in turns, and so are its three flash
attention kernels at the fit's q, k, v, its projection at the fit and at a
request's 4 views (its one launch a view against this tree's one launch),
its sorted-segment sum at the bench and the fit, alone and with the
gathers into Gaussian order that its backward ran before it, and its three
bf16 flash attention kernels at the flagship fit's q, k, v.

Prints the kernel table as one JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}. Any failure raises: exit code != 0
and no result line. Needs a CUDA card; never falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import json
import math
import os
import subprocess
import sys
import time

from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, TF32
# on the tensor cores (dense), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# bf16 on the tensor cores (dense), and the special-function units' exp:
# 16 a clock on each of the 132 SMs (at the card's maximum SM clock, read
# from nvidia-smi in phase_device)
PEAK_BF16_FLOPS = 989e12
SFU_PER_CLOCK, SMS = 16, 132
ATOL, RTOL = 2e-5, 1e-4
# gradient tolerance: atol GRAD_ATOL * (max |twin gradient| of the array)
# + GRAD_RTOL * |twin gradient|, as tests/test_rasterize.py holds gradients
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3
# attention: out within ATOL + RTOL * |ref|, the forward tolerance above
# (tests/test_attention.py's atol 2e-5 was set for unit-normal inputs, whose
# outputs stay below 1; at the fit they reach several units and a sum over
# 15k keys rounds apart by more); dq/dk/dv within ATTN_GRAD_ATOL * scale, as
# tests/test_attention.py holds JAX's flash path
ATTN_GRAD_ATOL = 1e-4
# the bf16 attention kernels against their twins, which round at the same
# points, on the same inputs: out, dq, dk and dv within BF16_ULPS bf16 ulps
# of the twin's value, or of BF16_FLOOR times the array's largest |value|
# where that is larger (tests/test_torch_bf16.py holds the twins to JAX's
# kernel by the same measure). The kernel's float32 sums and exp differ from
# the twin's in the last bits, which flips the bf16 rounding of a few P (dS)
# terms, and a flip moves a sum by 2^-8 of that term: near 0 that is many
# ulps of the value (a change in the last bits of the scores moves the
# twin's own output by several ulps of 1/256 of its largest value), and with
# few keys one P near 1 flipped moves dv by several ulps of 1/16 of its
# largest. So each is also held in norm: its relative error against the
# float32 function of the same bf16 inputs at most BF16_NORM_RATIO times
# the twin's
BF16_ULPS = 4
BF16_FLOOR = 2.0 ** -4
BF16_NORM_RATIO = 1.25
PARAM_ATOL = 1e-4   # card vs CPU, trainable parameters after a fit step
# card vs CPU after 2 fit steps: |p_card - p_cpu| / |p_cpu - p_0| per array
PARAM_UPDATE_RTOL = 1e-2
REF_HW = 64         # the small model's canvas, card vs CPU
# card vs CPU, the first fit step's gradients: atol FIT_GRAD_ATOL * (max |g|
# of the array) + rtol FIT_GRAD_RTOL * |g|
FIT_GRAD_ATOL, FIT_GRAD_RTOL = 1e-4, 1e-3
REQUESTS, VIEWS, HW = 4, 4, 256
RASTER_STEPS = 20
RASTER_TURNS = 5   # rounds of parent, this, this, parent with --parent
FIT_STEPS = 10
PSNR_STEPS = 50     # scripts/bf16_psnr_gate.py's fit length
PSNR_GATE_DB = 0.1  # its bar: each bf16 fit's PSNR within this of fp32's
SPIN_CYCLES = 50_000_000   # 25-30 ms of device time at H100 clocks
K3_CTA_ITEMS = 128         # sorted items a CTA of csrc/segment_reduce.cu
REPO = Path(__file__).resolve().parent
# per-Gaussian gradient arrays in the packed attribute row
GRAD_ARRAYS = (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
               ("opacity", slice(5, 6)), ("color", slice(6, 9)))


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up. The
    device first spins for a while, so the host enqueues the calls ahead of
    it and a short kernel's time is not its launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              floor: float = BF16_FLOOR) -> torch.Tensor:
    """|got - want| elementwise in bf16 ulps of max(|want|, floor * the
    largest |want|)."""
    got, want = got.float(), want.float()
    top = float(want.abs().max()) if want.numel() else 0.0
    ref = want.abs().clamp_min(floor * top)
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    return (got - want).abs() / ulp


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    info = {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sm_clock_max_mhz": sm_clock_mhz}
    log("device", **info)
    return info


def phase_build() -> None:
    """Every kernel of the port, one nvcc per source, all started together."""
    from guassianhand_tpu_torch.ops import (flash_attention_cuda,
                                            projection_cuda, rasterize_cuda,
                                            segreduce_cuda)
    from guassianhand_tpu_torch.ops.cuda_build import build_all
    libs = [rasterize_cuda.FORWARD_LIB, rasterize_cuda.BACKWARD_LIB,
            segreduce_cuda.LIB, projection_cuda.LIB, flash_attention_cuda.LIB,
            flash_attention_cuda.LIB_BF16]
    t0 = time.perf_counter()
    texts = build_all(libs)
    seconds = time.perf_counter() - t0
    for lib in libs:
        ptxas = [ln.strip() for ln in texts[lib.name].splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln]
        log("build", source=str(lib.source.relative_to(REPO)), ptxas=ptxas,
            seconds_all=seconds)


def scene_inputs(n: int, height: int, width: int, *, views: int = 1,
                 seed: int = 0, spread: float = 0.5,
                 scale=(0.002, 0.01), opacity=(0.3, 0.9),
                 focal: float = 1.1, dist: float = 1.8, device: str = "cuda"):
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
    gs = Gaussians(**{k: torch.as_tensor(v.astype(np.float32), device=device)
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
        cam = Camera.from_w2c(w2cs[0], K, height, width, device=device)
        p = project_gaussians(gs.xyz, gs.scaling, gs.rotation, cam)
        return composite_inputs(p.mean2d, p.conic, gs.shs[:, 0],
                                gs.opacity[:, 0], p.depth, p.radius,
                                p.visible, height=height, width=width)
    return multiview_composite_inputs(
        gs, torch.as_tensor(w2cs, device=device),
        torch.as_tensor(np.stack([K] * views), device=device), height=height,
        width=width, use_rgb=True)


def reference_config():
    """The small model of the card-against-CPU phases."""
    from guassianhand_tpu_torch.models.one_shot import OneShotConfig
    return OneShotConfig(camera_embed_dim=64, pose_embed_dim=64, plane_size=8,
                         token_channels=64, backbone_layers=1,
                         backbone_heads=2, backbone_head_dim=16,
                         residual_map_hw=(64, 128))


def pair_rows_inputs(rows, counts, height: int, width: int,
                     device: str = "cuda"):
    """Composite inputs of hand-made pairs: ``rows`` (P, 9) packed attribute
    rows, one Gaussian a pair, in binned order; ``counts`` the pairs of each
    tile."""
    from guassianhand_tpu_torch.ops.rasterize import CompositeInputs
    tile_range = torch.zeros(len(counts) + 1, dtype=torch.int32)
    tile_range[1:] = torch.cumsum(torch.as_tensor(counts), 0)
    n = len(rows)
    return CompositeInputs(
        tile_range.to(device), torch.arange(n, dtype=torch.int32,
                                            device=device),
        torch.as_tensor(np.asarray(rows, np.float32), device=device),
        height, width)


def splat_rows(rng, n: int, x0: float, opacity):
    """``n`` packed rows of splats centred in the 16-pixel-wide column
    [x0, x0 + 16) of a 16-row tile, random conics and colours."""
    return np.stack([rng.uniform(x0, x0 + 16, n), rng.uniform(0, 16, n),
                     rng.uniform(0.02, 0.3, n), rng.uniform(-0.01, 0.01, n),
                     rng.uniform(0.02, 0.3, n), rng.uniform(*opacity, n),
                     *rng.uniform(0, 1, (3, n))], 1)


def chunk_boundary_scene(device: str = "cuda"):
    """One 16 x 16 tile of 3 FWD_CHUNK + 37 pairs: faint wide splats that
    stop no pixel, and six opaque narrow ones on pixel (5, 9) at pairs 40,
    100, 160, 220, FWD_CHUNK - 1 and FWD_CHUNK, so that pixel composites up
    to the last pair of the forward's first chunk and stops at the first
    pair of its second, which is also a checkpoint of the backward."""
    from guassianhand_tpu_torch.ops.rasterize_cuda import FWD_CHUNK
    n = 3 * FWD_CHUNK + 37
    rows = splat_rows(np.random.RandomState(7), n, 0.0, (0.004, 0.006))
    rows[[40, 100, 160, 220, FWD_CHUNK - 1, FWD_CHUNK], :6] = \
        [5.0, 9.0, 5.0, 0.0, 5.0, 0.8]
    return pair_rows_inputs(rows, [n], 16, 16, device)


def light_threshold_scene(device: str = "cuda"):
    """Two tiles side by side: FWD_LIGHT pairs in the first (the forward
    walks it whole) and FWD_LIGHT + 1 in the second (cut into chunks)."""
    from guassianhand_tpu_torch.ops.rasterize_cuda import FWD_LIGHT
    rng = np.random.RandomState(8)
    rows = np.concatenate([splat_rows(rng, FWD_LIGHT, 0.0, (0.05, 0.3)),
                           splat_rows(rng, FWD_LIGHT + 1, 16.0, (0.05, 0.3))])
    return pair_rows_inputs(rows, [FWD_LIGHT, FWD_LIGHT + 1], 16, 32, device)


# The kernels' edge cases at small shapes, each held against the twins:
# (label, a function making the composite inputs, what the case must contain)
EDGE_SCENES = (
    ("odd_100x60", lambda: scene_inputs(
        n=300, height=60, width=100, scale=(0.005, 0.05),
        opacity=(0.2, 0.99), focal=0.87, dist=2.5), None),
    ("stacked_3x40x48", lambda: scene_inputs(
        n=400, height=40, width=48, views=3, scale=(0.005, 0.05),
        opacity=(0.2, 0.99), focal=0.87, dist=2.5), None),
    ("dense_64", lambda: scene_inputs(
        n=4000, height=64, width=64, scale=(0.005, 0.05),
        opacity=(0.2, 0.99), focal=0.87, dist=2.5),
     "a tile of more than 256 pairs"),
    ("transparent_48", lambda: scene_inputs(
        n=50, height=48, width=48, scale=(0.005, 0.05), opacity=(0.0, 0.0),
        focal=0.87, dist=2.5), "pairs, all under the alpha gate"),
    ("behind_camera_48", lambda: scene_inputs(
        n=50, height=48, width=48, dist=-2.0), "no pair"),
    ("chunk_boundary_16", chunk_boundary_scene,
     "a pixel stopping at a chunk boundary, pixels that never stop"),
    ("light_threshold_16x32", light_threshold_scene,
     "a whole tile and a cut tile at the threshold"),
    ("stacked_heavy_3x16x48", lambda: scene_inputs(
        n=1200, height=16, width=48, views=3, spread=0.05,
        scale=(0.002, 0.01), opacity=(0.05, 0.3), focal=0.87, dist=2.5),
     "a cut tile in every view"),
)


def edge_scene_holds(needs, inputs) -> bool:
    """Whether ``inputs`` contain what the edge scene is there for."""
    from guassianhand_tpu_torch.ops import rasterize_cuda as rc
    counts = inputs.tile_range[1:] - inputs.tile_range[:-1]
    n_pairs = inputs.pair_gid.shape[0]
    if needs is None:
        return True
    if needs == "a tile of more than 256 pairs":
        return int(counts.max()) > 256
    if needs == "pairs, all under the alpha gate":
        return n_pairs > 0
    if needs == "no pair":
        return n_pairs == 0
    if needs == "a whole tile and a cut tile at the threshold":
        return counts.tolist() == [rc.FWD_LIGHT, rc.FWD_LIGHT + 1]
    if needs == "a cut tile in every view":
        views = counts.reshape(3, -1)
        return bool((views.amax(dim=1) > rc.FWD_LIGHT).all())
    # the chunk boundary scene: pixel (5, 9) stops at pair FWD_CHUNK,
    # having composited pair FWD_CHUNK - 1; most pixels never stop
    _, final_t, n_contrib, *_ = rc.composite_plain(
        inputs.tile_range, inputs.pair_gid, inputs.attrs,
        height=inputs.height, width=inputs.width, store_contrib=True)
    return (int(n_contrib[9, 5]) == rc.FWD_CHUNK
            and float(final_t[9, 5]) < 1e-3
            and int((final_t > 0.5).sum()) > 128)


def projection_edge_scene(height: int = 128, width: int = 160,
                          dist: float = 2.5):
    """Gaussians at the projection's edge cases, as numpy float32 (xyz,
    scaling, rotation) with the camera (w2c, K, height, width): a 60-degree
    camera at ``dist`` looking down +z. Rows: around and behind the near
    plane z_cam = 0.2; past the 1.3 tan(fov / 2) clamp on both sides of both
    axes; one huge scale axis, where a c - b^2 cancels to det <= 0 in fp32;
    quaternions far from unit norm; and on the optical axis with the
    identity rotation, scales that put 3 sqrt(lambda_max) at the integers
    2..40, each nudged by -4..4 ulp."""
    f = 0.5 * width / np.tan(np.radians(30.0))
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = dist
    rng = np.random.RandomState(5)

    def unit_q(n):
        q = rng.normal(size=(n, 4))
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    rows = []
    z_cam = np.array([-1.0, 0.0, 0.1, 0.19999, 0.2, 0.20001, 0.25, 0.5])
    n = len(z_cam)
    rows.append((np.stack([rng.uniform(-0.05, 0.05, n),
                           rng.uniform(-0.05, 0.05, n), z_cam - dist], 1),
                 rng.uniform(0.005, 0.05, (n, 3)), unit_q(n)))
    lim = 1.3 * np.tan(np.radians(30.0))
    ratios = np.array([-3.0, -1.5, -1.01, 1.01, 1.5, 3.0]) * lim
    for axis in (0, 1):
        xyz = np.zeros((len(ratios), 3))
        xyz[:, axis] = 2.0 * ratios
        xyz[:, 2] = 2.0 - dist
        rows.append((xyz, rng.uniform(0.02, 0.2, (len(ratios), 3)),
                     unit_q(len(ratios))))
    n = 64
    huge = np.zeros((n, 3))
    huge[:, 0] = 10.0 ** rng.uniform(3.0, 5.0, n)
    rows.append((np.stack([rng.uniform(-0.3, 0.3, n),
                           rng.uniform(-0.3, 0.3, n), np.zeros(n)], 1),
                 huge, unit_q(n)))
    n = 16
    rows.append((rng.uniform(-0.3, 0.3, (n, 3)),
                 rng.uniform(0.005, 0.05, (n, 3)),
                 unit_q(n) * np.repeat([1e-3, 1e-1, 10.0, 1e3], 4)[:, None]))
    # a = (sx f / z)^2 + 0.3 is lambda_max while c stays near 0.3
    k, j = (a.ravel() for a in np.meshgrid(np.arange(2, 41), np.arange(-4, 5),
                                           indexing="ij"))
    n = len(k)
    sx = dist / f * np.sqrt((k / 3.0) ** 2 - 0.3) * (1.0 + j * 2.0 ** -23)
    q = np.zeros((n, 4))
    q[:, 0] = 1.0
    rows.append((np.zeros((n, 3)),
                 np.stack([sx, np.full(n, 1e-4), np.full(n, 1e-4)], 1), q))
    xyz, scaling, rotation = (
        np.concatenate([r[i] for r in rows]).astype(np.float32)
        for i in range(3))
    return xyz, scaling, rotation, w2c, K, height, width


def phase_edges(parent=None) -> None:
    """K1 against its twin at shapes the main path does not reach."""
    for label, build, needs in EDGE_SCENES:
        inputs = build()
        if not edge_scene_holds(needs, inputs):
            raise AssertionError(f"edge scene {label} lacks {needs}")
        check_composite(label, inputs, reps=2, parent=parent)


class Parent:
    """The port package of another checkout (``--parent DIR``), imported
    beside this tree's under module objects of its own (its launch counters
    are its own too), built from its own sources into its own ``_build/``,
    and driven through its entry points only: the composite wrappers,
    ``rasterize``, the flash attention's three wrappers (``fa``), the
    sorted-segment sum (``sr``) and the projection's two (``pc``). Its
    ``composite_backward`` takes what its training-mode forward returned,
    bound to its parameters by name."""

    PKG = "guassianhand_tpu_torch"

    def __init__(self, root: Path):
        def loaded():
            return [k for k in sys.modules
                    if k == self.PKG or k.startswith(self.PKG + ".")]
        ours = {k: sys.modules.pop(k) for k in loaded()}
        sys.path.insert(0, str(root))
        try:
            mods = {sub: importlib.import_module(f"{self.PKG}.{sub}")
                    for sub in ("ops.rasterize_cuda", "ops.rasterize",
                                "ops.cuda_build", "ops.flash_attention_cuda",
                                "ops.segreduce_cuda", "ops.projection_cuda",
                                "core.camera", "core.gaussians")}
        finally:
            sys.path.remove(str(root))
            for k in loaded():
                del sys.modules[k]
            sys.modules.update(ours)
        self.rc = mods["ops.rasterize_cuda"]
        self.fa = mods["ops.flash_attention_cuda"]
        self.sr = mods["ops.segreduce_cuda"]
        self.pc = mods["ops.projection_cuda"]
        self.rasterize = mods["ops.rasterize"].rasterize
        self.Camera = mods["core.camera"].Camera
        self.Gaussians = mods["core.gaussians"].Gaussians
        if not Path(self.rc.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"--parent {root} has no {self.PKG}")
        t0 = time.perf_counter()
        # its bf16 attention has a library of its own where it is not
        # flash_attention.cu
        mods["ops.cuda_build"].build_all([
            self.rc.FORWARD_LIB, self.rc.BACKWARD_LIB, self.fa.LIB,
            *([self.fa.LIB_BF16] if hasattr(self.fa, "LIB_BF16") else []),
            self.sr.LIB, self.pc.LIB])
        log("build", source=str(root / self.PKG / "csrc"), parent=True,
            seconds_all=time.perf_counter() - t0)

    def forward(self, inputs, store_contrib: bool = False):
        return lambda: self.rc.composite_forward(
            inputs.tile_range, inputs.pair_gid, inputs.attrs,
            height=inputs.height, width=inputs.width,
            store_contrib=store_contrib)

    def backward(self, inputs, grad_rgb, grad_t):
        kw = {"height": inputs.height, "width": inputs.width}
        outs = self.rc.composite_forward(
            inputs.tile_range, inputs.pair_gid, inputs.attrs, **kw,
            store_contrib=True)
        named = dict(zip(("rgb", "final_t", "n_contrib", "checkpoints",
                          "slot_base"), outs))
        named.update(tile_range=inputs.tile_range, pair_gid=inputs.pair_gid,
                     attrs=inputs.attrs, grad_rgb=grad_rgb, grad_t=grad_t)
        params = inspect.signature(self.rc.composite_backward).parameters
        args = [named[k] for k, v in params.items()
                if v.kind is v.POSITIONAL_OR_KEYWORD]
        return lambda: self.rc.composite_backward(*args, **kw)


def launch_floor_ms(reps: int = 50) -> float:
    """The time of one launch that does no work (``torch.cuda._sleep(0)``),
    timed as the kernels are: a bound below it reads as the cost of a
    launch, not of the work."""
    return time_cuda(lambda: torch.cuda._sleep(0), reps)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal element by element, NaN where NaN, shape and type alike."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def time_host(fn, reps: int) -> float:
    """Mean ms the host takes to queue one call of ``fn``, the device held
    busy by a spin meanwhile, so that no call waits for it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def time_against_parent(fn, parent_fn, reps: int, turns=None):
    """(ms of ``fn``, ms of ``parent_fn`` or None): timed parent, this
    tree, this tree, parent, each pair averaged; the four times, in that
    order, are appended to ``turns`` when it is given."""
    if parent_fn is None:
        return time_cuda(fn, reps=reps), None
    p0 = time_cuda(parent_fn, reps=reps)
    n0 = time_cuda(fn, reps=reps)
    n1 = time_cuda(fn, reps=reps)
    p1 = time_cuda(parent_fn, reps=reps)
    if turns is not None:
        turns += [p0, n0, n1, p1]
    return (n0 + n1) / 2, (p0 + p1) / 2


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: bytes over its memory rate or
    fp32 operations over its peak, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": n_bytes, "fp32_ops": n_ops}


def check_composite(label: str, inputs, reps: int = 20,
                    parent=None) -> dict:
    """Kernel vs plain twin on the card at ``inputs``; raises on
    disagreement. Returns the measured numbers and the bound, and with a
    Parent ``parent`` its time on the same inputs."""
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
    ms, parent_ms = time_against_parent(
        lambda: rc.composite_forward(*args, **kw),
        parent and parent.forward(inputs), reps)
    plain_ms = time_cuda(lambda: rc.composite_plain(*args, **kw), reps=2,
                         warmup=1)
    n_ops = int(ops.sum())
    tile_pairs = inputs.tile_range[1:] - inputs.tile_range[:-1]
    n_gauss = inputs.attrs.shape[0]
    n_pairs = inputs.pair_gid.shape[0]
    bytes_moved = (4 * (inputs.tile_range.numel() + n_pairs)
                   + 4 * inputs.attrs.numel()
                   + 16 * inputs.height * inputs.width)
    row = {"scene": label, "canvas": [inputs.height, inputs.width],
           "gaussians": n_gauss, "n_pairs": n_pairs,
           "tiles": tile_pairs.numel(),
           "tiles_nonempty": int((tile_pairs > 0).sum()),
           "max_tile_pairs": int(tile_pairs.max()),
           "max_abs_err_rgb": err["rgb"], "max_abs_err_final_t": err["final_t"],
           "pixels_over_tol": bad, "final_t_gate_flips": flipped,
           "ms": ms, "parent_ms": parent_ms, "plain_ms": plain_ms,
           **bound(bytes_moved, n_ops),
           "check_launches": rc.composite_forward.launches - launches_before}
    log("kernel_vs_plain", **row)
    if bad:
        raise AssertionError(f"composite_forward disagrees with its plain "
                             f"twin at {label}: {bad} pixels over atol {ATOL} "
                             f"+ rtol {RTOL}, {flipped} final-T gate flips")
    return row


def bench_loss(rgb, final_t, target):
    """bench.py::main's loss: |rgb - target|.mean() + (mask^2).mean()."""
    return (rgb - target).abs().mean() + ((1.0 - final_t) ** 2).mean()


def grads_agree(got, want) -> dict:
    """Per-array max error and count over the gradient tolerance."""
    out = {}
    for name, cols in GRAD_ARRAYS:
        g, w = got[:, cols], want[:, cols]
        scale = float(w.abs().max()) if w.numel() else 0.0
        diff = (g - w).abs()
        out[name] = {"scale": scale,
                     "max_abs_err": float(diff.max()) if w.numel() else 0.0,
                     "over_tol": int((diff > GRAD_ATOL * scale
                                      + GRAD_RTOL * w.abs()).sum())}
    return out


def check_gradients(label: str, inputs, reps: int = 20,
                    parent=None) -> dict:
    """K1's training mode, K2 and K3 against their twins on the card, with
    bench.py::main's loss over a seeded target. Raises on disagreement.

    The kernel chain is the autograd path ``ops/rasterize.Composite`` (K1
    training mode, K2, K3); the twin chain runs the three plain twins. Their
    per-Gaussian gradients of mean2d, conic, opacity and colour must agree
    within GRAD_ATOL * scale + GRAD_RTOL; K1's training mode must give the
    render mode's rgb and final T to the bit, the twin's n_contrib exactly
    and its checkpoints within the forward tolerance; the card's chunk plan
    must equal its twin's; K2 alone, on the twin's forward, must give the
    same output twice; K3 alone, read through the pairs' stable order as
    the backward calls it, is held to its twin on the kernel's own pair
    rows, must give the same output twice and equal its own call on the
    pairs gathered into that order. With a Parent ``parent``, its K3 on the
    gathered pairs is timed against this K3, and so is the whole reduction
    (its two gathers and its K3, as its backward ran them)."""
    from guassianhand_tpu_torch.ops import rasterize_cuda as rc
    from guassianhand_tpu_torch.ops import segreduce_cuda as sr
    from guassianhand_tpu_torch.ops.rasterize import Composite
    h, w = inputs.height, inputs.width
    tr, gid = inputs.tile_range, inputs.pair_gid
    attrs = inputs.attrs.detach().contiguous()
    n, n_pairs = attrs.shape[0], gid.shape[0]
    kw = {"height": h, "width": w}
    target = torch.as_tensor(np.random.RandomState(1).uniform(
        0, 1, (h, w, 3)).astype(np.float32), device="cuda")
    before = (rc.composite_forward.launches, rc.composite_backward.launches,
              sr.segment_reduce_sorted.launches)

    # the chunk plan: the card's kernel against its twin
    got, want = rc.chunk_plan(tr, n_pairs), rc.chunk_plan_plain(tr, n_pairs)
    plan_items = int(want.n_items)
    plan_equal = bool(int(got.n_items) == plan_items
                      and torch.equal(got.items[:plan_items],
                                      want.items[:plan_items])
                      and torch.equal(got.slot_base, want.slot_base))
    n_slots = int(want.slot_base[-1])

    # K1, training mode
    rgb_r, t_r = rc.composite_forward(tr, gid, attrs, **kw)
    rgb_k, t_k, nc_k, ck_k, sb_k = rc.composite_forward(
        tr, gid, attrs, **kw, store_contrib=True)
    rgb_p, t_p, nc_p, ck_p, sb_p, fwd_ops = rc.composite_plain(
        tr, gid, attrs, **kw, store_contrib=True, count_ops=True)
    bit_identical = bool(torch.equal(rgb_r, rgb_k) and torch.equal(t_r, t_k))
    contrib_mismatch = int((nc_k != nc_p).sum())
    plan_equal &= bool(torch.equal(sb_k, sb_p))
    ck_diff = (ck_k[:n_slots] - ck_p[:n_slots]).abs()
    ck_over = int((ck_diff > ATOL + RTOL * ck_p[:n_slots].abs()).sum())

    # the cotangents of the bench loss at the twin's own forward
    rgb_g = rgb_p.clone().requires_grad_()
    t_g = t_p.clone().requires_grad_()
    g_rgb, g_t = torch.autograd.grad(bench_loss(rgb_g, t_g, target),
                                     [rgb_g, t_g])
    order = torch.argsort(gid, stable=True).to(torch.int32)
    srt = order.long()
    ids = gid[srt]
    bwd_in = (g_rgb, g_t, rgb_p, t_p, nc_p, ck_p, sb_p)
    pair_p, ops = rc.composite_backward_plain(tr, gid, attrs, *bwd_in, **kw,
                                              count_ops=True)
    twin = sr.segment_reduce_plain(gid, pair_p, n, order=order)

    # the kernel chain, through autograd
    a = attrs.clone().requires_grad_()
    rgb, final_t = Composite.apply(a, tr, gid, h, w)
    (kernel,) = torch.autograd.grad(bench_loss(rgb, final_t, target), [a])
    torch.cuda.synchronize()
    agree = grads_agree(kernel, twin)

    # each kernel alone, on the same inputs as its twin; K2 twice
    pair_k = rc.composite_backward(tr, gid, attrs, *bwd_in, **kw)
    reproducible = bool(torch.equal(
        pair_k, rc.composite_backward(tr, gid, attrs, *bwd_in, **kw)))
    vals = pair_k[:, srt].contiguous()
    seg_k = sr.segment_reduce_sorted(gid, pair_k, n, order=order)
    seg_reproducible = same_bits(
        seg_k, sr.segment_reduce_sorted(gid, pair_k, n, order=order))
    seg_order_equal = same_bits(seg_k, sr.segment_reduce_sorted(ids, vals, n))
    seg_p = sr.segment_reduce_plain(gid, pair_k, n, order=order)
    seg_parent_equal = (same_bits(seg_k, parent.sr.segment_reduce_sorted(
        ids, vals, n)) if parent else None)
    pair_err = float((pair_k - pair_p).abs().max()) if n_pairs else 0.0
    seg_agree = grads_agree(seg_k, seg_p)
    launches = [rc.composite_forward.launches - before[0],
                rc.composite_backward.launches - before[1],
                sr.segment_reduce_sorted.launches - before[2]]

    gid64 = gid.long()

    def library():
        return torch.zeros((n, 9), device="cuda").index_add_(0, gid64,
                                                             pair_k.T)
    lib_err = float((library() - seg_p).abs().max()) if n else 0.0
    render_ms, parent_render_ms = time_against_parent(
        lambda: rc.composite_forward(tr, gid, attrs, **kw),
        parent and parent.forward(inputs), reps)
    fwd_ms, parent_fwd_ms = time_against_parent(
        lambda: rc.composite_forward(tr, gid, attrs, **kw,
                                     store_contrib=True),
        parent and parent.forward(inputs, store_contrib=True), reps)
    fwd_plain_ms = time_cuda(lambda: rc.composite_plain(
        tr, gid, attrs, **kw, store_contrib=True), reps=2, warmup=1)
    bwd_ms, parent_bwd_ms = time_against_parent(
        lambda: rc.composite_backward(tr, gid, attrs, *bwd_in, **kw),
        parent and parent.backward(inputs, g_rgb, g_t), reps)
    bwd_plain_ms = time_cuda(lambda: rc.composite_backward_plain(
        tr, gid, attrs, *bwd_in, **kw), reps=2, warmup=1)
    # what the wrappers cost the host a call (allocations, the plan's and
    # the kernel's launches), this tree's and the parent's
    host = {"k1_render": lambda: rc.composite_forward(tr, gid, attrs, **kw),
            "k1_train": lambda: rc.composite_forward(
                tr, gid, attrs, **kw, store_contrib=True),
            "k2": lambda: rc.composite_backward(tr, gid, attrs, *bwd_in,
                                                **kw)}
    if parent:
        host.update({"parent_k1_render": parent.forward(inputs),
                     "parent_k1_train": parent.forward(inputs, True),
                     "parent_k2": parent.backward(inputs, g_rgb, g_t)})
    host_ms = {k: time_host(fn, reps=reps) for k, fn in host.items()}
    plan_ms = time_cuda(lambda: rc.chunk_plan(tr, n_pairs), reps=reps)
    plan_plain_ms = time_cuda(lambda: rc.chunk_plan_plain(tr, n_pairs),
                              reps=2, warmup=1)
    seg_turns = []
    seg_ms, seg_parent_ms = time_against_parent(
        lambda: sr.segment_reduce_sorted(gid, pair_k, n, order=order),
        parent and (lambda: parent.sr.segment_reduce_sorted(ids, vals, n)),
        reps, seg_turns)
    # the whole reduction: this tree's one call against the parent's
    # gathers into the stable order and its K3, as its backward ran them
    red_ms, red_parent_ms = time_against_parent(
        lambda: sr.segment_reduce_sorted(gid, pair_k, n, order=order),
        parent and (lambda: parent.sr.segment_reduce_sorted(
            gid[srt], pair_k[:, srt].contiguous(), n)), reps)
    seg_sorted_ms = time_cuda(lambda: sr.segment_reduce_sorted(ids, vals, n),
                              reps=reps)
    seg_plain_ms = time_cuda(lambda: sr.segment_reduce_plain(
        gid, pair_k, n, order=order), reps=2, warmup=1)
    seg_library_ms = time_cuda(library, reps=reps)

    # bounds count the twins' work (count_ops) and the function's inputs
    # and outputs, not the kernels' staging, hand-offs or checkpoints
    n_tiles = tr.numel() - 1
    fwd_bytes = (4 * (n_tiles + 1 + n_pairs) + 4 * attrs.numel()
                 + 20 * h * w)
    bwd_ops = int(ops.sum())
    bwd_bytes = (4 * (n_tiles + 1) + 4 * n_pairs + 4 * attrs.numel()
                 + 24 * h * w + 4 * 9 * n_pairs)
    seg_bytes = 4 * n_pairs + 4 * n_pairs + 4 * vals.numel() + 4 * 9 * n
    seg_ops = vals.numel()
    plan_bytes = 8 * (n_tiles + 1) + 4 + 16 * plan_items

    row = {"scene": label, "canvas": [h, w], "gaussians": n,
           "n_pairs": n_pairs,
           "training_mode_bit_identical": bit_identical,
           "n_contrib_mismatch": contrib_mismatch,
           "n_contrib_max": int(nc_p.max()) if nc_p.numel() else 0,
           "checkpoints": n_slots, "checkpoints_over_tol": ck_over,
           "checkpoints_max_abs_err": float(ck_diff.max()) if n_slots else 0.0,
           "plan_equal": plan_equal, "plan_items": plan_items,
           "gradients": agree, "pair_rows_max_abs_err": pair_err,
           "k2_bit_reproducible": reproducible,
           "segment_reduce": seg_agree, "index_add_max_abs_err": lib_err,
           "k3_bit_reproducible": seg_reproducible,
           "k3_order_equal_to_gathered": seg_order_equal,
           "k3_equal_to_parent": seg_parent_equal,
           "check_launches": launches,
           "k1_render_ms": render_ms, "k1_render_parent_ms": parent_render_ms,
           "k1_train_ms": fwd_ms, "k1_train_parent_ms": parent_fwd_ms,
           "k1_train_plain_ms": fwd_plain_ms,
           **{f"k1_train_{k}": v
              for k, v in bound(fwd_bytes, int(fwd_ops.sum())).items()},
           "k2_ms": bwd_ms, "k2_parent_ms": parent_bwd_ms,
           "k2_plain_ms": bwd_plain_ms,
           **{f"k2_{k}": v for k, v in bound(bwd_bytes, bwd_ops).items()},
           "host_ms": host_ms,
           "plan_ms": plan_ms, "plan_plain_ms": plan_plain_ms,
           "plan_bound_ms": bound(plan_bytes, 0)["bound_ms"],
           "k3_ms": seg_ms, "k3_parent_ms": seg_parent_ms,
           "k3_turns_ms": seg_turns,
           "k3_gathered_ms": seg_sorted_ms,
           "k3_reduction_ms": red_ms, "k3_reduction_parent_ms": red_parent_ms,
           "k3_plain_ms": seg_plain_ms, "k3_library_ms": seg_library_ms,
           **{f"k3_{k}": v for k, v in bound(seg_bytes, seg_ops).items()}}
    log("grad_vs_plain", **row)
    bad = [f"{k}: {v['over_tol']} over tolerance"
           for part in (agree, seg_agree) for k, v in part.items()
           if v["over_tol"]]
    if not bit_identical:
        bad.append("training mode changed rgb or final T")
    if contrib_mismatch:
        bad.append(f"n_contrib differs from the twin's at "
                   f"{contrib_mismatch} pixels")
    if ck_over:
        bad.append(f"{ck_over} checkpoint values over atol {ATOL} + rtol "
                   f"{RTOL}")
    if not plan_equal:
        bad.append("the chunk plan differs from its twin's")
    if not reproducible:
        bad.append("composite_backward gave two outputs on one input")
    if not seg_reproducible:
        bad.append("segment_reduce_sorted gave two outputs on one input")
    if not seg_order_equal:
        bad.append("segment_reduce_sorted through the order differs from "
                   "its call on the gathered pairs")
    if bad:
        raise AssertionError(f"gradient kernels disagree with their twins "
                             f"at {label}: {'; '.join(bad)}")
    return row


def phase_edge_gradients(parent=None) -> None:
    for label, build, _ in EDGE_SCENES:
        check_gradients(label, build(), reps=2, parent=parent)


def elementwise_ops(fn, n: int, views: int = 0) -> int:
    """The operations of a twin written on (N,) vectors, or on (V, N) for
    ``views`` V: the elements of every PyTorch call in ``fn`` that gives a
    tensor of that shape, indexing excluded. The projection kernels repeat
    their twins op for op, so this counts the kernels' operations too."""
    from torch.overrides import TorchFunctionMode
    count = [0]
    shape = (views, n) if views else (n,)

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is not torch.Tensor.__getitem__ \
                    and isinstance(out, torch.Tensor) and out.shape == shape:
                count[0] += out.numel()
            return out

    with Count():
        fn()
    return count[0]


def check_projection(label: str, xyz, scaling, rotation, camera,
                     reps: int = 20, parent=None) -> dict:
    """K4's forward and adjoint kernels against their twins on the card at
    one camera; raises on disagreement. Every output and gradient must
    equal the twin's to the bit; the report also gives mean2d, depth and
    conic against ATOL + RTOL * |ref| on visible rows, the gradients
    against GRAD_ATOL * scale + GRAD_RTOL * |ref| and exactly 0 on rows
    that are not visible. Beside them the default route: the plain
    projection of ops/projection.py and its autograd backward; with a
    Parent ``parent``, its two kernels on the same inputs, in turns."""
    from guassianhand_tpu_torch.ops import projection_cuda as pc
    from guassianhand_tpu_torch.ops.projection import project_gaussians
    n = xyz.shape[0]
    cs = pc.camera_consts(camera)
    args = (xyz, scaling, rotation, cs)
    rng = np.random.RandomState(2)
    g_m2 = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32),
                           device="cuda")
    g_co = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                           device="cuda")
    before = (pc.project_forward.launches, pc.project_backward.launches)
    got = pc.project_forward(*args)
    want = pc.project_plain(*args)
    g_got = pc.project_backward(*args, g_m2, g_co)
    g_want = pc.project_adjoint_plain(*args, g_m2, g_co)
    torch.cuda.synchronize()
    vis = want[4]
    row = {"scene": label, "gaussians": n, "visible": int(vis.sum()),
           "visible_mismatch": int((got[4] != want[4]).sum()),
           "radius_mismatch": int((got[3] != want[3]).sum()),
           "det_le_0_in_front": int(((pc._fwd_math(
               cs, *pc._columns(xyz, scaling, rotation))["det"] <= 0)
               & (want[1] > 0.2)).sum())}
    over = {}
    for name, a, b in zip(("mean2d", "depth", "conic"), got[:3], want[:3]):
        a, b = a[vis], b[vis]
        row[f"{name}_max_abs_err"] = float((a - b).abs().max()) if n else 0.0
        over[name] = int(((a - b).abs() > ATOL + RTOL * b.abs()).sum())
    for name, a, b in zip(("xyz", "scaling", "rotation"), g_got, g_want):
        scale = float(b.abs().max()) if n else 0.0
        diff = (a - b).abs()
        row[f"grad_{name}_max_abs_err"] = float(diff.max()) if n else 0.0
        row[f"grad_{name}_scale"] = scale
        over[f"grad_{name}"] = int((diff > GRAD_ATOL * scale
                                    + GRAD_RTOL * b.abs()).sum())
        over[f"grad_{name}_not_visible"] = int((a[~vis] != 0).sum())
    row["over_tol"] = over
    row["bits_apart"] = {
        name: int(not same_bits(a, b)) for name, a, b in zip(
            ("mean2d", "depth", "conic", "radius", "visible", "grad_xyz",
             "grad_scaling", "grad_rotation"), (*got, *g_got),
            (*want, *g_want))}
    row["check_launches"] = [pc.project_forward.launches - before[0],
                             pc.project_backward.launches - before[1]]

    def default_route():
        leaves = [t.detach().requires_grad_()
                  for t in (xyz, scaling, rotation)]
        p = project_gaussians(*leaves, camera)
        torch.autograd.grad([p.mean2d, p.conic], leaves, [g_m2, g_co])

    theirs = parent and parent.pc
    row["fwd_turns_ms"], row["bwd_turns_ms"] = [], []
    row["fwd_ms"], row["fwd_parent_ms"] = time_against_parent(
        lambda: pc.project_forward(*args),
        theirs and (lambda: theirs.project_forward(*args)), reps,
        row["fwd_turns_ms"])
    row["bwd_ms"], row["bwd_parent_ms"] = time_against_parent(
        lambda: pc.project_backward(*args, g_m2, g_co),
        theirs and (lambda: theirs.project_backward(*args, g_m2, g_co)), reps,
        row["bwd_turns_ms"])
    row["fwd_plain_ms"] = time_cuda(lambda: pc.project_plain(*args), reps=3)
    row["bwd_plain_ms"] = time_cuda(
        lambda: pc.project_adjoint_plain(*args, g_m2, g_co), reps=3)
    row["default_route_fwd_bwd_ms"] = time_cuda(default_route, reps=3)
    fwd_bytes = 40 * n + 4 * cs.numel() + 29 * n
    bwd_bytes = 60 * n + 4 * cs.numel() + 40 * n
    fwd_ops = elementwise_ops(lambda: pc.project_plain(*args), n)
    bwd_ops = elementwise_ops(
        lambda: pc.project_adjoint_plain(*args, g_m2, g_co), n)
    row["fwd_bound"] = bound(fwd_bytes, fwd_ops)
    row["bwd_bound"] = bound(bwd_bytes, bwd_ops)
    log("projection_vs_plain", **row)
    bad = {k: v for k, v in {**over, **row["bits_apart"]}.items() if v}
    if bad or row["visible_mismatch"] or row["radius_mismatch"]:
        raise AssertionError(f"projection kernels disagree with their twins "
                             f"at {label}: {bad}, visible "
                             f"{row['visible_mismatch']}, radius "
                             f"{row['radius_mismatch']}")
    return row


def phase_projection_scenes() -> None:
    """K4 at the bench scene and the edge scene."""
    from guassianhand_tpu_torch.core.camera import Camera
    rng = np.random.RandomState(0)
    n, hw = 49152, 512
    xyz = rng.uniform(-0.5, 0.5, (n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scaling = rng.uniform(0.002, 0.01, (n, 3))
    f = 1.1 * hw
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 1.8
    cuda = [torch.as_tensor(a.astype(np.float32), device="cuda")
            for a in (xyz, scaling, q)]
    check_projection("bench_512_49152", *cuda,
                     Camera.from_w2c(w2c, K, hw, hw, device="cuda"))
    xyz, scaling, rotation, w2c, K, h, w = projection_edge_scene()
    row = check_projection(
        "edge", *(torch.as_tensor(a, device="cuda")
                  for a in (xyz, scaling, rotation)),
        Camera.from_w2c(w2c, K, h, w, device="cuda"), reps=2)
    if row["det_le_0_in_front"] == 0 or row["visible"] == row["gaussians"]:
        raise AssertionError(f"the edge scene lacks det <= 0 or culled "
                             f"rows: {row}")


def view_cameras(w2c, K, height: int, width: int, views: int):
    """``views`` cameras of one image size: ``w2c`` and the same turned
    about the y axis, and as the second view (when there are two or more)
    one that every Gaussian lies behind, so that it sees nothing."""
    from guassianhand_tpu_torch.core.camera import Camera
    w2c = np.asarray(w2c, np.float32)
    out = []
    for i in range(views):
        m = w2c.copy()
        if i == 1:
            m[:3, :3] = np.eye(3)
            m[:3, 3] = [0.0, 0.0, -100.0]
        elif i > 1:
            a = 0.35 * i
            turn = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                             [-np.sin(a), 0, np.cos(a)]], np.float32)
            m[:3, :3] = w2c[:3, :3] @ turn
        out.append(Camera.from_w2c(m, K, height, width, device="cuda"))
    return out


def check_projection_views(label: str, xyz, scaling, rotation, cameras,
                           reps: int = 20, parent=None) -> dict:
    """K4 under a stack of V cameras (one launch each way) against its
    twins: every output and every gradient equal to the bit, and the
    kernels' own single-camera launches equal to the stacked one. Timed:
    the one launch, this tree's V single-camera launches, and with a Parent
    ``parent`` its V single-camera launches, in turns. Raises on any
    difference."""
    from guassianhand_tpu_torch.ops import projection_cuda as pc
    n, v = xyz.shape[0], len(cameras)
    consts = torch.stack([pc.camera_consts(c) for c in cameras])
    rows = (xyz, scaling, rotation)
    rng = np.random.RandomState(12)
    g_m2 = torch.as_tensor(rng.normal(size=(v, n, 2)).astype(np.float32),
                           device="cuda")
    g_co = torch.as_tensor(rng.normal(size=(v, n, 3)).astype(np.float32),
                           device="cuda")
    before = (pc.project_forward.launches, pc.project_backward.launches)
    got = pc.project_forward(*rows, consts)
    want = pc.project_plain(*rows, consts)
    g_got = pc.project_backward(*rows, consts, g_m2, g_co)
    g_want = pc.project_adjoint_plain(*rows, consts, g_m2, g_co)
    singles = [pc.project_forward(*rows, consts[i]) for i in range(v)]
    torch.cuda.synchronize()
    names = ("mean2d", "depth", "conic", "radius", "visible")
    apart = {name: int(not same_bits(a, b))
             for name, a, b in zip(names, got, want)}
    apart.update({f"grad_{name}": int(not same_bits(a, b)) for name, a, b in
                  zip(("xyz", "scaling", "rotation"), g_got, g_want)})
    apart["single_launches"] = sum(
        int(not same_bits(a[i], b)) for i in range(v)
        for a, b in zip(got, singles[i]))
    row = {"scene": label, "gaussians": n, "views": v,
           "visible_by_view": got[4].sum(dim=1).tolist(),
           "apart": apart,
           "check_launches": [pc.project_forward.launches - before[0],
                              pc.project_backward.launches - before[1]]}
    if reps:
        theirs = parent and parent.pc.project_forward
        row["fwd_ms"], row["fwd_parent_ms"] = time_against_parent(
            lambda: pc.project_forward(*rows, consts),
            theirs and (lambda: [theirs(*rows, consts[i])
                                 for i in range(v)]), reps)
        row["fwd_single_launches_ms"] = time_cuda(
            lambda: [pc.project_forward(*rows, consts[i]) for i in range(v)],
            reps)
        row["bwd_ms"] = time_cuda(
            lambda: pc.project_backward(*rows, consts, g_m2, g_co), reps)
        row["host_ms"] = {
            "one_launch": time_host(
                lambda: pc.project_forward(*rows, consts), reps),
            "single_launches": time_host(
                lambda: [pc.project_forward(*rows, consts[i])
                         for i in range(v)], reps)}
        if parent:
            row["host_ms"]["parent_single_launches"] = time_host(
                lambda: [theirs(*rows, consts[i]) for i in range(v)], reps)
        # the rows once, each view's constants, outputs and cotangents
        row["fwd_bound"] = bound(
            40 * n + 4 * consts.numel() + 29 * n * v,
            elementwise_ops(lambda: pc.project_plain(*rows, consts), n, v))
        row["bwd_bound"] = bound(
            40 * n + 4 * consts.numel() + 20 * n * v + 40 * n,
            elementwise_ops(lambda: pc.project_adjoint_plain(
                *rows, consts, g_m2, g_co), n, v))
    log("projection_views", **row)
    if any(apart.values()):
        raise AssertionError(f"the projection kernels under {v} views differ "
                             f"from their twins at {label}: {apart}")
    return row


def phase_projection_views() -> None:
    """K4 with a view axis at shapes the main path does not reach: V = 1,
    2 and 4 with the second view empty, at the edge scene (451 Gaussians,
    not a multiple of the 128-thread CTA) and at one Gaussian."""
    xyz, scaling, rotation, w2c, K, h, w = projection_edge_scene()
    rows = [torch.as_tensor(a, device="cuda") for a in (xyz, scaling,
                                                        rotation)]
    for views in (1, 2, 4):
        cams = view_cameras(w2c, K, h, w, views)
        row = check_projection_views(f"edge_{views}_views", *rows, cams,
                                     reps=0)
        if views > 1 and row["visible_by_view"][1] != 0:
            raise AssertionError(f"the empty view sees Gaussians: {row}")
        one = [t[-1:].contiguous() for t in rows]   # on the optical axis
        check_projection_views(f"one_gaussian_{views}_views", *one, cams,
                               reps=0)


def segment_cases():
    """K3's edge cases, each (label, sorted ids (P,) int32, n): empty
    leading, interior and trailing segments, ids >= n, one run of 1,500
    pairs and runs across warp and CTA boundaries; runs of 3 over 3,000
    items; no items; no segments; ids all >= n."""
    rng = np.random.RandomState(9)
    n = 3000
    ids = rng.randint(40, 2900, 6000)
    ids = ids[ids % 11 != 5]
    ids = np.concatenate([ids, np.full(1500, 1234),
                          rng.randint(n, n + 50, 30)])
    return (("gaps_long_run_trash", np.sort(ids).astype(np.int32), n),
            ("runs_of_3", np.repeat(np.arange(1000), 3).astype(np.int32),
             1000),
            ("no_items", np.zeros(0, np.int32), 500),
            ("no_segments", np.sort(rng.randint(0, 5, 300)).astype(np.int32),
             0),
            ("all_dropped", np.sort(rng.randint(64, 90, 700)).astype(
                np.int32), 64))


def phase_segment_reduce_edges(parent=None) -> None:
    """K3 against its twin at its edge cases, with the ids shuffled and
    read through their stable order, and sorted without it: within atol
    GRAD_ATOL * scale + rtol GRAD_RTOL, two calls equal to the bit, the two
    ways equal to the bit."""
    from guassianhand_tpu_torch.ops import segreduce_cuda as sr
    rng = np.random.RandomState(10)
    for label, ids_sorted, n in segment_cases():
        p = len(ids_sorted)
        runs = np.unique(ids_sorted, return_counts=True)
        longest = int(runs[1].max()) if p else 0
        crossing = int(sum(1 for k in range(K3_CTA_ITEMS, p, K3_CTA_ITEMS)
                           if ids_sorted[k - 1] == ids_sorted[k]))
        perm = rng.permutation(p)
        ids_u = ids_sorted[perm]
        vals_u = rng.normal(size=(9, p)).astype(np.float32)
        cuda = {k: torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                for k, a in (("ids", ids_u), ("vals", vals_u))}
        order = torch.argsort(cuda["ids"], stable=True).to(torch.int32)
        # the pairs gathered into that order: the same sums, term by term
        cuda["ids_s"] = cuda["ids"][order.long()].contiguous()
        cuda["vals_s"] = cuda["vals"][:, order.long()].contiguous()
        before = sr.segment_reduce_sorted.launches
        got = sr.segment_reduce_sorted(cuda["ids"], cuda["vals"], n,
                                       order=order)
        again = sr.segment_reduce_sorted(cuda["ids"], cuda["vals"], n,
                                         order=order)
        plain_order = sr.segment_reduce_sorted(cuda["ids_s"], cuda["vals_s"],
                                               n)
        want = sr.segment_reduce_plain(cuda["ids"], cuda["vals"], n,
                                       order=order)
        torch.cuda.synchronize()
        scale = float(want.abs().max()) if want.numel() else 0.0
        diff = (got - want).abs()
        kept = ids_sorted[ids_sorted < n]
        row = {"case": label, "items": p, "segments": n,
               "longest_run": longest, "runs_across_ctas": crossing,
               "empty_segments": int(n - np.unique(kept).size),
               "empty_leading": int(kept.min()) if kept.size else n,
               "empty_trailing": int(n - 1 - kept.max()) if kept.size else n,
               "dropped": int((ids_sorted >= n).sum()),
               "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
               "over_tol": int((diff > GRAD_ATOL * scale
                                + GRAD_RTOL * want.abs()).sum()),
               "second_call_differs": not same_bits(got, again),
               "sorted_call_differs": not same_bits(got, plain_order),
               "check_launches": sr.segment_reduce_sorted.launches - before}
        if parent:
            row["equal_to_parent"] = same_bits(got, parent.sr.
                                               segment_reduce_sorted(
                                                   cuda["ids_s"],
                                                   cuda["vals_s"], n))
        if p and n:
            row["ms"] = time_cuda(lambda: sr.segment_reduce_sorted(
                cuda["ids"], cuda["vals"], n, order=order), reps=5)
        log("segment_reduce_edges", **row)
        if label == "gaps_long_run_trash" and not (
                row["empty_leading"] and row["empty_trailing"]
                and row["empty_segments"] > row["empty_leading"]
                + row["empty_trailing"] and longest > 1024 and crossing
                and row["dropped"]):
            raise AssertionError(f"the K3 edge case lacks a gap, the long "
                                 f"run or dropped ids: {row}")
        if row["over_tol"] or row["second_call_differs"] \
                or row["sorted_call_differs"]:
            raise AssertionError(f"segment_reduce_sorted disagrees at "
                                 f"{label}: {row}")


def attention_bounds(n_live: int, heads: int, d: int) -> dict:
    """The least time of each of the three kernels over L live rows, two
    ways kept apart. Per score the products are 4 D flops forward, 8 D dkv
    and 6 D dq, and the other operations (the scale, the max, exp, the sums
    and the split of P and dS) 4, 5 and 5. The kernels run the products on
    the tensor cores as three TF32 products each (split TF32), so their
    bound is the largest of products over PEAK_TF32_FLOPS / 3, the other
    operations over PEAK_FP32_FLOPS and the bytes over the memory rate;
    ``fp32`` is the bound of the same work with every operation an fp32 FMA
    on the CUDA cores (the bound of the design before the tensor cores)."""
    rows, scores = n_live * heads, n_live * n_live * heads
    out = {}
    for name, n_bytes, product, other in (
            ("forward", 4 * (4 * rows * d + rows), 4 * d, 4),
            ("dkv", 4 * (6 * rows * d + 2 * rows), 8 * d, 5),
            ("dq", 4 * (5 * rows * d + 2 * rows), 6 * d, 5)):
        times = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                 "tensor_cores": product * scores
                 / (PEAK_TF32_FLOPS / 3) * 1e3,
                 "fp32_cores": other * scores / PEAK_FP32_FLOPS * 1e3}
        by = max(times, key=times.get)
        out[name] = {"bound_ms": times[by],
                     "bound_by": "bytes" if by == "bytes" else "operations",
                     "ms_by_part": times, "bytes": n_bytes,
                     "split_tf32_flops": product * scores,
                     "fp32_ops": other * scores,
                     "fp32": bound(n_bytes, (product + other) * scores)}
    return out


def check_attention(label: str, q, k, v, mask, reps: int = 5,
                    timed: bool = True, parent=None) -> dict:
    """K5's forward, dkv and dq kernels against their twins on the card,
    over the live rows of ``mask`` (N,) (all rows if None); raises on
    disagreement. out within ATOL + RTOL * |ref|, dq/dk/dv within
    ATTN_GRAD_ATOL * scale (scale the largest |gradient| of the three
    arrays: with one live row dq is 0 up to rounding), a second call of
    each kernel equal to the first to the bit, and through
    ``flash_attention`` masked rows exactly 0 in the output and in every
    gradient. The kernel's and the twin's outputs are also held against a
    float64 evaluation (the gradients too, each from its own forward), to
    show which rounds further. Beside them the
    default chunked route and torch's scaled_dot_product_attention with the
    same key mask, each forward + backward, and with a Parent ``parent``
    its three kernels on the same inputs, timed in turns with these."""
    import torch.nn.functional as F

    from guassianhand_tpu_torch.ops import flash_attention_cuda as fa
    from guassianhand_tpu_torch.ops.blockwise_attention import \
        blockwise_attention
    n, h, d = q.shape
    live = (torch.arange(n, device="cuda") if mask is None
            else mask.nonzero()[:, 0])
    L = live.numel()
    ql, kl, vl = (t[live].contiguous() for t in (q, k, v))
    dout = torch.as_tensor(np.random.RandomState(3).normal(
        size=(n, h, d)).astype(np.float32), device="cuda")
    dol = dout[live].contiguous()
    before = [fa.flash_forward.launches, fa.flash_backward_dkv.launches,
              fa.flash_backward_dq.launches]
    out, lse = fa.flash_forward(ql, kl, vl)
    out_p, lse_p = fa.flash_attention_plain(ql, kl, vl)
    delta = fa.attention_delta(out, dol)
    dk, dv = fa.flash_backward_dkv(ql, kl, vl, dol, lse, delta)
    dq = fa.flash_backward_dq(ql, kl, vl, dol, lse, delta)
    grads_p = fa.flash_attention_backward_plain(ql, kl, vl, out_p, lse_p, dol)
    again = (*fa.flash_forward(ql, kl, vl),
             *fa.flash_backward_dkv(ql, kl, vl, dol, lse, delta),
             fa.flash_backward_dq(ql, kl, vl, dol, lse, delta))
    # the whole masked route, as the model calls it
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    full = fa.flash_attention(*leaves, mask)
    full_grads = torch.autograd.grad(full, leaves, dout)
    torch.cuda.synchronize()
    out_64, lse_64 = fa.flash_attention_plain(*(t.double()
                                                for t in (ql, kl, vl)))
    grads_64 = fa.flash_attention_backward_plain(
        *(t.double() for t in (ql, kl, vl)), out_64, lse_64, dol.double())
    row = {"scene": label, "n": n, "heads": h, "head_dim": d, "live": L,
           "out_abs_max": float(out_p.abs().max()) if L else 0.0,
           "out_max_abs_err": float((out - out_p).abs().max()) if L else 0.0,
           "out_vs_fp64_max_abs_err": {
               "kernel": float((out - out_64).abs().max()) if L else 0.0,
               "twin": float((out_p - out_64).abs().max()) if L else 0.0},
           "grad_vs_fp64_max_abs_err": {
               who: {name: float((g - g64).abs().max()) if L else 0.0
                     for name, g, g64 in zip(("dq", "dk", "dv"), grads,
                                             grads_64)}
               for who, grads in (("kernel", (dq, dk, dv)),
                                  ("twin", grads_p))},
           "lse_max_abs_err": float((lse - lse_p).abs().max()) if L else 0.0,
           "out_over_atol_alone": int(((out - out_p).abs() > ATOL).sum())}
    over = {"out": int(((out - out_p).abs() > ATOL + RTOL * out_p.abs())
                       .sum())}
    scale = max(float(g.abs().max()) for g in grads_p) if L else 0.0
    row["grad_scale"] = scale
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_p):
        diff = (a - b).abs()
        row[f"{name}_max_abs_err"] = float(diff.max()) if L else 0.0
        over[name] = int((diff > ATTN_GRAD_ATOL * scale).sum())
    masked = (torch.ones(n, dtype=torch.bool, device="cuda") if mask is None
              else ~mask)
    masked[live] = False
    over["masked_rows_nonzero"] = int(
        sum((t[masked] != 0).sum() for t in (full, *full_grads)))
    over["route_vs_kernel"] = int((full[live] != out).sum())
    over["second_call_differs"] = int(sum(
        (a != b).sum() for a, b in zip((out, lse, dk, dv, dq), again)))
    row["over_tol"] = over
    row["check_launches"] = [fa.flash_forward.launches - before[0],
                             fa.flash_backward_dkv.launches - before[1],
                             fa.flash_backward_dq.launches - before[2]]
    if timed:
        def default_route():
            lv = [t.detach().requires_grad_() for t in (q, k, v)]
            o = blockwise_attention(*lv, mask, flash=False)
            torch.autograd.grad(o, lv, dout)

        qh, kh, vh = (t.transpose(0, 1)[None].contiguous() for t in (q, k, v))
        key_mask = None if mask is None else mask[None, None, None, :]
        sdpa_leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        do_h = dout.transpose(0, 1)[None].contiguous()

        def sdpa_forward():
            return F.scaled_dot_product_attention(*sdpa_leaves,
                                                  attn_mask=key_mask)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_forward(), sdpa_leaves, do_h)

        sdpa_out = sdpa_forward()[0].transpose(0, 1)[live]
        row["sdpa_vs_kernel_max_abs_err"] = float(
            (sdpa_out.detach() - out).abs().max())
        args = (ql, kl, vl, dol, lse, delta)
        for key, name in (("fwd", "flash_forward"),
                          ("dkv", "flash_backward_dkv"),
                          ("dq", "flash_backward_dq")):
            n_args = 3 if key == "fwd" else 6
            mine = getattr(fa, name)
            theirs = parent and getattr(parent.fa, name)
            row[f"{key}_ms"], row[f"{key}_parent_ms"] = time_against_parent(
                lambda: mine(*args[:n_args]),
                theirs and (lambda: theirs(*args[:n_args])), reps)
        row["fwd_plain_ms"] = time_cuda(
            lambda: fa.flash_attention_plain(ql, kl, vl), reps=1, warmup=1)
        row["bwd_plain_ms"] = time_cuda(
            lambda: fa.flash_attention_backward_plain(
                ql, kl, vl, out_p, lse_p, dol), reps=1, warmup=1)
        row["default_route_fwd_bwd_ms"] = time_cuda(default_route, reps=2,
                                                    warmup=1)
        row["sdpa_fwd_ms"] = time_cuda(sdpa_forward, reps)
        row["sdpa_fwd_bwd_ms"] = time_cuda(sdpa_fwd_bwd, reps)
        row["bounds"] = attention_bounds(L, h, d)
    log("attention_vs_plain", **row)
    bad = {k: v for k, v in over.items() if v}
    if bad:
        raise AssertionError(f"attention kernels disagree with their twins "
                             f"at {label}: {bad}")
    return row


def phase_attention_edges(dtype=torch.float32) -> None:
    """K5 at shapes the main path does not reach: one live row, every row
    live, no mask, no live row, and N and L that no block divides; live
    counts on the edges of a warp's 16 rows and of a CTA's 64 rows and
    tile (15, 16, 17, 63, 64, 65, 129 of 150); and scores up to about 30
    in magnitude, where exp's range and the split's lo term matter. With
    ``dtype`` bf16 the bf16 kernels (``check_attention_bf16``) on the same
    cases, and then live counts on the edges of their 128-row CTAs and
    128-key forward tiles, which their 64-row backward tiles halve (127,
    128, 129, 255, 256, 257 of 300), drawn after the shared cases so that
    those keep their inputs."""
    rng = np.random.RandomState(4)

    def qkv(n, heads=4, scale=1.0):
        return [torch.as_tensor((scale * rng.normal(size=(n, heads, 32)))
                                .astype(np.float32), device="cuda").to(dtype)
                for _ in range(3)]

    def check(label, q, k, v, mask):
        if dtype == torch.float32:
            check_attention(label, q, k, v, mask, timed=False)
        else:
            check_attention_bf16(label, q, k, v, mask)

    n = 77
    one = torch.zeros(n, dtype=torch.bool, device="cuda")
    one[40] = True
    cases = (("one_live_77", one),
             ("all_live_77", torch.ones(n, dtype=torch.bool, device="cuda")),
             ("no_mask_77", None),
             ("none_live_77", torch.zeros(n, dtype=torch.bool, device="cuda")),
             ("ragged_77", torch.as_tensor(rng.uniform(size=n) < 0.6,
                                           device="cuda")))
    for label, mask in cases:
        check(label, *qkv(n), mask)
    n = 150
    for live in (15, 16, 17, 63, 64, 65, 129):
        mask = np.zeros(n, bool)
        mask[rng.choice(n, live, replace=False)] = True
        check(f"live_{live}_of_{n}", *qkv(n),
              torch.as_tensor(mask, device="cuda"))
    q, k, _ = qkv(n, scale=2.6)
    v = qkv(n)[0]
    top = float((torch.einsum("ihd,jhd->hij", q.float(), k.float())
                 / math.sqrt(32)).abs().max())
    if top < 25:
        raise AssertionError(f"the large-score case reaches |score| {top}")
    log("attention_large_scores", dtype=str(dtype), max_abs_score=top)
    check(f"large_scores_{n}", q, k, v, None)
    if dtype == torch.bfloat16:
        n = 300
        for live in (127, 128, 129, 255, 256, 257):
            mask = np.zeros(n, bool)
            mask[rng.choice(n, live, replace=False)] = True
            check(f"live_{live}_of_{n}", *qkv(n),
                  torch.as_tensor(mask, device="cuda"))


def bf16_attention_bounds(n_live: int, heads: int, d: int,
                          sm_clock_mhz: float) -> dict:
    """The least time of each bf16 attention kernel over L live rows: the
    larger of its products on the tensor cores in bf16 (4 D flops a score
    forward, 8 D dkv, 6 D dq, one MMA a product), its exp (one a score in
    each kernel) on the special-function units at ``sm_clock_mhz``, and
    its bytes (q, k, v, dout, out, dq, dk, dv 2 bytes a value, lse and
    delta 4 a row, each read or written once)."""
    rows, scores = n_live * heads, n_live * n_live * heads
    sfu_per_s = SFU_PER_CLOCK * SMS * sm_clock_mhz * 1e6
    out = {}
    for name, n_bytes, product in (
            ("forward", 2 * 4 * rows * d + 4 * rows, 4 * d),
            ("dkv", 2 * 6 * rows * d + 8 * rows, 8 * d),
            ("dq", 2 * 5 * rows * d + 8 * rows, 6 * d)):
        times = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                 "tensor_cores": product * scores / PEAK_BF16_FLOPS * 1e3,
                 "exp": scores / sfu_per_s * 1e3}
        by = max(times, key=times.get)
        out[name] = {"bound_ms": times[by],
                     "bound_by": "bytes" if by == "bytes" else "operations",
                     "limited_by": by, "ms_by_part": times,
                     "bytes": n_bytes, "bf16_flops": product * scores,
                     "exps": scores, "sm_clock_mhz": sm_clock_mhz}
    return out


def check_attention_bf16(label: str, q, k, v, mask, timed: bool = False,
                         sm_clock_mhz: float = None, reps: int = 5,
                         parent=None) -> dict:
    """K5's bf16 forward, dkv and dq kernels against their bf16 twins on
    the card, over the live rows of ``mask`` (N,) (all if None), q, k, v
    bf16; raises on disagreement. out, dq, dk and dv within BF16_ULPS bf16
    ulps (``bf16_ulps``) of the twins' on the same inputs (the backward
    twin given the kernel forward's lse and delta) and in norm no further
    from the float32 function than BF16_NORM_RATIO times the twins', lse
    within ATOL + RTOL |ref|, a second call of
    each kernel equal to the first to the bit, and through
    ``flash_attention`` masked rows exactly 0 in the output and in every
    gradient. Beside them, each one's relative error (in norm) against the
    float32 function of the same bf16 inputs (the float32 twins), the
    kernel's and the twin's. ``timed``: the three kernels (with a Parent
    ``parent``, its three bf16 kernels on the same inputs, in turns with
    these), the twins, and torch's scaled_dot_product_attention on the same
    bf16 inputs two ways: over all N rows with the key mask, and on the
    gathered live rows with no mask under its flash backend (the same
    function as the kernels', the fair yardstick; timed only, never called
    by the port), and the bounds (``bf16_attention_bounds``)."""
    import torch.nn.functional as F

    from guassianhand_tpu_torch.ops import flash_attention_cuda as fa
    n, h, d = q.shape
    live = (torch.arange(n, device="cuda") if mask is None
            else mask.nonzero()[:, 0])
    L = live.numel()
    ql, kl, vl = (t[live].contiguous() for t in (q, k, v))
    dout = torch.as_tensor(np.random.RandomState(3).normal(
        size=(n, h, d)).astype(np.float32), device="cuda").to(q.dtype)
    dol = dout[live].contiguous()
    out, lse = fa.flash_forward(ql, kl, vl)
    out_p, lse_p = fa.flash_attention_plain(ql, kl, vl)
    delta = fa.attention_delta(out, dol)
    dk, dv = fa.flash_backward_dkv(ql, kl, vl, dol, lse, delta)
    dq = fa.flash_backward_dq(ql, kl, vl, dol, lse, delta)
    # the backward twin on the backward kernels' own inputs (the kernel
    # forward's lse and delta)
    grads_p = fa._backward_plain(ql, kl, vl, dol, lse, delta, want_dq=True,
                                 want_dkv=True)
    again = (*fa.flash_forward(ql, kl, vl),
             *fa.flash_backward_dkv(ql, kl, vl, dol, lse, delta),
             fa.flash_backward_dq(ql, kl, vl, dol, lse, delta))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    full = fa.flash_attention(*leaves, mask)
    full_grads = torch.autograd.grad(full, leaves, dout)
    # the float32 function of the same (bf16) inputs
    up = [t.float() for t in (ql, kl, vl)]
    out_32, lse_32 = fa.flash_attention_plain(*up)
    grads_32 = fa.flash_attention_backward_plain(*up, out_32, lse_32,
                                                 dol.float())
    torch.cuda.synchronize()

    def rel(a, b):
        diff = float((a.float() - b).norm()) if L else 0.0
        return diff / float(b.norm()) if diff else 0.0

    row = {"scene": label, "n": n, "heads": h, "head_dim": d, "live": L,
           "dtype": str(q.dtype), "ulps": BF16_ULPS, "floor": BF16_FLOOR}
    over = {}
    for name, a, b, b32 in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                               (out_p, *grads_p), (out_32, *grads_32)):
        ulps = bf16_ulps(a, b) if L else torch.zeros(0)
        row[f"{name}_max_abs_err"] = (float((a.float() - b.float()).abs()
                                            .max()) if L else 0.0)
        row[f"{name}_max_ulps"] = float(ulps.max()) if L else 0.0
        row[f"{name}_vs_fp32_rel"] = {"kernel": rel(a, b32),
                                      "twin": rel(b, b32)}
        over[name] = int((ulps > BF16_ULPS).sum())
        over[f"{name}_vs_fp32"] = int(
            rel(a, b32) > BF16_NORM_RATIO * rel(b, b32))
    row["lse_max_abs_err"] = float((lse - lse_p).abs().max()) if L else 0.0
    over["lse"] = int(((lse - lse_p).abs() > ATOL + RTOL * lse_p.abs())
                      .sum())
    masked = (torch.ones(n, dtype=torch.bool, device="cuda") if mask is None
              else ~mask)
    masked[live] = False
    over["masked_rows_nonzero"] = int(
        sum((t[masked] != 0).sum() for t in (full, *full_grads)))
    over["route_vs_kernel"] = int((full[live] != out).sum())
    over["second_call_differs"] = int(sum(
        (a != b).sum() for a, b in zip((out, lse, dk, dv, dq), again)))
    over["types"] = int(any(t.dtype != q.dtype for t in (out, dq, dk, dv))
                        or lse.dtype != torch.float32)
    row["over_tol"] = over
    if timed:
        qh, kh, vh = (t.transpose(0, 1)[None].contiguous() for t in (q, k, v))
        key_mask = None if mask is None else mask[None, None, None, :]
        sdpa_leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        do_h = dout.transpose(0, 1)[None].contiguous()

        def sdpa_forward():
            return F.scaled_dot_product_attention(*sdpa_leaves,
                                                  attn_mask=key_mask)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_forward(), sdpa_leaves, do_h)

        sdpa_out = sdpa_forward()[0].transpose(0, 1)[live]
        row["sdpa_vs_kernel_max_ulps"] = float(
            bf16_ulps(out, sdpa_out.detach()).max())
        # the gathered live rows, no mask, flash backend
        from torch.nn.attention import SDPBackend, sdpa_kernel
        gathered = [t.transpose(0, 1)[None].contiguous().requires_grad_()
                    for t in (ql, kl, vl)]
        do_g = dol.transpose(0, 1)[None].contiguous()

        def sdpa_gathered():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(*gathered)

        def sdpa_gathered_fwd_bwd():
            torch.autograd.grad(sdpa_gathered(), gathered, do_g)

        row["sdpa_gathered_vs_kernel_max_ulps"] = float(bf16_ulps(
            out, sdpa_gathered()[0].transpose(0, 1).detach()).max())
        args = (ql, kl, vl, dol, lse, delta)
        for key, name, n_args in (("fwd", "flash_forward", 3),
                                  ("dkv", "flash_backward_dkv", 6),
                                  ("dq", "flash_backward_dq", 6)):
            mine = getattr(fa, name)
            theirs = parent and getattr(parent.fa, name)
            turns = []
            row[f"{key}_ms"], row[f"{key}_parent_ms"] = time_against_parent(
                lambda: mine(*args[:n_args]),
                theirs and (lambda: theirs(*args[:n_args])), reps, turns)
            row[f"{key}_turns_ms"] = turns
        row["fwd_plain_ms"] = time_cuda(
            lambda: fa.flash_attention_plain(ql, kl, vl), reps=1, warmup=1)
        row["bwd_plain_ms"] = time_cuda(
            lambda: fa.flash_attention_backward_plain(
                ql, kl, vl, out_p, lse_p, dol), reps=1, warmup=1)
        row["sdpa_fwd_ms"] = time_cuda(sdpa_forward, reps)
        row["sdpa_fwd_bwd_ms"] = time_cuda(sdpa_fwd_bwd, reps)
        row["sdpa_gathered_fwd_ms"] = time_cuda(sdpa_gathered, reps)
        row["sdpa_gathered_fwd_bwd_ms"] = time_cuda(sdpa_gathered_fwd_bwd,
                                                    reps)
        row["bounds"] = bf16_attention_bounds(L, h, d, sm_clock_mhz)
    log("attention_bf16_vs_plain", **row)
    bad = {k: v for k, v in over.items() if v}
    if bad:
        raise AssertionError(f"bf16 attention kernels disagree with their "
                             f"twins at {label}: {bad}")
    return row


def flagship_config():
    """configs/one_shot.yaml's model: the bf16 feature pipeline with the
    backbone softmax in bf16 and its attention cores rematerialised."""
    from guassianhand_tpu_torch.config import load_config
    cfg = load_config(str(REPO / "configs" / "one_shot.yaml")).model
    if (cfg.compute_dtype, cfg.backbone_softmax_fp32,
            cfg.backbone_attn_remat) != ("bfloat16", False, True):
        raise AssertionError(f"configs/one_shot.yaml no longer asks for the "
                             f"bf16 pipeline: {cfg}")
    return cfg


def phase_flagship(fp32_fit: dict, fp32_serve: dict) -> dict:
    """The flagship configuration (``flagship_config``) at full width with
    both kernel switches on: FIT_STEPS fit steps and REQUESTS requests of
    VIEWS views, each with the launch counts zeroed just before and read
    just after (the bf16 flash attention must launch, the float32 one must
    not); their step and request times, device busy shares and peak bytes
    logged beside the float32 model's on the same route (``fp32_fit`` and
    ``fp32_serve``, phase_fit's and phase_slice's results)."""
    cfg = flagship_config()
    fit = phase_fit(kernels=True, model_cfg=cfg, route="flagship_bf16",
                    want=FIT_KERNELS + FLASH_BF16)
    _, serve_launches, serve = phase_slice(
        kernels=True, model_cfg=cfg, route="flagship_bf16",
        want=SERVE_FLAGSHIP)

    def fit_row(x):
        return {"ms_per_step_mean": float(np.mean([r["ms"] for r in
                                                   x["rows"]])),
                "device_busy_ms": x["busy_ms"],
                "device_busy_share": x["busy_share"],
                "peak_bytes": x["peak_bytes"], "warmup_loss": x["warmup_loss"]}

    def serve_row(x):
        return {"model_ms_mean": float(np.mean([r["model_ms"] for r in
                                                x["rows"]])),
                "batch_ms_mean": float(np.mean([r["batch_ms"] for r in
                                                x["rows"]])),
                "device_busy_ms": x["profile"]["device_busy_ms"],
                "device_busy_share": x["profile"]["device_busy_share"],
                "peak_bytes": x["peak_bytes"]}

    log("flagship", config="configs/one_shot.yaml", route="kernels",
        fit={"bf16": fit_row(fit), "fp32": fit_row(fp32_fit)},
        serve={"bf16": serve_row(serve), "fp32": serve_row(fp32_serve)},
        launches={"fit": fit["launches"], "serve": serve_launches})
    return {"fit": fit, "serve_launches": serve_launches}


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a - b) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def phase_bf16_psnr_gate(steps: int = PSNR_STEPS) -> dict:
    """scripts/bf16_psnr_gate.py on the card: the full-width fit scene fit
    for ``steps`` steps from one seeded init, in fp32, in bf16, and in bf16
    with the backbone softmax in bf16 and its attention cores
    rematerialised (configs/one_shot.yaml's model), each with both kernel
    switches on; the fitted render's PSNR against the target of each bf16
    arm must lie within 0.1 dB of the fp32 arm's (the JAX package's bar,
    configs/one_shot.yaml)."""
    from guassianhand_tpu_torch.cli.render_360 import MODEL_CONFIG
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import no_tf32
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    batch = synthetic_batch(scene, seed=0, with_target=True)
    bf16 = dataclasses.replace(MODEL_CONFIG, compute_dtype="bfloat16")
    arms = {"fp32": MODEL_CONFIG, "bf16": bf16,
            "bf16_softmax_bf16_remat": flagship_config()}
    rows = {}
    with flash_switch(True):
        for name, cfg in arms.items():
            model, step, b, _, _ = fit_model_and_step(
                kernel_config(cfg, True), HW, dict(batch), "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                loss, _ = step(b)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
            with torch.no_grad(), no_tf32():
                rgb = model(b, HW, HW)["comp_rgb"][0, 0]
            rows[name] = {"final_loss": float(loss), "ms_per_step": ms,
                          "psnr_db": psnr(rgb, b["target_rgb"][0]),
                          "finite": bool(torch.isfinite(rgb).all())}
            del model, step, b
    delta = {name: abs(r["psnr_db"] - rows["fp32"]["psnr_db"])
             for name, r in rows.items() if name != "fp32"}
    log("bf16_psnr_gate", steps=steps, arms=rows, psnr_delta_db=delta,
        gate_db=PSNR_GATE_DB)
    if not all(r["finite"] for r in rows.values()):
        raise AssertionError(f"a fitted render is not finite: {rows}")
    if max(delta.values()) > PSNR_GATE_DB:
        raise AssertionError(f"bf16 fits more than {PSNR_GATE_DB} dB from "
                             f"the fp32 fit: {delta}")
    return {"arms": rows, "delta_db": delta}


def phase_raster_fwd_bwd(parent=None) -> dict:
    """bench.py::main's step on the card: project, bin, composite forward
    and backward at the bench scene, with the gradients of xyz, scaling,
    rotation, opacity and colour; ms per step, rays/s and the device's
    busy time in one profiled step. With a Parent
    ``parent``, its step on the same inputs, timed in turns (parent, this
    tree, this tree, parent, RASTER_TURNS times; the medians compared)."""
    from guassianhand_tpu_torch.core.camera import Camera
    from guassianhand_tpu_torch.core.gaussians import Gaussians
    from guassianhand_tpu_torch.ops.rasterize import rasterize
    hw, n = 512, 49152
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-0.5, 0.5, (n, 3))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    arrays = {"xyz": xyz, "rotation": q,
              "opacity": rng.uniform(0.3, 0.9, (n, 1)),
              "scaling": rng.uniform(0.002, 0.01, (n, 3)),
              "shs": rng.uniform(0, 1, (n, 1, 3))}
    leaves = {k: torch.as_tensor(v.astype(np.float32), device="cuda")
              .requires_grad_() for k, v in arrays.items()}
    f = 1.1 * hw
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 1.8
    target = torch.as_tensor(rng.uniform(0, 1, (hw, hw, 3)).astype(
        np.float32), device="cuda")

    def make_step(camera_cls, gaussians_cls, rasterize_fn):
        cam = camera_cls.from_w2c(w2c, K, hw, hw, device="cuda")

        def step():
            out = rasterize_fn(gaussians_cls(**leaves), cam, height=hw,
                               width=hw, use_rgb=True)
            loss = bench_loss(out["comp_rgb"], out["final_t"], target)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return out["n_pairs"], grads
        return step

    def run(step):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RASTER_STEPS):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / RASTER_STEPS

    step = make_step(Camera, Gaussians, rasterize)
    n_pairs, grads = step()
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    # the device's busy time in a profiled step: how far the host holds it
    busy = {"device_busy_ms": device_profile(step)[0]}
    if parent:
        parent_step = make_step(parent.Camera, parent.Gaussians,
                                parent.rasterize)
        busy["parent_device_busy_ms"] = device_profile(parent_step)[0]
        mine, theirs = [], []
        for _ in range(RASTER_TURNS):
            theirs.append(run(parent_step))
            mine += [run(step), run(step)]
            theirs.append(run(parent_step))
        ms = float(np.median(mine))
        busy.update({"ms_in_turns": mine, "parent_ms_in_turns": theirs,
                     "parent_ms_per_step": float(np.median(theirs))})
    else:
        ms = run(step)
    row = {"canvas": [hw, hw], "gaussians": n, "n_pairs": n_pairs,
           "steps": RASTER_STEPS, "ms_per_step": ms, **busy,
           "rays_per_s": hw * hw / (ms * 1e-3), "grads_finite": finite,
           "grad_abs_max": {k: float(g.abs().max())
                            for k, g in zip(leaves, grads)}}
    log("raster_fwd_bwd", **row)
    if not finite:
        raise AssertionError("raster fwd+bwd gave non-finite gradients")
    return row


def phase_slice(kernels: bool = False, model_cfg=None,
                route: str = None, want: tuple = None):
    """R requests of V views of the full-width avatar, on the default route
    or with both kernel switches on (where each request must launch the
    projection once for its V views), of ``model_cfg`` (render_360's
    MODEL_CONFIG, fp32, unless given); ``want`` the kernels the requests
    must launch (all others must not launch); then a profiled request.
    Returns the last request's composite inputs (the avatar's projected
    Gaussians), the launch counts, the last request's Gaussians and
    cameras, the request rows and the profile."""
    from guassianhand_tpu_torch.cli.render_360 import (MODEL_CONFIG,
                                                       orbit_batch,
                                                       render_request)
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.ops.rasterize import multiview_composite_inputs

    route = route or ("kernels" if kernels else "default")
    cfg = kernel_config(model_cfg or MODEL_CONFIG, kernels)
    t0 = time.perf_counter()
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    model = build_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("slice_setup", route=route, seconds=time.perf_counter() - t0,
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

    want = want or (SERVE_KERNELS if kernels else SERVE_DEFAULT)
    with flash_switch(kernels):
        request(1000)                                  # warm-up
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        results = []
        for r in range(REQUESTS):
            counts = read_launches()
            results.append(request(r))
            per = {k: v - counts[k] for k, v in read_launches().items()}
            check_launches(f"request {r} ({route})", per, want)
            if kernels and per["project_forward"] != 1:
                raise AssertionError(
                    f"request {r}: {per['project_forward']} projection "
                    f"launches for its {VIEWS} views, not 1")
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        rows = []
        for r, (batch, out, batch_ms, model_ms) in enumerate(results):
            rgb, mask = out["comp_rgb"], out["comp_mask"]
            row = {"route": route, "request": r, "batch_ms": batch_ms,
                   "model_ms": model_ms, "n_pairs": int(out["n_pairs"][0]),
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
                raise AssertionError(f"request {r}: empty or full render "
                                     f"{row}")
        log("slice", route=route, requests=REQUESTS, views=VIEWS,
            model_ms=[x["model_ms"] for x in rows],
            model_ms_mean=float(np.mean([x["model_ms"] for x in rows])),
            launches=launches, peak_bytes=peak)
        check_launches(f"the serving slice ({route})", launches, want)
        batch, out = results[-1][0], results[-1][1]
        prof = phase_profile(lambda: request(REQUESTS),
                             lambda: model.features(batch), rows, route)
    gs = out["3dgs"][0]
    rcfg = cfg.renderer
    w2cs, Ks = batch["w2c_render"][0], batch["K_render"][0]
    inputs = multiview_composite_inputs(
        gs, w2cs, Ks, height=HW, width=HW, sh_degree=rcfg.sh_degree,
        use_rgb=rcfg.use_rgb, config=rcfg.raster)
    return inputs, launches, {"gaussians": gs, "w2cs": w2cs, "Ks": Ks,
                              "rows": rows, "peak_bytes": peak,
                              "profile": prof}


def _device_us(event) -> float:
    return float(event.self_device_time_total)


def device_profile(fn):
    """Run ``fn`` once under torch.profiler: (device busy ms, the top
    kernels as [name, ms, count])."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _device_us(e) > 0]
    top = sorted(events, key=_device_us, reverse=True)[:12]
    return (sum(_device_us(e) for e in events) / 1e3,
            [[e.key[:60], _device_us(e) / 1e3, e.count] for e in top])


def phase_profile(run_request, run_features, rows,
                  route: str = "default") -> dict:
    """Where a request's time goes: one request under torch.profiler (the
    kernels' device time by name, and the device's busy share of the
    unprofiled request time), and the feature pipeline timed alone."""
    from guassianhand_tpu_torch.models.one_shot import no_tf32
    busy_ms, top = device_profile(run_request)
    request_ms = float(np.mean([r["batch_ms"] + r["model_ms"] for r in rows]))
    with torch.inference_mode(), no_tf32():
        features_ms = time_cuda(run_features, reps=3, warmup=1)
    row = dict(route=route, device_busy_ms=busy_ms,
               request_ms_unprofiled=request_ms,
               device_busy_share=busy_ms / request_ms,
               features_ms=features_ms,
               model_ms_mean=float(np.mean([r["model_ms"] for r in rows])),
               batch_ms_mean=float(np.mean([r["batch_ms"] for r in rows])),
               top_device_ms=top)
    log("profile", **row)
    return row


def zero_launches() -> None:
    for wrapper, attr in launch_counters().values():
        setattr(wrapper, attr, 0)


def read_launches() -> dict:
    return {name: getattr(w, attr)
            for name, (w, attr) in launch_counters().items()}


def launch_counters() -> dict:
    """Each kernel's name: (its wrapper, the wrapper's counter of it). The
    flash attention wrappers count their float32 and bf16 kernels apart."""
    from guassianhand_tpu_torch.ops import flash_attention_cuda as fa
    from guassianhand_tpu_torch.ops import projection_cuda as pc
    from guassianhand_tpu_torch.ops import rasterize_cuda as rc
    from guassianhand_tpu_torch.ops import segreduce_cuda as sr
    counters = {"composite_forward": rc.composite_forward,
                "composite_plan": rc.chunk_plan,
                "composite_backward": rc.composite_backward,
                "segment_reduce_sorted": sr.segment_reduce_sorted,
                "project_forward": pc.project_forward,
                "project_backward": pc.project_backward,
                "flash_forward": fa.flash_forward,
                "flash_backward_dkv": fa.flash_backward_dkv,
                "flash_backward_dq": fa.flash_backward_dq}
    out = {name: (w, "launches") for name, w in counters.items()}
    for name in FLASH_FP32:
        out[f"{name}_bf16"] = (counters[name], "launches_bf16")
    return out


# the kernels each route launches: the default route's four; with both
# switches on the projection and the float32 flash attention too, or in a
# bf16 model (the flagship config) the bf16 flash attention instead
FLASH_FP32 = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")
FLASH_BF16 = tuple(f"{name}_bf16" for name in FLASH_FP32)
DEFAULT_ROUTE = ("composite_forward", "composite_plan", "composite_backward",
                 "segment_reduce_sorted")
FIT_KERNELS = DEFAULT_ROUTE + ("project_forward", "project_backward")
SERVE_DEFAULT = ("composite_forward", "composite_plan")
SERVE_KERNELS = SERVE_DEFAULT + ("project_forward", "flash_forward")
SERVE_FLAGSHIP = SERVE_DEFAULT + ("project_forward", "flash_forward_bf16")


def kernel_config(cfg, kernels: bool):
    """``cfg`` (a OneShotConfig) with projection_impl "pallas" when
    ``kernels``, else as it is."""
    if not kernels:
        return cfg
    r = cfg.renderer
    return dataclasses.replace(cfg, renderer=dataclasses.replace(
        r, raster=dataclasses.replace(r.raster, projection_impl="pallas")))


@contextlib.contextmanager
def flash_switch(on: bool):
    """GH_FLASH_ATTN=1 while ``on``, else 0; restored afterwards."""
    saved = os.environ.get("GH_FLASH_ATTN")
    os.environ["GH_FLASH_ATTN"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("GH_FLASH_ATTN", None)
        else:
            os.environ["GH_FLASH_ATTN"] = saved


def check_launches(label: str, launches: dict, want: tuple) -> None:
    """Every kernel in ``want`` launched, every other one not."""
    missing = [k for k in want if launches[k] == 0]
    extra = [k for k, v in launches.items() if v and k not in want]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"launched off the route {extra}: {launches}")


def fit_model_and_step(cfg, hw: int, batch, device: str):
    """A seeded model of ``cfg`` on ``device``, its Adam and fit step with
    bench_fit_step's FitConfig (vgg 0.1, the frozen base, the static prefix
    cache attached to ``batch``)."""
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.train.fit import (FitConfig,
                                                  attach_static_features,
                                                  make_fit_step,
                                                  make_optimizer)
    from guassianhand_tpu_torch.train.losses import LossWeights
    from guassianhand_tpu_torch.train.vgg import VGGLoss
    fit_cfg = FitConfig(weights=LossWeights(vgg=0.1))
    model = build_model(cfg, seed=0, device="cuda").to(device)
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    step = make_fit_step(model, VGGLoss().to(device), optimizer, scheduler,
                         fit_cfg, height=hw, width=hw)
    return (model, step, attach_static_features(model, batch), fit_cfg,
            optimizer)


def phase_fit(kernels: bool = False, model_cfg=None, route: str = None,
              want: tuple = None) -> dict:
    """The slice: the full-width one-shot fit at bench_fit_step's workload
    (778-vertex hands subdivided twice, 15,404 points, 256^2, vgg 0.1,
    fp32), on the default route or with both kernel switches on. One
    warm-up step, then FIT_STEPS steps with the launch counts zeroed just
    before and read just after. Returns the launches, the step rows, the
    warm-up loss (the parameters' first, before any update) and the fitted
    avatar's inputs of the kernels: its composite inputs in the fit view,
    its Gaussians and camera, and the interaction attention's q, k, v and
    mask. ``model_cfg`` is the model (render_360's MODEL_CONFIG, fp32,
    unless given), ``want`` the kernels the steps must launch (all others
    must not launch)."""
    from guassianhand_tpu_torch.cli.render_360 import MODEL_CONFIG
    from guassianhand_tpu_torch.core.camera import Camera
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import no_tf32
    from guassianhand_tpu_torch.nn import heads
    from guassianhand_tpu_torch.ops.rasterize import multiview_composite_inputs
    from guassianhand_tpu_torch.train.fit import trainable_mask
    route = route or ("kernels" if kernels else "default")
    cfg = kernel_config(model_cfg or MODEL_CONFIG, kernels)
    t0 = time.perf_counter()
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    batch = synthetic_batch(scene, seed=0, with_target=True)
    model, step, batch, fit_cfg, _ = fit_model_and_step(cfg, HW, batch,
                                                         "cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainable = trainable_mask(model)
    torch.cuda.synchronize()
    log("fit_setup", route=route, seconds=time.perf_counter() - t0,
        n_points=scene.n_points, gaussian_slots=2 * scene.n_points,
        target_mask_mean=float(batch["target_mask"].mean()),
        trainable=sorted(n for n, t in trainable.items() if t),
        trainable_params=sum(p.numel() for n, p in model.named_parameters()
                             if trainable[n]),
        params=sum(p.numel() for p in model.parameters()))
    with flash_switch(kernels):
        warmup_loss = float(step(batch)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        rows = []
        for i in range(FIT_STEPS):
            t = time.perf_counter()
            counts = read_launches()
            loss, err = step(batch)
            torch.cuda.synchronize()
            row = {"route": route, "step": i,
                   "ms": (time.perf_counter() - t) * 1e3, "loss": float(loss),
                   **{k: float(v) for k, v in err.items()},
                   "launches": {k: v - counts[k]
                                for k, v in read_launches().items()}}
            log("fit_step", **row)
            rows.append(row)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        frozen_changed = [n for n, p in model.named_parameters()
                          if not trainable[n]
                          and not torch.equal(p, before[n])]
        moved = sorted(n for n, p in model.named_parameters()
                       if trainable[n] and not torch.equal(p, before[n]))
        busy_ms, top = device_profile(lambda: step(batch))
        ms = [r["ms"] for r in rows]
        log("fit", route=route, steps=FIT_STEPS, ms_per_step=ms,
            ms_per_step_mean=float(np.mean(ms)),
            device_busy_ms_profiled_step=busy_ms,
            device_busy_share=busy_ms / float(np.mean(ms)),
            top_device_ms=top, warmup_loss=warmup_loss,
            losses=[r["loss"] for r in rows], launches=launches,
            peak_bytes=peak, moved=moved, frozen_changed=frozen_changed)
        if not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError("the fit gave a non-finite loss")
        if frozen_changed:
            raise AssertionError(f"frozen parameters changed: "
                                 f"{frozen_changed}")
        want_moved = {"identity_code_one_shot", "map_bias", "color_w",
                      "color_b", "opacity_b"}
        if not want_moved <= set(moved):
            raise AssertionError(f"trainable maps that did not move: "
                                 f"{sorted(want_moved - set(moved))}")
        check_launches(f"the fit ({route})", launches, want or (
            FIT_KERNELS + FLASH_FP32 if kernels else DEFAULT_ROUTE))
        # one more forward, with the interaction attention's inputs kept
        captured = []
        attend = heads.blockwise_attention

        def keep(q, k, v, mask=None, **kw):
            captured.append((q.detach().contiguous(), k.detach().contiguous(),
                             v.detach().contiguous(), mask))
            return attend(q, k, v, mask, **kw)

        heads.blockwise_attention = keep
        try:
            with torch.no_grad(), no_tf32():
                gs = model(batch, HW, HW)["3dgs"][0]
        finally:
            heads.blockwise_attention = attend
    rcfg = cfg.renderer
    w2c, K = batch["w2c_render"][0], batch["K_render"][0]
    inputs = multiview_composite_inputs(
        gs, w2c, K, height=HW, width=HW, sh_degree=rcfg.sh_degree,
        use_rgb=rcfg.use_rgb, config=rcfg.raster)
    return {"inputs": inputs, "launches": launches, "rows": rows,
            "warmup_loss": warmup_loss, "gaussians": gs, "peak_bytes": peak,
            "busy_ms": busy_ms, "busy_share": busy_ms / float(np.mean(ms)),
            "camera": Camera.from_w2c(w2c[0], K[0], HW, HW, device="cuda"),
            "attention": captured[0]}


def phase_fit_routes() -> tuple:
    """The fit on the default route, then with both switches on; their
    step times and losses side by side. The warm-up step of each sees the
    same seeded parameters, so its losses agree within rtol 1e-5."""
    default = phase_fit(kernels=False)
    kernels = phase_fit(kernels=True)
    a, b = default["warmup_loss"], kernels["warmup_loss"]
    rel = abs(a - b) / abs(a)
    log("fit_routes", warmup_loss={"default": a, "kernels": b},
        warmup_loss_rel=rel,
        ms_per_step={"default": [r["ms"] for r in default["rows"]],
                     "kernels": [r["ms"] for r in kernels["rows"]]},
        ms_per_step_mean={k: float(np.mean([r["ms"] for r in x["rows"]]))
                          for k, x in (("default", default),
                                       ("kernels", kernels))},
        losses={"default": [r["loss"] for r in default["rows"]],
                "kernels": [r["loss"] for r in kernels["rows"]]})
    if rel > 1e-5:
        raise AssertionError(f"the two routes' first losses disagree: {a} "
                             f"against {b}")
    return default, kernels


def fit_reference_batch():
    """The small fit's one batch, made on the CPU (see phase_reference)."""
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    scene = SyntheticHandScene.build(n_vertices=96, subdivide=1,
                                     height=REF_HW, width=REF_HW,
                                     device="cpu")
    return synthetic_batch(scene, seed=0, with_target=True)


class FitReference:
    """The small model's fit (seeded weights, vgg 0.1, Adam) on one device,
    step by step, on the default route or with both kernel switches on."""

    def __init__(self, device: str, kernels: bool, batch):
        from guassianhand_tpu_torch.train.fit import trainable_mask
        self.kernels = kernels
        self.model, step, b, _, self.optimizer = fit_model_and_step(
            kernel_config(reference_config(), kernels), REF_HW,
            {k: v.to(device) for k, v in batch.items()}, device)
        self._step = lambda: step(b)
        self.trained = {n: p for n, p in self.model.named_parameters()
                        if trainable_mask(self.model)[n]}
        self.initial = {n: p.detach().cpu().clone()
                        for n, p in self.trained.items()}

    def step(self) -> tuple:
        """One fit step: (its loss, the trainable parameters after it, its
        gradients), on the CPU; the gradients are read back from Adam's
        first moment, m = beta1 m + (1 - beta1) g."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]

        def moment(p):
            state = self.optimizer.state.get(p)
            return state["exp_avg"].detach().cpu().clone() if state else 0.0
        before = {n: moment(p) for n, p in self.trained.items()}
        with flash_switch(self.kernels):
            loss = float(self._step()[0])
        grads = {n: (moment(p) - beta1 * before[n]) / (1 - beta1)
                 for n, p in self.trained.items() if p in self.optimizer.state}
        return loss, {n: p.detach().cpu().clone()
                      for n, p in self.trained.items()}, grads


def compare_fits(run, ref, initial) -> dict:
    """How far two FitReference.step results of one step part: the losses'
    relative difference; each parameter's largest absolute difference, the
    count of elements over PARAM_ATOL, and the norm of the difference over
    the norm of ``ref``'s update since ``initial``; the element where the
    parameters part most, with its gradients; each gradient's largest
    absolute difference and count over FIT_GRAD_ATOL * scale +
    FIT_GRAD_RTOL * |g|."""
    (loss_c, par_c, grad_c), (loss_p, par_p, grad_p) = run, ref
    params = {}
    for n, p in par_p.items():
        diff = par_c[n] - p
        apart, moved = float(diff.norm()), float((p - initial[n]).norm())
        params[n] = {"max_abs_diff": float(diff.abs().max()),
                     "over_atol": int((diff.abs() > PARAM_ATOL).sum()),
                     "diff_over_update": (apart / moved if moved else
                                          math.inf if apart else 0.0)}
    worst = max(params, key=lambda n: params[n]["max_abs_diff"])
    at = int((par_c[worst] - par_p[worst]).abs().argmax())
    grad = {}
    for n, g_p in grad_p.items():
        diff = (grad_c[n] - g_p).abs()
        grad[n] = {"max_abs_diff": float(diff.max()),
                   "over_tol": int((diff > FIT_GRAD_ATOL * g_p.abs().max()
                                    + FIT_GRAD_RTOL * g_p.abs()).sum())}
    worst_grad = ({"grad_run": float(grad_c[worst].flatten()[at]),
                   "grad_ref": float(grad_p[worst].flatten()[at]),
                   "grad_scale": float(grad_p[worst].abs().max())}
                  if worst in grad_p else {})
    return {"loss_rel": abs(loss_c - loss_p) / abs(loss_p), "params": params,
            "worst": {"param": worst, "index": at, **worst_grad},
            "grads": grad}


def fit_reference_steps(kernels: bool, batch) -> list:
    """Two fit steps on the card and on the CPU from the same seeded
    weights: compare_fits of each step."""
    card, cpu = (FitReference(d, kernels, batch) for d in ("cuda", "cpu"))
    return [compare_fits(card.step(), cpu.step(), cpu.initial)
            for _ in range(2)]


def phase_fit_reference(kernels: bool = False) -> None:
    """Two fit steps of a small model with the same weights on the card and
    on the CPU, on the default route or with both kernel switches on (the
    card's kernels against the CPU's twins). Step 1 starts from one state
    on both devices: its losses agree within rtol 1e-4, every gradient of a
    trainable parameter within FIT_GRAD_ATOL * scale + FIT_GRAD_RTOL * |g|,
    and every updated trainable parameter within PARAM_ATOL (a step moves
    an element by about lr = 1e-2, so a bound 100 times below that catches
    a step that went astray). Step 2 starts from each device's own state:
    its losses agree within rtol 1e-4, and each parameter's difference
    within PARAM_UPDATE_RTOL of its two steps' update, in norm (a step gone
    astray is off by the order of the update itself). Element by
    element, step 2 is no comparison: the fit's gradient at element 15613
    of identity_code_one_shot takes one of two values, -1.5e-8 or -4.3e-7,
    and the parameters then part by 1.4e-3 there. The decision is a ReLU
    gate: in the texture point encoder's last ResNet block
    (point_encoder_texture.blocks.4, relu(fc_0(x)) in nn/mlp.py), point
    464, hidden channel 17, whose pre-activation is about 1e-7 of the
    layer's range, so its sign is the rounding of the sgemm before it:
    +2.9e-7 with one CPU thread, -9.9e-8 with two (MKL blocks the product
    by thread count), and either on the card (cuBLAS, and the atomics of
    the scatter-mean before it). No code of the port can hold that gate to
    one side on both devices without changing the function
    (tests/torch_fit_reference_repeat.py --trace --cpu-threads 1,2 finds
    it)."""
    steps = fit_reference_steps(kernels, fit_reference_batch())
    log("fit_reference", kernels=kernels, bound=PARAM_ATOL,
        update_rtol=PARAM_UPDATE_RTOL,
        grad_tol=[FIT_GRAD_ATOL, FIT_GRAD_RTOL], steps=steps)
    (first, second) = steps
    bad = [f"step {k}: loss {c['loss_rel']}"
           for k, c in enumerate(steps, 1) if c["loss_rel"] > 1e-4]
    bad += [f"step 1: {n}" for n, v in first["params"].items()
            if v["over_atol"]]
    bad += [f"step 1: {n} gradients" for n, v in first["grads"].items()
            if v["over_tol"]]
    bad += [f"step 2: {n}" for n, v in second["params"].items()
            if v["diff_over_update"] > PARAM_UPDATE_RTOL]
    if bad:
        raise AssertionError(f"card and CPU fits disagree: {bad}")


def phase_reference(kernels: bool = False) -> None:
    """A small model on the card and on the CPU with the same weights, on
    the default route or with both kernel switches on: the card's kernel
    path must agree with the CPU's plain path."""
    from guassianhand_tpu_torch.cli.render_360 import (orbit_batch,
                                                       render_request)
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model
    cfg = kernel_config(reference_config(), kernels)
    hw = REF_HW
    # one batch, made on the CPU: kNN ties decide the interaction mask, so
    # both devices get the very same inputs
    scene = SyntheticHandScene.build(n_vertices=96, subdivide=1, height=hw,
                                     width=hw, device="cpu")
    batch = orbit_batch(scene, synthetic_batch(scene, seed=0), 0, 2, 2)
    outs = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, seed=0, device="cuda").to(device)
        with flash_switch(kernels):
            outs[device] = render_request(
                model, {k: v.to(device) for k, v in batch.items()}, hw, hw)
    diff = {k: float((outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max())
            for k in ("comp_rgb", "comp_mask", "hidden")}
    log("reference", kernels=kernels, cuda_vs_cpu_max_abs=diff)
    if max(diff.values()) > 1e-4:
        raise AssertionError(f"card and CPU renders disagree: {diff}")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", type=Path, default=None,
        help="a checkout whose port package's composite and flash attention "
             "kernels and raster step are timed beside this tree's, in turns")
    args = parser.parse_args(argv)
    info = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    parent = None if args.parent is None else Parent(args.parent.resolve())
    floor_ms = launch_floor_ms()
    log("launch_floor", ms=floor_ms,
        what="torch.cuda._sleep(0) timed as the kernels are")
    bench = scene_inputs(49152, 512, 512)
    bench_row = check_composite("bench_512_49152", bench, parent=parent)
    bench_grad = check_gradients("bench_512_49152", bench, parent=parent)
    del bench
    phase_edges(parent)
    phase_edge_gradients(parent)
    phase_projection_scenes()
    phase_projection_views()
    phase_segment_reduce_edges(parent)
    phase_attention_edges()
    phase_attention_edges(torch.bfloat16)
    phase_raster_fwd_bwd(parent)
    avatar_inputs, serve_launches, _ = phase_slice()
    avatar_row = check_composite("avatar_4x256", avatar_inputs, parent=parent)
    avatar_grad = check_gradients("avatar_4x256", avatar_inputs,
                                  parent=parent)
    del avatar_inputs
    _, serve_kernel_launches, request = phase_slice(kernels=True)
    from guassianhand_tpu_torch.core.camera import Camera
    req = request["gaussians"]
    views_row = check_projection_views(
        "avatar_request_4_views", *(t.contiguous() for t in (
            req.xyz, req.scaling, req.rotation)),
        [Camera.from_w2c(w, k, HW, HW, device="cuda")
         for w, k in zip(request["w2cs"], request["Ks"])], parent=parent)
    del req
    default_fit, kernel_fit = phase_fit_routes()
    fit_launches = default_fit["launches"]
    fit_grad = check_gradients("fit_256", default_fit["inputs"],
                               parent=parent)
    gs = kernel_fit["gaussians"]
    proj = check_projection("fit_256", gs.xyz.contiguous(),
                            gs.scaling.contiguous(), gs.rotation.contiguous(),
                            kernel_fit["camera"], parent=parent)
    attn = check_attention("fit_256", *kernel_fit["attention"][:3],
                           kernel_fit["attention"][3], parent=parent)
    kfit_launches = kernel_fit["launches"]
    flagship = phase_flagship(kernel_fit, request)
    del default_fit, kernel_fit, gs, request
    attn16 = check_attention_bf16(
        "fit_256_bf16", *flagship["fit"]["attention"], timed=True,
        sm_clock_mhz=info["sm_clock_max_mhz"], parent=parent)
    bf16_launches = flagship["fit"]["launches"]
    flagship_serve = flagship["serve_launches"]
    del flagship
    phase_bf16_psnr_gate()
    for kernels in (False, True):
        phase_reference(kernels)
        phase_fit_reference(kernels)

    def grad_err(row, part):
        return max(v["max_abs_err"] for v in row[part].values())

    def by_path(name):
        return {"serve": serve_launches[name],
                "serve_with_switches": serve_kernel_launches[name],
                "fit": fit_launches[name],
                "fit_with_switches": kfit_launches[name]}

    flash_src = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    flash_via = "via guassianhand_tpu/ops/blockwise_attention.py:40"
    kernels = [{
        "name": "composite_forward", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "guassianhand_tpu/ops/rasterize_pallas.py:395",
        "launches": fit_launches["composite_forward"],
        "launches_by_path": by_path("composite_forward"),
        "max_abs_err": max(avatar_row["max_abs_err_rgb"],
                           avatar_row["max_abs_err_final_t"],
                           bench_row["max_abs_err_rgb"],
                           bench_row["max_abs_err_final_t"]),
        "ms": avatar_row["ms"], "plain_ms": avatar_row["plain_ms"],
        "bound_ms": avatar_row["bound_ms"],
        "bound_by": avatar_row["bound_by"], "library_ms": None,
        "ms_bench": bench_row["ms"], "ms_avatar": avatar_row["ms"],
        "ms_fit": fit_grad["k1_train_ms"],
        "parent_ms_bench": bench_row["parent_ms"],
        "parent_ms_avatar": avatar_row["parent_ms"],
        "parent_ms_fit": fit_grad["k1_train_parent_ms"],
        "bound_ms_bench": bench_row["bound_ms"],
        "train_ms_fit": fit_grad["k1_train_ms"],
        "train_plain_ms_fit": fit_grad["k1_train_plain_ms"],
        "train_bound_ms_fit": fit_grad["k1_train_bound_ms"],
        "train_bound_by_fit": fit_grad["k1_train_bound_by"],
    }, {
        "name": "composite_plan", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "guassianhand_tpu/ops/binning.py:186 (slab_layout, in "
                    "XLA: the block tables composite_forward and "
                    "composite_backward take by scalar prefetch)",
        "launches": fit_launches["composite_plan"],
        "launches_by_path": by_path("composite_plan"),
        "max_abs_err": 0.0 if fit_grad["plan_equal"] else None,
        "ms": fit_grad["plan_ms"], "plain_ms": fit_grad["plan_plain_ms"],
        "bound_ms": fit_grad["plan_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_avatar": avatar_grad["plan_ms"],
    }, {
        "name": "composite_backward", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "guassianhand_tpu/ops/rasterize_pallas.py:668",
        "launches": fit_launches["composite_backward"],
        "launches_by_path": by_path("composite_backward"),
        "max_abs_err": max(fit_grad["pair_rows_max_abs_err"],
                           bench_grad["pair_rows_max_abs_err"]),
        "ms": fit_grad["k2_ms"], "plain_ms": fit_grad["k2_plain_ms"],
        "bound_ms": fit_grad["k2_bound_ms"],
        "bound_by": fit_grad["k2_bound_by"], "library_ms": None,
        "ms_bench": bench_grad["k2_ms"], "ms_fit": fit_grad["k2_ms"],
        "ms_avatar": avatar_grad["k2_ms"],
        "parent_ms_bench": bench_grad["k2_parent_ms"],
        "parent_ms_fit": fit_grad["k2_parent_ms"],
        "parent_ms_avatar": avatar_grad["k2_parent_ms"],
        "bound_ms_bench": bench_grad["k2_bound_ms"],
        "bound_ms_avatar": avatar_grad["k2_bound_ms"],
        "bit_reproducible": fit_grad["k2_bit_reproducible"],
        "gradient_max_abs_err_fit": grad_err(fit_grad, "gradients"),
    }, {
        "name": "segment_reduce_sorted", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "guassianhand_tpu/ops/segreduce_pallas.py:137",
        "launches": fit_launches["segment_reduce_sorted"],
        "launches_by_path": by_path("segment_reduce_sorted"),
        "max_abs_err": max(grad_err(fit_grad, "segment_reduce"),
                           grad_err(bench_grad, "segment_reduce")),
        "ms": fit_grad["k3_ms"], "plain_ms": fit_grad["k3_plain_ms"],
        "bound_ms": fit_grad["k3_bound_ms"],
        "bound_by": fit_grad["k3_bound_by"],
        "library_ms": fit_grad["k3_library_ms"],
        "launch_floor_ms": floor_ms, "parent_ms": fit_grad["k3_parent_ms"],
        "turns_ms": fit_grad["k3_turns_ms"],
        "gathered_ms": fit_grad["k3_gathered_ms"],
        "reduction_ms": fit_grad["k3_reduction_ms"],
        "reduction_parent_ms": fit_grad["k3_reduction_parent_ms"],
        "ms_bench": bench_grad["k3_ms"],
        "parent_ms_bench": bench_grad["k3_parent_ms"],
        "bound_ms_bench": bench_grad["k3_bound_ms"],
        "bit_reproducible": fit_grad["k3_bit_reproducible"],
        "equal_to_parent": fit_grad["k3_equal_to_parent"],
    }, {
        "name": "project_forward", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/projection.cu",
        "replaces": "guassianhand_tpu/ops/projection_pallas.py:152",
        "launches": kfit_launches["project_forward"],
        "launches_by_path": by_path("project_forward"),
        "max_abs_err": max(proj[f"{k}_max_abs_err"]
                           for k in ("mean2d", "depth", "conic")),
        "ms": proj["fwd_ms"], "plain_ms": proj["fwd_plain_ms"],
        "bound_ms": proj["fwd_bound"]["bound_ms"],
        "bound_by": proj["fwd_bound"]["bound_by"], "library_ms": None,
        "default_route_fwd_bwd_ms": proj["default_route_fwd_bwd_ms"],
        "launch_floor_ms": floor_ms, "parent_ms": proj["fwd_parent_ms"],
        "turns_ms": proj["fwd_turns_ms"],
        "request_views": views_row["views"],
        "request_ms": views_row["fwd_ms"],
        "request_parent_ms": views_row["fwd_parent_ms"],
        "request_single_launches_ms": views_row["fwd_single_launches_ms"],
        "request_bound_ms": views_row["fwd_bound"]["bound_ms"],
        "request_host_ms": views_row["host_ms"],
    }, {
        "name": "project_backward", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/projection.cu",
        "replaces": "guassianhand_tpu/ops/projection_pallas.py:166",
        "launches": kfit_launches["project_backward"],
        "launches_by_path": by_path("project_backward"),
        "max_abs_err": max(proj[f"grad_{k}_max_abs_err"]
                           for k in ("xyz", "scaling", "rotation")),
        "ms": proj["bwd_ms"], "plain_ms": proj["bwd_plain_ms"],
        "bound_ms": proj["bwd_bound"]["bound_ms"],
        "bound_by": proj["bwd_bound"]["bound_by"], "library_ms": None,
        "default_route_fwd_bwd_ms": proj["default_route_fwd_bwd_ms"],
        "launch_floor_ms": floor_ms, "parent_ms": proj["bwd_parent_ms"],
        "turns_ms": proj["bwd_turns_ms"],
        "request_views_adjoint_ms": views_row["bwd_ms"],
    }, {
        "name": "flash_forward", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"{flash_src}:589 ({flash_via})",
        "launches": kfit_launches["flash_forward"],
        "launches_by_path": by_path("flash_forward"),
        "max_abs_err": attn["out_max_abs_err"],
        "ms": attn["fwd_ms"], "plain_ms": attn["fwd_plain_ms"],
        "bound_ms": attn["bounds"]["forward"]["bound_ms"],
        "bound_by": attn["bounds"]["forward"]["bound_by"],
        "library_ms": attn["sdpa_fwd_ms"], "live_rows": attn["live"],
        "parent_ms": attn["fwd_parent_ms"],
        "bound_ms_fp32_cores": attn["bounds"]["forward"]["fp32"]["bound_ms"],
        "default_route_fwd_bwd_ms": attn["default_route_fwd_bwd_ms"],
        "sdpa_fwd_bwd_ms": attn["sdpa_fwd_bwd_ms"],
    }, {
        "name": "flash_backward_dkv", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"{flash_src}:941 ({flash_via})",
        "launches": kfit_launches["flash_backward_dkv"],
        "launches_by_path": by_path("flash_backward_dkv"),
        "max_abs_err": max(attn["dk_max_abs_err"], attn["dv_max_abs_err"]),
        "ms": attn["dkv_ms"], "plain_ms": attn["bwd_plain_ms"],
        "bound_ms": attn["bounds"]["dkv"]["bound_ms"],
        "bound_by": attn["bounds"]["dkv"]["bound_by"], "library_ms": None,
        "live_rows": attn["live"], "parent_ms": attn["dkv_parent_ms"],
        "bound_ms_fp32_cores": attn["bounds"]["dkv"]["fp32"]["bound_ms"],
    }, {
        "name": "flash_backward_dq", "route": "cuda",
        "source": "guassianhand_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"{flash_src}:1287 ({flash_via})",
        "launches": kfit_launches["flash_backward_dq"],
        "launches_by_path": by_path("flash_backward_dq"),
        "max_abs_err": attn["dq_max_abs_err"],
        "ms": attn["dq_ms"], "plain_ms": attn["bwd_plain_ms"],
        "bound_ms": attn["bounds"]["dq"]["bound_ms"],
        "bound_by": attn["bounds"]["dq"]["bound_by"], "library_ms": None,
        "live_rows": attn["live"], "parent_ms": attn["dq_parent_ms"],
        "bound_ms_fp32_cores": attn["bounds"]["dq"]["fp32"]["bound_ms"],
    }]
    for name, key, err, plain, library in (
            ("flash_forward", "fwd", ("out",), "fwd_plain_ms",
             "sdpa_gathered_fwd_ms"),
            ("flash_backward_dkv", "dkv", ("dk", "dv"), "bwd_plain_ms", None),
            ("flash_backward_dq", "dq", ("dq",), "bwd_plain_ms", None)):
        part = {"fwd": "forward"}.get(key, key)
        kernels.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": "guassianhand_tpu_torch/csrc/flash_attention_bf16.cu",
            "replaces": next(k["replaces"] for k in kernels
                             if k["name"] == name) + ", bf16 inputs",
            "launches": bf16_launches[f"{name}_bf16"],
            "launches_by_path": {
                "fit_flagship_bf16": bf16_launches[f"{name}_bf16"],
                "serve_flagship_bf16": flagship_serve[f"{name}_bf16"]},
            "max_abs_err": max(attn16[f"{e}_max_abs_err"] for e in err),
            "max_ulps": max(attn16[f"{e}_max_ulps"] for e in err),
            "ms": attn16[f"{key}_ms"], "plain_ms": attn16[plain],
            "bound_ms": attn16["bounds"][part]["bound_ms"],
            "bound_by": attn16["bounds"][part]["bound_by"],
            "bound_limited_by": attn16["bounds"][part]["limited_by"],
            "library_ms": attn16[library] if library else None,
            "parent_ms": attn16[f"{key}_parent_ms"],
            "turns_ms": attn16[f"{key}_turns_ms"],
            "sdpa_masked_fwd_ms": attn16["sdpa_fwd_ms"],
            "sdpa_masked_fwd_bwd_ms": attn16["sdpa_fwd_bwd_ms"],
            "sdpa_gathered_fwd_bwd_ms": attn16["sdpa_gathered_fwd_bwd_ms"],
            "live_rows": attn16["live"]})
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
