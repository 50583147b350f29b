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
  2a. sharded: 4 ranks spawned on the one card (gloo, every rank's tensors
     on cuda:0; they load the kernels just built): sharded_raster_4x256,
     the synthetic scene's 30,808 decoration Gaussians at 256^2 through
     parallel/raster_shard.py's all_to_all exchange on data 1 x model 4
     with the suggested capacity, held against the unsharded
     rasterize_multiview at JAX's at-scale gates (render max |d| <= 2e-3
     and at most 1e-4 of pixels over 1e-5; xyz and shs gradients with at
     most 1e-4 of elements over 1e-4 * scale + 1e-3 * |ref| and max |d|
     <= 2e-2 * scale), overflow 0 and more than 50,000 pairs exchanged;
     sharded_fit_2x2_bf16, the flagship with both switches and the
     exchange required, 3 sharded fit steps on data 2 x model 2 (B = 2,
     poses from seeds 0 and 1), the loss finite and falling, the
     replicas' parameters bit-identical after each step, K1-K4 and the
     bf16 K5 launched on every rank, step 1's loss within 1e-4 of the
     mean of two unsharded B = 1 steps and its gradients at the at-scale
     gate (identity_code and map_bias, behind the bf16 feature pipeline,
     in norm against the float32 twin instead), and one sharded step of
     the float32 twin with its loss within 1e-4 of the twin's unsharded
     steps and every gradient at the at-scale gate; the backend, each rank's
     exchange figures, collectives and launches a step logged;
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
  7a. BASELINE.json config #2 (render_100k_512): cli/render_100k.py at
     full size, 8 orbit views at 512^2 of the posed two-hand scene's 55,400
     decoration Gaussians on one 4,096 x 512 canvas, with the launch counts
     zeroed just before the tool's run and read just after (K1 and its plan
     once a render, nothing else), overflow 0, a render profiled; K1 and its
     plan against their twins on that canvas (all 8 views), and the scene
     with projection_impl="pallas": one K4 launch
     for the 8 views, its forward and adjoint equal to their twins to the
     bit;
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
  9a. the flagship at 512^2: cli/fit_one_shot.py --synthetic --height 512
     --width 512 --subdivide 2 with configs/one_shot.yaml, both switches
     and seeded VGG19 weights (vgg 0.1), measured inside the CLI: a
     warm-up, 10 timed steps (wall ms, peak bytes, one launch of each fit
     kernel and the bf16 K5's three a step, the loss falling) and one
     profiled step (busy ms), the CLI's launches counted; K1 in training
     mode, its plan,
     K2, K3 and K4 both ways against their twins at the fitted model's
     inputs (fit_512_bf16); one request of 4 orbit views at 512^2 through
     OneShotAvatarModel with the flagship and both switches, K1 and K4
     (V = 4) against their twins (request_512_bf16);
 10. the edit: configs/one_shot_edit.yaml's model (the flagship's) fits
     its per-identity parameters to the fit scene's target through
     cli/edit.py's own step (lr 0.001, no VGG, the codebook's identity 0,
     the config's edit flags) with both switches on, one warm-up step and
     10 steps, each of which launches K1 in training mode, its plan, K2,
     K3, K4 both ways and the bf16 flash attention's three kernels once and
     nothing else, the loss falling below the warm-up's; then cli/edit.py
     end to end for 2 steps (its render and checkpoint written);
 11. evaluation: cli/fit_one_shot.py --run_val over 4 pose-varied frames
     of that checkpoint with both switches on, each frame launching K1 in
     render mode, its plan and K4's forward twice (its synthetic target's
     render and the model's) and the bf16 flash attention's forward once
     and nothing else, its test_metrics.yml holding the JAX
     package's keys; cli/render_360.py --ckpt renders 8 views of it (the
     config's scene, the one it was fitted on, and turntable.gif); SSIM
     and the seeded random-AlexNet LPIPS of one of its frames on the card
     and on the CPU agree within 1e-5;
 12. InterHand2.6M: configs/one_shot.yaml with both switches on a fake
     layout it writes (tests/torch_interhand_layout.py: 778-vertex
     synthetic MANO pickles subdivided twice, 256^2 JPEGs): the seeded model's
     reference-layout checkpoint through cli/port_checkpoint.py and the
     partial loader (every tensor it carries back to the bit); 10 fit steps
     as the fit CLI runs them, each launching each fit kernel and the bf16
     K5's three once; the fit CLI for 2 steps and --run_val over
     oneshot_reg_i's 14 frames, each launching K1, its plan, K4's forward
     and the bf16 K5's forward once, with load_sample's stages timed;
     cli/port_and_eval.py --dry_run (0, then 2 without the fit frame's
     image) and end to end; load_sample on the card against the CPU; K1-K4
     and the bf16 K5 against their twins at the InterHand fit's inputs;
 13. the point-cloud generator at full width (num_pcl 2,048, 512 point
     channels, a 10-layer backbone of 8 x 64 heads, up factors (2, 4),
     DINOv2 ViT-B/14): a seeded reference-layout checkpoint and a seeded
     Hugging Face DINOv2 state dict through cli/port_checkpoint.py
     --dinov2 and load_point_generator (every tensor back to the bit); the
     one-shot bypass on the synthetic scene's 15,404 points (FPS to 2,048,
     16,384 out), the FPS alone (its indices equal to the CPU's), generate
     on one 252^2 image, ImageFeature at 256^2 and the point z-buffer, each
     timed (wall, device busy, launches, peak bytes) and held against the
     same call on the CPU; no hand-written kernel lies on this path;
 14. reference: a small model rendered, and fitted for 2 steps, on the card
     and on the CPU with the same weights must agree, with the switches off
     and on; and rendered with both switches under each edit flag with the
     codebook's identity 3 and seeded per-identity maps.
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
import tempfile
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
HW512 = 512          # the 512^2 scenes: BASELINE config #2 and the flagship
RENDER_100K_VIEWS = 8
RASTER_STEPS = 20
RASTER_TURNS = 5   # rounds of parent, this, this, parent with --parent
FIT_STEPS = 10
EDIT_STEPS = 10    # timed edit-fit steps after the warm-up
EVAL_FRAMES = 4    # frames of the evaluation CLI
TURNTABLE_VIEWS = 8
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


def slice_config():
    """The serving and fit slices' model: configs/one_shot.yaml's widths in
    fp32, with the narrow rgb colour offset (bench.py's fit workload)."""
    from guassianhand_tpu_torch.models.one_shot import OneShotConfig
    return OneShotConfig(narrow_color_b=True)


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


def check_plan(tile_range, n_pairs: int) -> tuple:
    """The chunk plan, the card's kernel against its twin: (items and slot
    bases equal, the twin's item count, its checkpoint slots)."""
    from guassianhand_tpu_torch.ops import rasterize_cuda as rc
    got = rc.chunk_plan(tile_range, n_pairs)
    want = rc.chunk_plan_plain(tile_range, n_pairs)
    items = int(want.n_items)
    equal = bool(int(got.n_items) == items
                 and torch.equal(got.items[:items], want.items[:items])
                 and torch.equal(got.slot_base, want.slot_base))
    return equal, items, int(want.slot_base[-1])


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

    plan_equal, plan_items, n_slots = check_plan(tr, n_pairs)

    # K1, training mode
    rgb_r, t_r = rc.composite_forward(tr, gid, attrs, **kw)
    rgb_k, t_k, nc_k, ck_k, sb_k = rc.composite_forward(
        tr, gid, attrs, **kw, store_contrib=True)
    rgb_p, t_p, nc_p, ck_p, sb_p, fwd_ops = rc.composite_plain(
        tr, gid, attrs, **kw, store_contrib=True, count_ops=True)
    bit_identical = bool(torch.equal(rgb_r, rgb_k) and torch.equal(t_r, t_k))
    mismatch = nc_k != nc_p
    contrib_mismatch = int(mismatch.sum())
    mismatch_pixels = [[int(i) for i in ij] + [int(nc_k[tuple(ij)]),
                                               int(nc_p[tuple(ij)]),
                                               float(t_k[tuple(ij)]),
                                               float(t_p[tuple(ij)])]
                       for ij in mismatch.nonzero()[:8].tolist()]
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
           # [y, x, n_contrib kernel, twin, final T kernel, twin]
           "n_contrib_mismatch_pixels": mismatch_pixels,
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
                   f"{contrib_mismatch} pixels: {mismatch_pixels}")
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


def phase_render_100k(info: dict) -> dict:
    """BASELINE.json config #2 through cli/render_100k.py at full size (8
    orbit views at 512^2 of the posed two-hand scene's 55,400 decoration
    Gaussians, one rasterize_multiview call a render), the launch counts
    zeroed just before the tool's run and read just after: K1 in render
    mode and its plan once a render (a warm-up and 5 timed), nothing else;
    overflow 0 and n 55,400. A render profiled (device busy, top kernels).
    Then K1 and its plan against their twins on the tool's stacked canvas
    (all its views), and the same scene with
    projection_impl="pallas": one launch of K4 projects all 8 views, its
    forward and adjoint equal to their twins to the bit."""
    from guassianhand_tpu_torch.cli import render_100k
    from guassianhand_tpu_torch.core.camera import Camera
    from guassianhand_tpu_torch.ops import rasterize_cuda as rc
    from guassianhand_tpu_torch.ops.rasterize import (RasterizeConfig,
                                                      multiview_composite_inputs)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    line, run = render_100k.run(RENDER_100K_VIEWS)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    tool_s = time.perf_counter() - t0
    g, w2cs, Ks, hw, out = (run[k] for k in ("gaussians", "w2cs", "Ks", "hw",
                                             "out"))
    renders = 1 + render_100k.FULL["reps"]
    want = {k: renders * (k in SERVE_DEFAULT) for k in launches}
    busy_ms, top = device_profile(lambda: render_100k.render(g, w2cs, Ks, hw))
    mask = out["comp_mask"]
    row = {**line, "n": g.n, "views": RENDER_100K_VIEWS, "canvas": [
        RENDER_100K_VIEWS * hw, hw], "peak_bytes": peak,
        "launches": {k: v for k, v in launches.items() if v},
        "renders": renders, "tool_s": tool_s,
        "device_busy_ms_profiled_render": busy_ms,
        "device_busy_share": busy_ms / (line["ms_per_view"]
                                        * RENDER_100K_VIEWS),
        "top_device_ms": top, "comp_mask_mean": float(mask.mean()),
        "finite": bool(torch.isfinite(out["comp_rgb"]).all()),
        "card": info["nvidia_smi"]}
    log("render_100k_512", **row)
    if g.n != 55_400 or line["overflow"] != 0 or launches != want \
            or not row["finite"] or not 0.0 < row["comp_mask_mean"] < 1.0:
        raise AssertionError(f"render_100k at full size: {row}, launches "
                             f"wanted {want}")

    t1 = time.perf_counter()
    inputs = multiview_composite_inputs(g, w2cs, Ks, height=hw, width=hw,
                                        use_rgb=True)
    composite = check_composite("render_100k_512", inputs, reps=5)
    tr, n_pairs = inputs.tile_range, inputs.pair_gid.shape[0]
    plan_equal, plan_items, _ = check_plan(tr, n_pairs)
    plan_ms = time_cuda(lambda: rc.chunk_plan(tr, n_pairs), reps=20)
    plan_plain_ms = time_cuda(lambda: rc.chunk_plan_plain(tr, n_pairs),
                              reps=2, warmup=1)
    twin_s = time.perf_counter() - t1
    log("render_100k_512_twins", seconds=twin_s, plan_equal=plan_equal,
        plan_items=plan_items,
        plan_ms=plan_ms, plan_plain_ms=plan_plain_ms,
        plan_bound_ms=bound(8 * tr.numel() + 4 + 16 * plan_items, 0)[
            "bound_ms"])
    if not plan_equal:
        raise AssertionError("the chunk plan differs from its twin's at "
                             "render_100k_512")
    del inputs

    zero_launches()
    pallas = render_100k.render(g, w2cs, Ks, hw,
                                RasterizeConfig(projection_impl="pallas"))
    torch.cuda.synchronize()
    k4_launches = read_launches()
    # K4 rounds apart from the plain projection of the default route, so a
    # rect may gain or lose a tile: the two renders are logged side by side
    apart = float((pallas["comp_rgb"] - out["comp_rgb"]).abs().max())
    want = {k: int(k in SERVE_DEFAULT + ("project_forward",))
            for k in k4_launches}
    if k4_launches != want or pallas["overflow"] != 0:
        raise AssertionError(f"render_100k with projection_impl=pallas: "
                             f"launches {k4_launches}, not {want}")
    cams = [Camera.from_w2c(w2cs[i], Ks[i], hw, hw, device="cuda")
            for i in range(RENDER_100K_VIEWS)]
    views = check_projection_views(
        "render_100k_8_views", *(t.contiguous() for t in (
            g.xyz, g.scaling, g.rotation)), cams)
    log("render_100k_512_pallas", launches={
        k: c for k, c in k4_launches.items() if c},
        rgb_max_abs_apart_from_default_route=apart,
        n_pairs=pallas["n_pairs"], n_pairs_default_route=line["n_pairs"],
        seconds=time.perf_counter() - t0)
    return {"launches": launches, "line": line, "composite": composite,
            "plan_ms": plan_ms, "plan_plain_ms": plan_plain_ms,
            "views": views, "twin_s": twin_s, "seconds":
            time.perf_counter() - t0}


def kernels_at_512(r100k: dict, fit512: dict, request512: dict) -> dict:
    """Each kernel's numbers at the 512^2 scenes, for the kernel table:
    by kernel, then by scene, its ms, its twin's, its bound and its largest
    error against the twin (None where the check is bitwise or exact)."""
    def k1(row):
        return {"ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "n_pairs": row["n_pairs"],
                "max_tile_pairs": row["max_tile_pairs"],
                "max_abs_err": max(row["max_abs_err_rgb"],
                                   row["max_abs_err_final_t"])}

    def views(row):
        return {"views": row["views"], "ms": row["fwd_ms"],
                "bound_ms": row["fwd_bound"]["bound_ms"],
                "single_launches_ms": row["fwd_single_launches_ms"],
                "adjoint_ms": row["bwd_ms"],
                "adjoint_bound_ms": row["bwd_bound"]["bound_ms"],
                "bit_equal": not any(row["apart"].values())}

    g, p = fit512["gradients"], fit512["projection"]
    return {
        "composite_forward": {
            "render_100k_512": k1(r100k["composite"]),
            "request_512_flagship_bf16": k1(request512["composite"]),
            "fit_512_train": {
                "ms": g["k1_train_ms"], "plain_ms": g["k1_train_plain_ms"],
                "bound_ms": g["k1_train_bound_ms"],
                "bound_by": g["k1_train_bound_by"], "n_pairs": g["n_pairs"],
                "n_contrib_mismatch": g["n_contrib_mismatch"],
                "max_abs_err": g["checkpoints_max_abs_err"]}},
        "composite_plan": {
            "render_100k_512": {"ms": r100k["plan_ms"],
                                "plain_ms": r100k["plan_plain_ms"]},
            "fit_512": {"ms": g["plan_ms"], "plain_ms": g["plan_plain_ms"],
                        "bound_ms": g["plan_bound_ms"],
                        "items": g["plan_items"], "equal": g["plan_equal"]}},
        "composite_backward": {"fit_512": {
            "ms": g["k2_ms"], "plain_ms": g["k2_plain_ms"],
            "bound_ms": g["k2_bound_ms"], "bound_by": g["k2_bound_by"],
            "checkpoints": g["checkpoints"],
            "bit_reproducible": g["k2_bit_reproducible"],
            "max_abs_err": g["pair_rows_max_abs_err"]}},
        "segment_reduce_sorted": {"fit_512": {
            "ms": g["k3_ms"], "plain_ms": g["k3_plain_ms"],
            "bound_ms": g["k3_bound_ms"], "bound_by": g["k3_bound_by"],
            "library_ms": g["k3_library_ms"],
            "bit_reproducible": g["k3_bit_reproducible"],
            "max_abs_err": max(v["max_abs_err"]
                               for v in g["segment_reduce"].values())}},
        "project_forward": {
            "render_100k_512": views(r100k["views"]),
            "request_512_flagship_bf16": views(request512["views"]),
            "fit_512": {"ms": p["fwd_ms"], "plain_ms": p["fwd_plain_ms"],
                        "bound_ms": p["fwd_bound"]["bound_ms"],
                        "max_abs_err": max(p[f"{k}_max_abs_err"] for k in
                                           ("mean2d", "depth", "conic"))}},
        "project_backward": {"fit_512": {
            "ms": p["bwd_ms"], "plain_ms": p["bwd_plain_ms"],
            "bound_ms": p["bwd_bound"]["bound_ms"],
            "max_abs_err": max(p[f"grad_{k}_max_abs_err"] for k in
                               ("xyz", "scaling", "rotation"))}}}


def seeded_vgg19_file(path: Path) -> Path:
    """train/vgg.py's seeded VGG19 weights as a torchvision state dict at
    ``path``, for a CLI's ``vgg_weights`` (the CLIs leave the VGG term out
    without weights)."""
    from guassianhand_tpu_torch.train import vgg
    sd = {}
    for (name, _, _), (w, b) in zip(vgg._CONV_PLAN, vgg._random_params()):
        sd[f"{name}.weight"] = torch.from_numpy(w)
        sd[f"{name}.bias"] = torch.from_numpy(b)
    torch.save(sd, path)
    return path


def cli_steps(module, steps: int):
    """A context that wraps the ``make_fit_step`` of a CLI ``module`` so
    that the CLI's own fit of 2 + ``steps`` steps is measured: the first
    step a warm-up, the next ``steps`` timed with the device synchronised
    (wall ms, the loss, the launches of each step, the peak bytes over
    them), the last under torch.profiler (device busy ms, top kernels).
    Yields the record, which also keeps the model and the batch."""
    make = module.make_fit_step
    rec = {"ms": [], "losses": [], "per_step": []}

    def make_measured(model, *args, **kwargs):
        step = make(model, *args, **kwargs)
        rec["model"] = model

        def measured(batch):
            rec["batch"] = batch
            i = len(rec["per_step"])
            if i == steps + 1:
                out = []
                rec["busy_ms"], rec["top"] = device_profile(
                    lambda: out.append(step(batch)))
                rec["per_step"].append(None)
                return out[0]
            torch.cuda.synchronize()
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            counts = read_launches()
            t = time.perf_counter()
            loss, err = step(batch)
            torch.cuda.synchronize()
            if i == 0:
                rec["warmup_loss"] = float(loss)
            else:
                rec["ms"].append((time.perf_counter() - t) * 1e3)
                rec["losses"].append(float(loss))
            rec["per_step"].append({k: v - counts[k]
                                    for k, v in read_launches().items()})
            if i == steps:
                rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            return loss, err
        return measured

    @contextlib.contextmanager
    def wrapped():
        module.make_fit_step = make_measured
        try:
            yield rec
        finally:
            module.make_fit_step = make
    return wrapped()


def phase_fit_512(info: dict, out_dir: str) -> dict:
    """The flagship (configs/one_shot.yaml, both switches) fitted at 512^2
    on the synthetic scene subdivided twice (15,404 points, 30,808 Gaussian
    slots), VGG 0.1 with seeded VGG19 weights: cli/fit_one_shot.py
    --synthetic --height 512 --width 512 --subdivide 2 for 2 + FIT_STEPS
    steps, measured inside the CLI (``cli_steps``: a warm-up, FIT_STEPS
    timed steps with their wall ms, peak bytes, launches and losses, one
    profiled step's device busy ms), with the launch counts zeroed just
    before the CLI and read just after (each step one launch of each fit
    kernel and the bf16 K5's three, and nothing else; each forward the CLI
    renders besides one of K1, its plan, K4's forward and the bf16 K5's
    forward, the synthetic target one of K1, its plan and K4's forward);
    the loss falling over the timed steps and in the CLI's log. Then K1 in
    training mode, its plan, K2, K3 and K4 both ways against their twins
    at the fitted model's inputs."""
    from guassianhand_tpu_torch.cli import fit_one_shot
    t0 = time.perf_counter()
    vgg_path = seeded_vgg19_file(Path(out_dir) / "vgg19_seeded.pth")
    n_steps = FIT_STEPS + 2
    zero_launches()
    with flash_switch(True), cli_steps(fit_one_shot, FIT_STEPS) as rec:
        rc, said = run_quiet(fit_one_shot.main, [
            "--config", str(REPO / "configs" / "one_shot.yaml"),
            "--synthetic", "--height", str(HW512), "--width", str(HW512),
            "--subdivide", "2", "--steps", str(n_steps),
            f"out_dir={out_dir}", "expname=fit512",
            f"vgg_weights={vgg_path}",
            "model.renderer.raster.projection_impl=pallas"])
        cli_s = time.perf_counter() - t0
        cli_launches = read_launches()
        if rc != 0 or "perceptual term is off" in said:
            raise AssertionError(f"the 512^2 fit CLI: rc {rc}:\n"
                                 f"{said[-2000:]}")
        model, batch = rec["model"], rec["batch"]
        captured = kernel_inputs(model, batch, HW512)
    # the synthetic target is rendered too: K1, its plan and K4's forward
    target = SERVE_DEFAULT + ("project_forward",)
    want = {k: n_steps + cli_fit_forwards(n_steps) * (k in SERVE_FLAGSHIP)
            + (k in target) for k in FIT_KERNELS + FLASH_BF16}
    off = {k: v for k, v in cli_launches.items() if v != want.get(k, 0)}
    step_off = [i for i, per in enumerate(rec["per_step"]) if per and any(
        v != int(k in FIT_KERNELS + FLASH_BF16) for k, v in per.items())]
    cli_losses = [json.loads(ln)["loss"] for ln in
                  (Path(out_dir) / "fit512" / "metrics.jsonl")
                  .read_text().splitlines()]
    losses = rec["losses"]
    if off or step_off:
        raise AssertionError(f"the 512^2 fit CLI: launches {off} not {want}; "
                             f"steps {step_off} off: {rec['per_step']}")
    if not (all(math.isfinite(x) for x in losses + cli_losses)
            and losses[-1] < rec["warmup_loss"]
            and cli_losses[-1] < cli_losses[0]):
        raise AssertionError(f"the 512^2 fit's loss did not fall: warm-up "
                             f"{rec['warmup_loss']}, timed {losses}, the "
                             f"CLI's log {cli_losses}")
    launches = {k: sum(per[k] for per in rec["per_step"][1:FIT_STEPS + 1])
                for k in cli_launches}
    ms = rec["ms"]
    inputs, gs = captured["inputs"], captured["gaussians"]
    n_points = int(batch["points"].shape[-2])
    row = {"config": "configs/one_shot.yaml", "route": "kernels",
           "hw": HW512, "n_points": n_points, "gaussian_slots": 2 * n_points,
           "vgg": 0.1, "pairs": captured["n_pairs"],
           "live_rows_k5": int(captured["attention"][3].sum()),
           "cli_s": cli_s, "cli_losses": cli_losses,
           "cli_launches": {k: v for k, v in cli_launches.items() if v},
           "launches_per_step": {k: v // FIT_STEPS
                                 for k, v in launches.items() if v},
           "steps": FIT_STEPS, "ms_per_step": ms,
           "ms_per_step_mean": float(np.mean(ms)),
           "device_busy_ms_profiled_step": rec["busy_ms"],
           "device_busy_share": rec["busy_ms"] / float(np.mean(ms)),
           "peak_bytes": rec["peak_bytes"],
           "warmup_loss": rec["warmup_loss"], "losses": losses,
           "top_device_ms": rec["top"], "card": info["nvidia_smi"]}
    log("fit_512_bf16", **row)
    if n_points != 15_404:
        raise AssertionError(f"the 512^2 fit's scene: {row}")
    grads = check_gradients("fit_512", inputs, reps=5)
    proj = check_projection("fit_512", gs.xyz.contiguous(),
                            gs.scaling.contiguous(), gs.rotation.contiguous(),
                            captured["camera"], reps=5)
    return {"launches": launches, "row": row, "gradients": grads,
            "projection": proj, "seconds": time.perf_counter() - t0}


def phase_request_512(info: dict) -> dict:
    """One request of the flagship (configs/one_shot.yaml, both switches):
    one pose in VIEWS orbit views at 512^2 through OneShotAvatarModel
    (``phase_slice`` with hw 512, one request after a warm-up, its batch
    and model ms, a profiled request's device busy time); then K1 in render
    mode against its twin on the request's stacked canvas and K4 with its
    VIEWS cameras (one launch) against its twins, to the bit."""
    from guassianhand_tpu_torch.core.camera import Camera
    t0 = time.perf_counter()
    inputs, launches, request = phase_slice(
        kernels=True, model_cfg=flagship_config(),
        route="request_512_flagship_bf16", want=SERVE_FLAGSHIP, hw=HW512,
        requests=1)
    composite = check_composite("request_512", inputs, reps=5)
    del inputs
    req = request["gaussians"]
    views = check_projection_views(
        "request_512_4_views", *(t.contiguous() for t in (
            req.xyz, req.scaling, req.rotation)),
        [Camera.from_w2c(w, k, HW512, HW512, device="cuda")
         for w, k in zip(request["w2cs"], request["Ks"])], reps=5)
    r, prof = request["rows"][0], request["profile"]
    log("request_512_bf16", config="configs/one_shot.yaml", hw=HW512,
        views=VIEWS, batch_ms=r["batch_ms"], model_ms=r["model_ms"],
        device_busy_ms=prof["device_busy_ms"],
        device_busy_share=prof["device_busy_share"],
        features_ms=prof["features_ms"], n_pairs=r["n_pairs"],
        peak_bytes=request["peak_bytes"],
        launches={k: v for k, v in launches.items() if v},
        seconds=time.perf_counter() - t0, card=info["nvidia_smi"])
    return {"launches": launches, "composite": composite, "views": views,
            "row": r, "seconds": time.perf_counter() - t0}


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
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import no_tf32
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    batch = synthetic_batch(scene, seed=0, with_target=True)
    bf16 = dataclasses.replace(slice_config(), compute_dtype="bfloat16")
    arms = {"fp32": slice_config(), "bf16": bf16,
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


def edit_config():
    """configs/one_shot_edit.yaml: the flagship's model (its bf16 pipeline)
    and its edit flags."""
    from guassianhand_tpu_torch.config import load_config
    cfg = load_config(str(REPO / "configs" / "one_shot_edit.yaml"))
    if cfg.model != flagship_config() or not cfg.edit.enabled:
        raise AssertionError(f"configs/one_shot_edit.yaml no longer extends "
                             f"the flagship model with an edit: {cfg}")
    return cfg


def phase_edit(info: dict, out_dir: str) -> dict:
    """The texture-edit fit at full width: configs/one_shot_edit.yaml's
    model with both kernel switches on, the fit scene (15,404 points,
    256^2), the codebook's identity 0 and the config's EditConfig, through
    the edit CLI's own step (cli/edit.py::make_edit_step: lr 0.001, no
    VGG); ``timed_steps`` over EDIT_STEPS steps (each launches each fit
    kernel and the bf16 K5's three once, and the loss falls). Then
    ``cli/edit.py`` end to end for 2 steps into ``out_dir``, which must
    write its first render and its checkpoint. Returns the model, the
    launches, the row and the CLI's run directory."""
    from guassianhand_tpu_torch.cli import edit as edit_cli
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model
    cfg = edit_config()
    model_cfg = kernel_config(cfg.model, True)
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    model = build_model(model_cfg, seed=0, device="cuda")
    step, batch, _, _, _ = edit_cli.make_edit_step(
        model, synthetic_batch(scene, seed=0, with_target=True),
        edit_cli.edit_fit_config(1000), cfg.edit, 0, height=HW, width=HW)
    with flash_switch(True):
        run = timed_steps("edit", step, batch, EDIT_STEPS)
    row = {"config": "configs/one_shot_edit.yaml", "route": "kernels",
           "edit": dataclasses.asdict(cfg.edit), "identity_from_book": 0,
           "n_points": scene.n_points, **run, "card": info["nvidia_smi"]}
    log("edit", **row)
    launches = run["launches"]
    t0 = time.perf_counter()
    with flash_switch(True):
        rc = edit_cli.main([
            "--config", str(REPO / "configs" / "one_shot_edit.yaml"),
            "--steps", "2", "--left-only", "--duplication", "--identity", "1",
            f"out_dir={out_dir}", "expname=chip",
            "model.renderer.raster.projection_impl=pallas"])
    run_dir = Path(out_dir) / "chip_edit"
    wrote = {name: (run_dir / name).is_file()
             for name in ("vis/edit0000.png", "ckpts/edit.ckpt")}
    log("edit_cli", rc=rc, seconds=time.perf_counter() - t0, wrote=wrote)
    if rc != 0 or not all(wrote.values()):
        raise AssertionError(f"cli/edit.py: rc {rc}, wrote {wrote}")
    return {"model": model, "launches": launches, "row": row,
            "run_dir": run_dir}


def timed_steps(label: str, step, batch, steps: int) -> dict:
    """One warm-up step of ``step`` on ``batch`` (under the caller's flash
    switch), then ``steps`` steps with the launch counts zeroed just before
    and read just after: each step must launch K1 in training mode, its
    plan, K2, K3, K4 both ways and the bf16 K5's three kernels once, and
    nothing else, and the loss must be finite and fall below the warm-up's.
    Returns the step times, losses, launches, peak bytes and one profiled
    step's device busy time and top kernels."""
    want = FIT_KERNELS + FLASH_BF16
    warmup_loss = float(step(batch)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    ms, losses = [], []
    for i in range(steps):
        counts = read_launches()
        t = time.perf_counter()
        loss, _ = step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        per = {k: v - counts[k] for k, v in read_launches().items()}
        off = {k: v for k, v in per.items() if v != int(k in want)}
        if off:
            raise AssertionError(f"{label} step {i}: launches {off} where "
                                 f"each of {want} launches once: {per}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    busy_ms, top = device_profile(lambda: step(batch))
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < warmup_loss:
        raise AssertionError(f"{label}: the loss did not fall: "
                             f"{warmup_loss} then {losses}")
    return {"steps": steps, "ms_per_step": ms,
            "ms_per_step_mean": float(np.mean(ms)),
            "device_busy_ms_profiled_step": busy_ms,
            "device_busy_share": busy_ms / float(np.mean(ms)),
            "peak_bytes": peak, "warmup_loss": warmup_loss, "losses": losses,
            "launches": launches, "top_device_ms": top}


def phase_edit_reference() -> None:
    """The small model of phase_reference with both kernel switches on, on
    the card and on the CPU with the same weights, its per-identity maps
    set from a seed (so that the edit flags change the render), the
    codebook's identity 3 and each of the edit flags: rgb and mask agree
    within the 1e-4 phase_reference holds."""
    from guassianhand_tpu_torch.cli.render_360 import (orbit_batch,
                                                       render_request)
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model, no_tf32
    from guassianhand_tpu_torch.render.renderer import EditConfig
    cfg = kernel_config(reference_config(), True)
    hw = REF_HW
    scene = SyntheticHandScene.build(n_vertices=96, subdivide=1, height=hw,
                                     width=hw, device="cpu")
    batch = orbit_batch(scene, synthetic_batch(scene, seed=0), 0, 2, 2)
    cpu = build_model(cfg, seed=0, device="cuda").to("cpu")
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p, scale, base in ((cpu.color_w, 0.2, 1.0), (cpu.color_b, 0.3, 0),
                               (cpu.opacity_b, 0.1, 0)):
            p.copy_(base + scale * torch.randn(p.shape, generator=gen))
    card = build_model(cfg, seed=0, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rows = {}
    for flags in (EditConfig(enabled=True, edit_left_only=True),
                  EditConfig(enabled=True, duplication=True),
                  EditConfig(enabled=True, edit_left_only=True,
                             duplication=True)):
        outs = {}
        with flash_switch(True):
            for device, model in (("cuda", card), ("cpu", cpu)):
                b = {k: v.to(device) for k, v in batch.items()}
                with torch.inference_mode(), no_tf32():
                    outs[device] = model(b, hw, hw, edit=flags,
                                         identity_from_book=3)
        name = "+".join(k for k, v in dataclasses.asdict(flags).items()
                        if v and k != "enabled")
        rows[name] = {k: float((outs["cuda"][k].cpu() - outs["cpu"][k])
                               .abs().max())
                      for k in ("comp_rgb", "comp_mask")}
    log("edit_reference", identity_from_book=3, cuda_vs_cpu_max_abs=rows)
    bad = {k: v for k, v in rows.items() if max(v.values()) > 1e-4}
    if bad:
        raise AssertionError(f"card and CPU edit renders disagree: {bad}")


EVAL_KEYS = ("psnr", "ssim", "mse", "eval_frames", "eval_frames_per_s",
             "device_peak_bytes", "weights_provenance")


def phase_eval(info: dict, edit: dict, out_dir: str) -> dict:
    """The evaluation path of the edited avatar: ``cli/fit_one_shot.py
    --run_val --synthetic --val_frames EVAL_FRAMES --no_images`` under
    configs/one_shot_edit.yaml with both switches, from the checkpoint
    phase_edit's CLI run wrote, with the launch counts zeroed just before
    and read just after: each frame launches K1 in render mode, its plan
    and K4's forward twice (its synthetic target's render and the model's)
    and the bf16 K5's forward once, and nothing else. Its test_metrics.yml
    must hold EVAL_KEYS and no lpips (no LPIPS weights). Then
    ``cli/render_360.py --ckpt`` renders TURNTABLE_VIEWS views of it, the
    model call of the eval's first frame is timed, and train/metrics.ssim
    and train/lpips.LPIPS (seeded random AlexNet) score that frame on the
    card and on the CPU, within 1e-5."""
    import yaml
    from guassianhand_tpu_torch.cli import fit_one_shot, render_360
    from guassianhand_tpu_torch.data.synthetic import SyntheticHandScene
    from guassianhand_tpu_torch.models.one_shot import no_tf32
    from guassianhand_tpu_torch.train import checkpoints, lpips, metrics
    cfg_path = str(REPO / "configs" / "one_shot_edit.yaml")
    run_dir = edit["run_dir"]
    switches = "model.renderer.raster.projection_impl=pallas"
    zero_launches()
    t0 = time.perf_counter()
    with flash_switch(True):
        rc = fit_one_shot.main([
            "--config", cfg_path, "--run_val", "--synthetic", "--val_frames",
            str(EVAL_FRAMES), "--no_images", f"out_dir={out_dir}",
            f"expname={run_dir.name}", switches])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"cli/fit_one_shot.py --run_val: rc {rc}")
    # a frame renders its synthetic target (K1, its plan, K4) and the model
    want = {k: EVAL_FRAMES * (1 + (k != "flash_forward_bf16"))
            for k in SERVE_FLAGSHIP}
    off = {k: v for k, v in launches.items() if v != want.get(k, 0)}
    if off:
        raise AssertionError(f"the evaluation launched {off}, not {want}: "
                             f"{launches}")
    scores = yaml.safe_load((run_dir / "test_metrics.yml").read_text())
    missing = [k for k in EVAL_KEYS if k not in scores]
    if missing or "lpips" in scores or scores["eval_frames"] != EVAL_FRAMES \
            or not all(math.isfinite(scores[k]) for k in ("psnr", "ssim",
                                                          "mse")):
        raise AssertionError(f"test_metrics.yml: missing {missing}: {scores}")

    t1 = time.perf_counter()
    frames = Path(out_dir) / "turntable"
    with flash_switch(True):
        rc, said = run_quiet(render_360.main, [
            "--config", cfg_path, "--ckpt", str(run_dir / "ckpts" /
                                                "last.ckpt"),
            "--views", str(TURNTABLE_VIEWS), "--views_per_call", str(VIEWS),
            f"--out={frames}", switches])
    turntable_s = time.perf_counter() - t1
    written = sorted(p.name for p in frames.glob("*.png"))
    turntable = json.loads(said.strip().splitlines()[-1])
    if rc != 0 or len(written) != TURNTABLE_VIEWS \
            or not (frames / "turntable.gif").is_file():
        raise AssertionError(f"cli/render_360.py --ckpt: rc {rc}, frames "
                             f"{written}, {turntable}")

    # one of the eval's frames, scored on the card and on the CPU
    cfg = edit_config()
    model = edit["model"]
    checkpoints.load_checkpoint(str(run_dir / "ckpts" / "last.ckpt"), model)
    scene = SyntheticHandScene.build(
        n_vertices=778, subdivide=min(cfg.data.edge_subdivide, 1),
        height=HW, width=HW, device="cuda")
    batch = next(fit_one_shot.eval_batches(scene, cfg, EVAL_FRAMES))
    with flash_switch(True), torch.inference_mode(), no_tf32():
        pred = model(batch, HW, HW)["comp_rgb"][0, 0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(3):
            model(batch, HW, HW)
        torch.cuda.synchronize()
        model_ms = (time.perf_counter() - t2) * 1e3 / 3
        tgt = batch["target_rgb"][0]
        crops = [metrics.bbox_crop(x, batch["mask_at_box"])
                 for x in (pred, tgt)]
        lp = lpips.LPIPS()
        card = {"ssim": float(metrics.ssim(*crops)),
                "lpips": float(lpips.lpips_from_01(lp.cuda(), pred[None],
                                                   tgt[None]))}
        host = {"ssim": float(metrics.ssim(*(c.cpu() for c in crops))),
                "lpips": float(lpips.lpips_from_01(lp.cpu(), pred.cpu()[None],
                                                   tgt.cpu()[None]))}
    diff = {k: abs(card[k] - host[k]) for k in card}
    row = {"config": "configs/one_shot_edit.yaml", "route": "kernels",
           "frames": EVAL_FRAMES, "cli_seconds": seconds,
           "ms_per_frame": 1e3 / scores["eval_frames_per_s"],
           "model_ms_per_frame": model_ms, "n_points": scene.n_points,
           "metrics": scores, "launches": launches,
           "turntable_views": TURNTABLE_VIEWS, "turntable_seconds": turntable_s,
           "turntable_points": turntable["n_points"],
           "turntable_video": Path(turntable["video"]).name,
           "metrics_card": card, "metrics_cpu": host,
           "card_vs_cpu_abs": diff, "card": info["nvidia_smi"]}
    log("eval", **row)
    # the turntable renders the config's scene, which the checkpoint was
    # fitted on and the evaluation scores
    if turntable["n_points"] != scene.n_points:
        raise AssertionError(f"cli/render_360.py rendered "
                             f"{turntable['n_points']} points, not "
                             f"{scene.n_points}")
    if max(diff.values()) > 1e-5:
        raise AssertionError(f"ssim or LPIPS on the card and the CPU "
                             f"disagree: {row}")
    return {"launches": launches, "row": row}


IH_TEST_FRAMES = 14   # data.pose_sequence=oneshot_reg_i's length
IH_FLIP_SHARE = 0.02  # card vs CPU: the interaction mask's flips at most


def interhand_layout():
    """tests/torch_interhand_layout.py (the fake layout's writer and the
    reference checkpoint's helpers), loaded from its file: another package
    named ``tests`` may stand before the repo's on the path."""
    import importlib.util
    path = REPO / "tests" / "torch_interhand_layout.py"
    spec = importlib.util.spec_from_file_location("torch_interhand_layout",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_quiet(fn, *args) -> tuple:
    """(fn(*args), what it printed): the printout is kept, not shown."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def phase_interhand_checkpoint(cfg, root: Path) -> tuple:
    """A reference-layout checkpoint of the seeded full-width model of
    ``cfg`` (seed 0, every tensor with seeded noise of 1e-3:
    ``interhand_layout().add_noise``)
    through cli/port_checkpoint.py: no key may be unmapped; loaded by
    ``pretrained:``'s loader into a model of seed 1, every tensor it
    carries must equal the seed-0 model's to the bit, the missing ones be
    only the identity-code head, ``restored N/M`` count the avatar's
    tensors, and the point-cloud generator's keys be reported absent from
    the avatar. Returns the reference checkpoint and the ported one."""
    from guassianhand_tpu_torch.cli import port_checkpoint
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.train.checkpoints import load_params_partial
    t0 = time.perf_counter()
    # noise small enough to leave the Gaussians as the seeded model makes
    # them (0.05 on the heads' biases blows every splat up 30-fold in pairs)
    helpers = interhand_layout()
    source = helpers.add_noise(
        build_model(cfg.model, seed=0, device="cuda"), 0, scale=1e-3)
    ref = helpers.reference_state_dict(source)
    src, out = root / "pretrain_model.ckpt", root / "pretrain_model.port.ckpt"
    torch.save({"state_dict": ref}, src)
    rc, said = run_quiet(port_checkpoint.main, [
        "--torch_ckpt", str(src), "--out", str(out)])
    unmapped = sorted(line.strip() for line in said.splitlines()
                      if line.startswith("  "))
    generator = sorted(k.removeprefix("model.") for k in ref
                       if k.startswith("model.pointcloud_generator."))
    n_ported = len(ref) - len(generator)
    absent = f"skipped: pointcloud_generator (absent, {len(generator)} " \
             f"tensors)"
    target = build_model(cfg.model, seed=1, device="cuda")
    got, loaded = run_quiet(load_params_partial, str(out), target)
    own = target.state_dict()
    want = source.state_dict()
    unequal = [k for k in got["restored"] if not torch.equal(own[k], want[k])]
    bad_missing = [k for k in got["missing"]
                   if not k.startswith("identity_code_infer.")]
    log("interhand_checkpoint", seconds=time.perf_counter() - t0,
        source_bytes=src.stat().st_size, ported_bytes=out.stat().st_size,
        source_keys=len(ref), ported=n_ported, unmapped=len(unmapped),
        restored_line=loaded.strip(), missing=got["missing"],
        unequal=unequal)
    if rc != 0 or unmapped or f"ported {len(ref)} tensors" not in said:
        raise AssertionError(f"cli/port_checkpoint.py: rc {rc}, unmapped "
                             f"{unmapped}: {said!r}")
    if f"restored {n_ported}/{len(own)} " not in loaded or unequal \
            or bad_missing or absent not in loaded:
        raise AssertionError(f"pretrained load: {loaded!r}, unequal "
                             f"{unequal}, missing {got['missing']}")
    return src, out


def phase_interhand_fit(cfg, ported: Path, info: dict) -> dict:
    """The fit cli/fit_one_shot.py runs on InterHand2.6M, from its own
    pieces: the train split's one-shot frame, the seeded model with the
    ported checkpoint over it, the config's FitConfig (no VGG: no VGG19
    weights, as the CLI runs without them), the static prefix cache where
    the config asks for it; ``timed_steps`` over FIT_STEPS steps, for the
    step's time and device share (the CLI times no step; its launches are
    checked in phase_interhand_cli). Returns the launches and the kernels'
    inputs at the fitted model."""
    from guassianhand_tpu_torch.cli.fit_one_shot import interhand_dataset
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.train.checkpoints import load_params_partial
    from guassianhand_tpu_torch.train.fit import (attach_static_features,
                                                  make_fit_step,
                                                  make_optimizer)
    t0 = time.perf_counter()
    dataset = interhand_dataset(cfg, "train", "cuda", HW, HW)
    t1 = time.perf_counter()
    batch = dataset.load_sample(0)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t1) * 1e3
    model = build_model(cfg.model, seed=cfg.seed, device="cuda")
    run_quiet(load_params_partial, str(ported), model)
    optimizer, scheduler = make_optimizer(model, cfg.fit)
    step = make_fit_step(model, None, optimizer, scheduler, cfg.fit,
                         height=HW, width=HW)
    if cfg.fit.static_prefix_cache:
        batch = attach_static_features(model, batch)
    with flash_switch(True):
        run = timed_steps("InterHand fit", step, batch, FIT_STEPS)
        captured = kernel_inputs(model, batch)
    mask = captured["attention"][3]
    row = {"config": "configs/one_shot.yaml", "route": "kernels",
           "decoder": dataset.decoder, "setup_s": t1 - t0,
           "load_sample_ms": load_ms,
           "n_points": int(batch["points"].shape[1]),
           "gaussian_slots": 2 * int(batch["points"].shape[1]),
           "live_rows_k5": int(mask.sum()), "pairs": captured["n_pairs"],
           "target_mask_mean": float(batch["target_mask"].mean()),
           **run, "card": info["nvidia_smi"]}
    log("interhand_fit", **row)
    return {"launches": run["launches"], "row": row, **captured}


def load_sample_stages(dataset, indices) -> dict:
    """The mean ms a frame of load_sample's stages over ``indices``, each
    run as load_sample runs it and synchronised after: the index and
    annotation pickles, the images (decode, masks, hole filling), the MANO
    parameters, LBS and subdivision of both hands in the frame's pose and
    in the T-pose, the kNN interaction mask, and the box mask on the host
    (``get_mask_at_box``)."""
    import pickle
    from guassianhand_tpu_torch.data.rays import (bounds_from_points,
                                                  get_mask_at_box)
    from guassianhand_tpu_torch.ops.knn import interaction_mask
    totals = dict.fromkeys(("pickles", "images", "mano_params", "posing",
                            "knn_mask", "box_mask"), 0.0)

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        totals[name] += (time.perf_counter() - t) * 1e3
        return out

    base = Path(dataset.cfg.data_root) / dataset.cfg.mode / "annotation"
    for i in indices:
        rec = timed("pickles", lambda: dataset._index_record(i))
        c, f, cam = rec["capture"], rec["frame"], rec["cam"]
        anno = timed("pickles", lambda: pickle.loads((
            base / f"capture{c}/cam{cam}/frame{f}.pkl").read_bytes()))
        img, _, _ = timed("images", lambda: dataset._load_images(c, cam, f))
        mp, mp_t = timed("mano_params", lambda: (
            dataset._mano_params(c, f), dataset._mano_params(c, f, True)))
        points, points_t = timed("posing", lambda: (
            dataset.pose_sample(mp), dataset.pose_sample(mp_t)))
        timed("knn_mask", lambda: interaction_mask(points, points_t))
        cam_ = anno["camera"]
        timed("box_mask", lambda: get_mask_at_box(
            bounds_from_points(points.cpu().numpy()),
            np.asarray(cam_["in_K"], np.float32).reshape(3, 3),
            np.asarray(cam_["R"], np.float32).reshape(3, 3),
            np.asarray(cam_["t"], np.float32).reshape(3), *img.shape[:2]))
    return {k: v / len(indices) for k, v in totals.items()}


def phase_interhand_cli(layout: dict, src: Path, ported: Path, out_dir: str,
                        info: dict) -> dict:
    """cli/fit_one_shot.py on the layout with configs/one_shot.yaml, the
    ported checkpoint and both switches: a fit of FIT_STEPS steps with the
    launch counts zeroed just before and read just after (each step
    launches each fit kernel and the bf16 K5's three once, each forward
    the CLI renders besides, ``cli_fit_forwards``, K1, its plan, K4's
    forward and the bf16 K5's forward once, and nothing else launches;
    its PLY, checkpoint and first PNG written, its logged loss falling),
    then --run_val over
    oneshot_reg_i's
    IH_TEST_FRAMES frames with the launch counts zeroed just before and
    read just after (a frame launches K1 in render mode, its plan, K4's
    forward and the bf16 K5's forward once each: its target is a decoded
    image, not a render) and test_metrics.yml with JAX's keys. The frame's
    time beside the share of it that load_sample takes and the model call
    alone. Then cli/port_and_eval.py: --dry_run exits 0 on the layout and
    2 with the fit frame's image removed, and its three stages run end to
    end for 2 steps."""
    import yaml
    from guassianhand_tpu_torch.cli import fit_one_shot, port_and_eval
    from guassianhand_tpu_torch.config import load_config
    from guassianhand_tpu_torch.models.one_shot import build_model, no_tf32
    from guassianhand_tpu_torch.train.checkpoints import load_checkpoint
    cfg_path = str(REPO / "configs" / "one_shot.yaml")
    data = [f"data.data_root={layout['data_root']}",
            f"data.annot_path={layout['annot_path']}",
            f"data.mano_models_path={layout['mano']}",
            "data.pose_sequence=oneshot_reg_i",
            "model.renderer.raster.projection_impl=pallas"]
    args = ["--config", cfg_path, f"out_dir={out_dir}", "expname=ih",
            f"pretrained={ported}"] + data
    zero_launches()
    t0 = time.perf_counter()
    with flash_switch(True):
        rc = fit_one_shot.main(args + ["--steps", str(FIT_STEPS)])
    fit_s = time.perf_counter() - t0
    fit_launches = read_launches()
    run_dir = Path(out_dir) / "ih"
    wrote = {name: (run_dir / name).exists()
             for name in ("3dgs/fitted.ply", "ckpts/last.ckpt",
                          "vis/step0000_pred.png")}
    if rc != 0 or not all(wrote.values()):
        raise AssertionError(f"the InterHand fit CLI: rc {rc}, {wrote}")
    forwards = cli_fit_forwards(FIT_STEPS)
    want = {k: FIT_STEPS + forwards * (k in SERVE_FLAGSHIP)
            for k in FIT_KERNELS + FLASH_BF16}
    off = {k: v for k, v in fit_launches.items() if v != want.get(k, 0)}
    if off:
        raise AssertionError(f"the InterHand fit CLI launched {off}, not "
                             f"{want}: {fit_launches}")
    fit_losses = [json.loads(line)["loss"] for line in
                  (run_dir / "metrics.jsonl").read_text().splitlines()]
    if not (len(fit_losses) > 1 and math.isfinite(fit_losses[-1])
            and fit_losses[-1] < fit_losses[0]):
        raise AssertionError(f"the InterHand fit CLI's loss did not fall: "
                             f"{fit_losses}")
    zero_launches()
    t1 = time.perf_counter()
    with flash_switch(True):
        rc = fit_one_shot.main(args + ["--run_val", "--no_images"])
    eval_s = time.perf_counter() - t1
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"--run_val on InterHand2.6M: rc {rc}")
    want = {k: IH_TEST_FRAMES for k in SERVE_FLAGSHIP}
    off = {k: v for k, v in launches.items() if v != want.get(k, 0)}
    if off:
        raise AssertionError(f"the InterHand evaluation launched {off}, not "
                             f"{want}: {launches}")
    scores = yaml.safe_load((run_dir / "test_metrics.yml").read_text())
    missing = [k for k in EVAL_KEYS + ("eval_wall_s",) if k not in scores]
    if missing or "lpips" in scores \
            or scores["eval_frames"] != IH_TEST_FRAMES \
            or not all(math.isfinite(scores[k]) for k in ("psnr", "ssim",
                                                          "mse")):
        raise AssertionError(f"test_metrics.yml: missing {missing}: {scores}")

    # a frame's parts: load_sample alone (and its stages), the model call
    cfg = load_config(cfg_path, data)
    dataset = fit_one_shot.interhand_dataset(cfg, "test", "cuda", HW, HW)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    frames = [dataset.load_sample(i) for i in range(len(dataset))]
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t2) * 1e3 / len(frames)
    stages = load_sample_stages(dataset, range(1, len(dataset)))
    model = build_model(cfg.model, seed=cfg.seed, device="cuda")
    load_checkpoint(str(run_dir / "ckpts" / "last.ckpt"), model)
    with flash_switch(True), torch.inference_mode(), no_tf32():
        model(frames[1], HW, HW)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for b in frames[1:4]:
            model(b, HW, HW)
        torch.cuda.synchronize()
        model_ms = (time.perf_counter() - t3) * 1e3 / 3
    ms_per_frame = 1e3 / scores["eval_frames_per_s"]
    row = {"config": "configs/one_shot.yaml", "route": "kernels",
           "fit_cli_s": fit_s, "fit_cli_steps": FIT_STEPS,
           "fit_cli_launches": fit_launches, "fit_cli_losses": fit_losses,
           "eval_cli_s": eval_s,
           "frames": IH_TEST_FRAMES, "ms_per_frame": ms_per_frame,
           "model_ms_per_frame": model_ms, "load_sample_ms": load_ms,
           "load_sample_share": load_ms / ms_per_frame,
           "load_sample_stages_ms": stages,
           "live_rows_by_frame": [int(b["inter_mask"].sum()) for b in frames],
           "metrics": scores, "launches": launches,
           "card": info["nvidia_smi"]}
    log("interhand_eval", **row)
    del model, frames

    # cli/port_and_eval.py: the checklist, then the three stages
    pae = ["--torch_ckpt", str(src), "--data_root", layout["data_root"],
           "--annot_path", layout["annot_path"], "--mano", layout["mano"]]
    dry = []
    rc, said = run_quiet(port_and_eval.main, pae + ["--dry_run"])
    dry.append(rc)
    image = next(Path(layout["data_root"], "test", "image").rglob(
        "frame0.jpg"))
    saved = image.read_bytes()
    image.unlink()
    try:
        rc, said_gap = run_quiet(port_and_eval.main, pae + ["--dry_run"])
        dry.append(rc)
    finally:
        image.write_bytes(saved)
    log("interhand_port_and_eval_dry_run", rcs=dry,
        names_the_gap=str(image) in said_gap)
    if dry != [0, 2] or str(image) not in said_gap:
        raise AssertionError(f"port_and_eval --dry_run: rcs {dry}:\n{said}"
                             f"\n{said_gap}")
    t4 = time.perf_counter()
    with flash_switch(True):
        rc, said = run_quiet(port_and_eval.main, pae + [
            "--out", str(ported), "--steps", "2", "--expname", "ih_pae",
            "--config", cfg_path, "--no_images", f"out_dir={out_dir}",
            "data.pose_sequence=oneshot_reg_i",
            "model.renderer.raster.projection_impl=pallas"])
    pae_metrics = Path(out_dir) / "ih_pae" / "test_metrics.yml"
    log("interhand_port_and_eval", rc=rc, seconds=time.perf_counter() - t4,
        skipped_port="up to date, skipping" in said,
        wrote=pae_metrics.is_file())
    if rc != 0 or not pae_metrics.is_file():
        raise AssertionError(f"port_and_eval: rc {rc}:\n{said[-3000:]}")
    return {"fit_launches": fit_launches, "launches": launches, "row": row}


def cli_fit_forwards(steps: int) -> int:
    """The forwards cli/fit_one_shot.py's fit of ``steps`` steps renders
    besides its steps: one for the PNGs at every 10th step and the last,
    and one for the fitted PLY."""
    return len({i for i in range(steps) if i % 10 == 0 or i == steps - 1}) + 1


def phase_interhand_card_vs_cpu(root: Path) -> None:
    """One load_sample of a small layout (64-vertex MANO, 64^2, subdivided
    once) on the card and on the CPU: images, masks, bbox_mask and the
    cameras equal to the bit, points within 1e-5, the interaction mask
    within IH_FLIP_SHARE flips."""
    from guassianhand_tpu_torch.data.interhand import (InterHandConfig,
                                                       InterHandDataset)
    layout = interhand_layout().write_interhand_layout(
        root / "small", n_vertices=64, hw=64, test_frames=2)
    cfg = InterHandConfig(data_root=layout["data_root"],
                          annot_path=layout["annot_path"],
                          mano_models_path=layout["mano"], edge_subdivide=1,
                          split="test", pose_sequence="oneshot_reg_i")
    got = {dev: InterHandDataset(cfg, device=dev).load_sample(1)
           for dev in ("cuda", "cpu")}
    card, host = got["cuda"], got["cpu"]
    exact = {k: bool(np.array_equal(np.asarray(card[k].cpu()
                                               if torch.is_tensor(card[k])
                                               else card[k]),
                                    np.asarray(host[k])))
             for k in ("target_rgb", "target_mask", "bbox_mask",
                       "mask_at_box", "c2w", "K_render", "w2c_render",
                       "vert_uv", "mano_pose")}
    points = float((card["points"].cpu() - host["points"]).abs().max())
    flips = float((card["inter_mask"].cpu() != host["inter_mask"])
                  .float().mean())
    log("interhand_card_vs_cpu", exact=exact, points_max_abs=points,
        inter_mask_flip_share=flips,
        interacting=int(host["inter_mask"].sum()),
        n_points=int(host["points"].shape[1]))
    if not all(exact.values()) or points > 1e-5 or flips > IH_FLIP_SHARE:
        raise AssertionError(f"load_sample on the card and the CPU "
                             f"disagree: {exact}, points {points}, flips "
                             f"{flips}")


def phase_interhand(info: dict, out_dir: str) -> dict:
    """The flagship config (configs/one_shot.yaml, both switches) on an
    InterHand2.6M layout at full width (tests/torch_interhand_layout.py::
    write_interhand_layout: 778-vertex
    hands subdivided twice, 15,404 points, 256^2): the reference
    checkpoint ported and loaded (phase_interhand_checkpoint), 10 timed fit
    steps (phase_interhand_fit), the CLIs (phase_interhand_cli), the
    card against the CPU (phase_interhand_card_vs_cpu), and K1-K4 and the
    bf16 K5 against their twins at the fit's own inputs. Returns the fit
    CLI's and the evaluation CLI's launches and the kernels' rows."""
    from guassianhand_tpu_torch.config import load_config
    root = Path(out_dir) / "interhand"
    t0 = time.perf_counter()
    layout = interhand_layout().write_interhand_layout(
        root / "layout", hw=HW, test_frames=IH_TEST_FRAMES)
    log("interhand_layout", seconds=time.perf_counter() - t0, **layout)
    cfg = load_config(str(REPO / "configs" / "one_shot.yaml"), [
        f"data.data_root={layout['data_root']}",
        f"data.annot_path={layout['annot_path']}",
        f"data.mano_models_path={layout['mano']}",
        "model.renderer.raster.projection_impl=pallas"])
    if cfg.model != kernel_config(flagship_config(), True):
        raise AssertionError("configs/one_shot.yaml's model changed")
    src, ported = phase_interhand_checkpoint(cfg, root)
    fit = phase_interhand_fit(cfg, ported, info)
    evaluation = phase_interhand_cli(layout, src, ported, out_dir, info)
    phase_interhand_card_vs_cpu(root)
    gs = fit["gaussians"]
    rows = {"composite": check_composite("interhand_fit", fit["inputs"]),
            "gradients": check_gradients("interhand_fit", fit["inputs"]),
            "projection": check_projection(
                "interhand_fit", gs.xyz.contiguous(), gs.scaling.contiguous(),
                gs.rotation.contiguous(), fit["camera"]),
            "attention_bf16": check_attention_bf16(
                "interhand_fit", *fit["attention"])}
    return {"fit_launches": evaluation["fit_launches"],
            "eval_launches": evaluation["launches"], "rows": rows}


GEN_HW = 252       # the generator's image: 18 x 18 patches + CLS
GEN_REPS = 3       # timed calls of each generator path after a warm-up
GEN_RTOL = 1e-3    # card vs CPU: max |card - CPU| <= GEN_RTOL * max(1, |CPU|)
# ... except at the points whose kNN neighbours the two devices' distance
# rounding orders apart at exact ties (ROADMAP Queue C): at most this share
GEN_FLIP_SHARE = 0.01


def generator_reference_files(root: Path) -> tuple:
    """A seeded full-width SimplePointGenerator (seed 0): its state dict in
    the reference checkpoint's layout (``model.pointcloud_generator.*``,
    the ViT left out, as the reference leaves it out) and its ViT as a
    Hugging Face DINOv2 state dict (``dinov2.*``, with a mask token), both
    written under ``root``. Returns (the generator, the two paths)."""
    from guassianhand_tpu_torch.models.point_generator import (
        SimplePointGenerator)
    source = SimplePointGenerator()
    source.reset_parameters(torch.Generator().manual_seed(0))
    vit = "image_tokenizer.model."
    ref, dino = {}, {}
    for k, v in source.state_dict().items():
        if k.startswith(vit):
            dino["dinov2." + k.removeprefix(vit)] = v
        else:
            ref["model.pointcloud_generator." + k] = v
    dino["dinov2.embeddings.mask_token"] = torch.zeros(1, 768)
    src, hf = root / "generator_reference.ckpt", root / "dinov2.bin"
    torch.save({"state_dict": ref}, src)
    torch.save(dino, hf)
    return source, src, hf


def time_generator_call(label: str, fn, cpu_fn, reps: int = GEN_REPS,
                        events: list = None) -> tuple:
    """One warm-up call of ``fn`` on the card, ``reps`` timed calls (host
    clock to a synchronise), one profiled call (device busy ms, kernel
    launches, top kernels; or ``events``, the kernel rows of parts of the
    call profiled apart), the peak bytes of a call, and the card's output
    against ``cpu_fn``'s on the port's CPU path. None of the port's
    hand-written kernels may launch. Returns (row, card output, CPU
    output)."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = fn()
        torch.cuda.synchronize()
        zero_launches()
        ms = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        launched = {k: v for k, v in read_launches().items() if v}
        t = time.perf_counter()
        if events is None:
            events = profile_kernels(fn)
        profiled_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        ref = cpu_fn()
        cpu_s = time.perf_counter() - t
    top = sorted(events, key=_device_us, reverse=True)[:8]
    row = {"ms": ms, "ms_mean": float(np.mean(ms)),
           "device_busy_ms": sum(_device_us(e) for e in events) / 1e3,
           "launches": sum(e.count for e in events),
           "peak_bytes": peak, "peak_bytes_above_inputs": peak - base,
           "cpu_reference_s": cpu_s, "profiled_call_s": profiled_s,
           "seconds": time.perf_counter() - t0,
           "top_device_ms": [[e.key[:60], _device_us(e) / 1e3, e.count]
                             for e in top]}
    row["device_busy_share"] = row["device_busy_ms"] / row["ms_mean"]
    if launched:
        raise AssertionError(f"{label} launched {launched}: no hand-written "
                             f"kernel lies on the generator's path")
    return row, out, ref


def card_vs_cpu(label: str, out: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |card - CPU| over ``out``; the share of points (rows of the last
    axis) off by more than GEN_RTOL * max(1, max |CPU|) may not pass
    GEN_FLIP_SHARE."""
    out = out.float().cpu()
    ref = ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: shape {tuple(out.shape)} against "
                             f"{tuple(ref.shape)}, or not finite")
    diff = (out - ref).abs()
    tol = GEN_RTOL * max(1.0, float(ref.abs().max()))
    off = (diff.reshape(-1, diff.shape[-1]).amax(-1) > tol).float().mean()
    row = {"max_abs_diff": float(diff.max()),
           "rows_over_tol_share": float(off), "tol": tol}
    if float(off) > GEN_FLIP_SHARE:
        raise AssertionError(f"{label}: card against CPU {row}")
    return row


def phase_point_generator(info: dict, out_dir: str) -> dict:
    """The point-cloud generator at full width (num_pcl 2,048, 512 point
    channels, a 10-layer backbone of 8 x 64 heads, up factors (2, 4),
    dim_feat 128, a camera embedding of 768, DINOv2 ViT-B/14 12 x 768): a
    seeded reference-layout checkpoint and a seeded Hugging Face DINOv2
    state dict through ``cli/port_checkpoint.py --dinov2``, loaded by
    ``load_point_generator`` (every tensor bit-equal to the seeded
    generator's); then on the card, each timed (phase
    ``time_generator_call``) and held against the same call on the CPU:
    the bypass ``forward`` on the synthetic scene's 15,404 points (FPS to
    2,048, 16,384 out), the FPS alone (its indices against the CPU's, to
    the index), ``generate`` on one 252^2 image and a seeded camera
    (16,384 out), ``ImageFeature`` on the scene's 256^2 render and mask
    with the image's tokens, and ``rasterize_points`` of the scene's points
    at 256^2 (winners exact)."""
    from guassianhand_tpu_torch.cli import port_checkpoint
    from guassianhand_tpu_torch.compat.torch_port import load_point_generator
    from guassianhand_tpu_torch.core.camera import Camera
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.point_generator import ImageFeature
    from guassianhand_tpu_torch.ops.fps import farthest_point_sample
    from guassianhand_tpu_torch.ops.zbuffer import rasterize_points
    root = Path(out_dir) / "point_generator"
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    source, src, hf = generator_reference_files(root)
    ported = root / "generator.port.ckpt"
    rc, said = run_quiet(port_checkpoint.main, [
        "--torch_ckpt", str(src), "--out", str(ported), "--dinov2", str(hf)])
    cpu_gen, loaded = run_quiet(load_point_generator, str(ported), "cpu")
    want = source.state_dict()
    own = cpu_gen.state_dict()
    unequal = [k for k in want if not torch.equal(own[k], want[k])]
    n = len(want)
    log("point_generator_checkpoint", seconds=time.perf_counter() - t0,
        tensors=n, restored_line=loaded.strip(), unequal=unequal,
        port_said=said.strip().splitlines()[-1])
    if rc != 0 or "unmapped" in said or unequal \
            or f"restored {n}/{n} " not in loaded:
        raise AssertionError(f"the generator's checkpoint: rc {rc}, {said!r}"
                             f", {loaded!r}, unequal {unequal}")
    del source, want, own
    gen = load_point_generator(str(ported), "cuda")
    cpu_gen.eval()

    # the scene and its target render built on the card (the render through
    # the port's kernels), then copied to the host for the CPU runs
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    with torch.inference_mode():
        batch = {k: v.cpu() for k, v in synthetic_batch(
            scene, seed=0, with_target=True).items()}
    pts = batch["points"]                                  # (1, 15,404, 3)
    rng = torch.Generator().manual_seed(1)
    image = torch.rand(1, GEN_HW, GEN_HW, 3, generator=rng)
    camera = torch.randn(1, 25, generator=rng)
    rows = {"config": {"num_pcl": gen.num_pcl, "points_in": pts.shape[1],
                       "image": GEN_HW, "card": info["nvidia_smi"]}}

    def cuda(*ts):
        return [t.cuda() for t in ts]

    pts_c, image_c, camera_c = cuda(pts, image, camera)
    # the bypass is the FPS (a loop of 35,000 launches, which the profiler
    # takes some 20 s to record) and the decoder on its 2,048 points: the
    # two are profiled apart, once, and their kernel rows serve both rows
    p0, p0_c = pts[0], pts_c[0]
    with torch.inference_mode():
        base_c = p0_c[farthest_point_sample(p0_c, gen.num_pcl)][None]
        gen(base_c)                                        # warm-up
        fps_events = profile_kernels(
            lambda: farthest_point_sample(p0_c, gen.num_pcl))
        decoder_events = profile_kernels(lambda: gen(base_c))
    rows["bypass"], out, ref = time_generator_call(
        "bypass", lambda: gen(pts_c), lambda: cpu_gen(pts), reps=2,
        events=fps_events + decoder_events)
    rows["bypass"]["card_vs_cpu"] = card_vs_cpu("bypass", out, ref)
    rows["bypass"]["points_out"] = out.shape[1]
    rows["bypass"]["decoder_device_busy_ms"] = sum(
        _device_us(e) for e in decoder_events) / 1e3

    rows["fps"], idx, idx_ref = time_generator_call(
        "fps", lambda: farthest_point_sample(p0_c, gen.num_pcl),
        lambda: farthest_point_sample(p0, gen.num_pcl), reps=1,
        events=fps_events)
    flips = int((idx.cpu() != idx_ref).sum())
    rows["fps"]["index_flips"] = flips
    rows["fps"]["share_of_bypass_ms"] = (rows["fps"]["ms_mean"]
                                         / rows["bypass"]["ms_mean"])
    rows["fps"]["share_of_bypass_busy"] = (rows["fps"]["device_busy_ms"]
                                           / rows["bypass"]["device_busy_ms"])

    rows["generate"], out, ref = time_generator_call(
        "generate", lambda: gen.generate(image_c, camera_c),
        lambda: cpu_gen.generate(image, camera))
    rows["generate"]["card_vs_cpu"] = card_vs_cpu("generate", out, ref)
    rows["generate"]["points_out"] = out.shape[1]

    with torch.inference_mode():
        tokens = cpu_gen.image_tokenizer(
            image, cpu_gen.camera_embedder(camera))
    rgb, mask = batch["target_rgb"], batch["target_mask"]
    feature = ImageFeature()
    rgb_c, tokens_c, mask_c = cuda(rgb, tokens, mask)
    rows["image_feature"], out, ref = time_generator_call(
        "image_feature", lambda: feature(rgb_c, tokens_c, mask_c),
        lambda: feature(rgb, tokens, mask))
    rows["image_feature"]["card_vs_cpu"] = card_vs_cpu("image_feature", out,
                                                       ref)

    cam = Camera.from_w2c(batch["w2c_render"][0, 0], batch["K_render"][0, 0],
                          HW, HW, device="cpu")
    cam_c = Camera.from_w2c(cam.w2c, cam.K, HW, HW, device="cuda")
    rows["rasterize_points"], out, ref = time_generator_call(
        "rasterize_points", lambda: rasterize_points(p0_c, cam_c, HW, HW),
        lambda: rasterize_points(p0, cam, HW, HW))
    rows["rasterize_points"]["winner_mismatch"] = int(
        (out[0].cpu() != ref[0]).sum())
    rows["rasterize_points"]["covered_pixels"] = int((ref[0] >= 0).sum())
    rows["rasterize_points"]["depth_max_abs_diff"] = float(
        (out[1].cpu() - ref[1]).abs().max())
    rows["seconds"] = time.perf_counter() - t0
    log("point_generator", **rows)
    if flips or rows["rasterize_points"]["winner_mismatch"] \
            or rows["bypass"]["points_out"] != gen.num_pcl * 8 \
            or rows["generate"]["points_out"] != gen.num_pcl * 8:
        raise AssertionError(f"the generator on the card: FPS {flips} index "
                             f"flips, {rows}")
    return rows


# --- [sharded]: the sharded fit step on 4 ranks of one card ----------------
SHARDED_RANKS = 4
# NCCL refuses two ranks on one GPU; gloo runs every collective of
# parallel/comm.py on CUDA tensors (all_to_all_single, all_gather,
# all_reduce, broadcast), so the ranks share cuda:0 through gloo
SHARDED_BACKEND = "gloo"
SHARDED_FIT_STEPS = 3
SHARDED_TIMEOUT_S = 600
# JAX's at-scale gates (tests/test_parallel.py::
# test_exchange_tight_capacity_at_scale): render max |d| and the share of
# pixels over SHARD_PIXEL_EPS; gradients: the share of elements over
# 1e-4 * scale + 1e-3 * |ref| and the largest |d| over scale
SHARD_RGB_MAX, SHARD_PIXEL_EPS, SHARD_PIXEL_SHARE = 2e-3, 1e-5, 1e-4
SHARD_GRAD_SHARE, SHARD_GRAD_MAX = 1e-4, 2e-2
SHARD_LOSS_RTOL = 1e-4


def at_scale_gate(got: torch.Tensor, want: torch.Tensor) -> dict:
    """JAX's at-scale gradient gate of ``got`` against ``want``."""
    d = (got - want).abs()
    scale = float(want.abs().max()) + 1e-12
    bad = d > 1e-4 * scale + 1e-3 * want.abs()
    row = {"max_abs_err": float(d.max()) if d.numel() else 0.0,
           "scale": scale, "bad_share": float(bad.float().mean())}
    row["ok"] = (row["bad_share"] <= SHARD_GRAD_SHARE
                 and row["max_abs_err"] <= SHARD_GRAD_MAX * scale)
    return row


def sharded_raster_case(mesh) -> dict:
    """sharded_raster_4x256 on this rank (data 1 x model 4): the at-scale
    case of tests/test_parallel.py (the synthetic scene's 15,404 points and
    a copy offset by 1e-3: 30,808 decoration Gaussians at 256^2, its render
    view) through sharded_rasterize_batch with the port's suggested
    capacity; the loss mean |rgb - target|, its xyz and shs gradients
    summed over the model group; on rank 0 held against the unsharded
    rasterize_multiview on the card."""
    from guassianhand_tpu_torch.core.gaussians import Gaussians
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.ops.rasterize import rasterize_multiview
    from guassianhand_tpu_torch.parallel import comm
    from guassianhand_tpu_torch.parallel.raster_shard import (
        exchange_balance_stats, sharded_rasterize_batch)
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    batch = synthetic_batch(scene, seed=0)
    pts = batch["points"][0]
    gs = scene.decoration_gaussians(torch.cat([pts, pts + 1e-3]))
    w2cs, ks = batch["w2c_render"], batch["K_render"]
    bg = torch.tensor([[0.1, 0.2, 0.3]], device="cuda")
    target = torch.as_tensor(np.random.RandomState(1).uniform(
        0, 1, (1, 1, HW, HW, 3)), dtype=torch.float32, device="cuda")
    stats = exchange_balance_stats([gs], w2cs, ks, height=HW, width=HW,
                                   n_model=mesh.n_model)
    cap = stats["suggested_capacity"]

    def run(sharded: bool):
        leaves = {k: getattr(gs, k).clone().requires_grad_()
                  for k in ("xyz", "shs")}
        g = Gaussians(xyz=leaves["xyz"], opacity=gs.opacity,
                      rotation=gs.rotation, scaling=gs.scaling,
                      shs=leaves["shs"])
        if sharded:
            out = sharded_rasterize_batch(
                [g], w2cs, ks, height=HW, width=HW, mesh=mesh, background=bg,
                use_rgb=True, exchange_capacity=cap)
            rgb = out["comp_rgb"]
        else:
            out = rasterize_multiview(g, w2cs[0], ks[0], height=HW,
                                      width=HW, background=bg[0],
                                      use_rgb=True)
            rgb = out["comp_rgb"][None]
        loss = (rgb - target).abs().mean()
        loss.backward()
        grads = {k: t.grad for k, t in leaves.items()}
        if sharded:
            for t in grads.values():
                comm.all_reduce(t, mesh.model_group)
        torch.cuda.synchronize()
        return rgb.detach(), loss.detach(), grads, out

    comm.stats.reset()
    rgb, loss, grads, out = run(True)
    a2a = comm.stats.snapshot().get("all_to_all", {})
    t0 = time.perf_counter()
    run(True)
    ms = (time.perf_counter() - t0) * 1e3
    row = {"n_gaussians": gs.n, "capacity": cap,
           "stats": {k: stats[k] for k in ("live_pairs", "diagonal",
                                           "default_capacity",
                                           "suggested_capacity")},
           "exchange_pairs": out["exchange_pairs"].tolist(),
           "overflow": int(out["overflow"]), "all_to_all": a2a,
           "fwd_bwd_ms": ms, "loss": float(loss)}
    if mesh.rank == 0:
        ref_rgb, ref_loss, ref_grads, _ = run(False)
        d = (rgb - ref_rgb).abs()
        row["render"] = {"max_abs_err": float(d.max()),
                         "share_over_eps": float(
                             (d > SHARD_PIXEL_EPS).float().mean())}
        row["loss_ref"] = float(ref_loss)
        row["gradients"] = {k: at_scale_gate(grads[k], ref_grads[k])
                            for k in grads}
    return row


# trainables whose gradient comes back through the bf16 feature pipeline's
# backward: there an fp32-ulp change of the features' gradient (the
# exchange's tile-local rounding) flips bf16 roundings and moves these
# gradients by about 1 % of their largest, while the bf16 gradient itself
# lies about 10 % (in norm) from the float32 function's (CPU rehearsal at
# the tiny config). In the bf16 step they are held in norm against the
# float32 function as the bf16 kernels are (BF16_NORM_RATIO), the others
# at the at-scale gate; the float32 sharded step holds every trainable,
# these too, at the at-scale gate against the float32 reference
FEATURE_TRAINABLES = ("identity_code", "map_bias")


def accumulated_step(module, vgg, fit_cfg, samples) -> tuple:
    """One unsharded update of ``module`` from len(samples) B = 1 steps
    (each sample's features at B = 1, as on the ranks): the losses and the
    gradients the update was given (the mean of the samples'). The
    module's trainables are put back as they were before."""
    from guassianhand_tpu_torch.train.fit import (attach_static_features,
                                                  make_fit_step,
                                                  make_optimizer)
    acc = dataclasses.replace(fit_cfg, accumulate_grad_batches=len(samples))
    optimizer, _ = make_optimizer(module, acc)
    saved = {n: p.detach().clone() for n, p in module.named_parameters()
             if p.requires_grad}
    grads = {}

    def hook(opt, args, kwargs):
        grads.update({n: p.grad.detach().clone()
                      for n, p in module.named_parameters()
                      if p.grad is not None})

    optimizer.register_step_pre_hook(hook)
    step = make_fit_step(module, vgg, optimizer, None, acc, height=HW,
                         width=HW)
    losses = [float(step(attach_static_features(module, b))[0])
              for b in samples]
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n in saved:
                p.copy_(saved[n])
    return losses, grads


def sharded_step_of(model, vgg, fit_cfg, batch, mesh) -> tuple:
    """``make_sharded_fit_step`` of ``model`` on this rank's shard of
    ``batch`` (its static features attached): the step, the shard and a
    dict that each update fills with the gradients it was given."""
    from guassianhand_tpu_torch.parallel.step import (make_sharded_fit_step,
                                                      shard_batch)
    from guassianhand_tpu_torch.train.fit import (attach_static_features,
                                                  make_optimizer)
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    step = make_sharded_fit_step(model, vgg, optimizer, mesh, fit_cfg,
                                 height=HW, width=HW, scheduler=scheduler)
    local = attach_static_features(model, shard_batch(batch, mesh))
    given = {}
    optimizer.register_step_pre_hook(lambda opt, args, kwargs: given.update(
        {n: p.grad.detach().clone() for n, p in model.named_parameters()
         if p.grad is not None}))
    return step, local, given


def sharded_fit_case(mesh) -> dict:
    """sharded_fit_2x2_bf16 on this rank: configs/one_shot.yaml at full
    width with both switches and the exchange required, B = 2 (the
    synthetic scene posed from seeds 0 and 1, one a data shard), vgg 0.1.
    On rank 0 first the references from the same parameters: the mean of
    two unsharded B = 1 steps (the ranks' own feature shapes) of this
    model, and of its float32 twin (the same weights, compute_dtype None).
    Then on every rank one sharded step of the float32 twin, and
    SHARDED_FIT_STEPS sharded steps of the model, each followed by the
    replicas' checksum spread."""
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.parallel import comm
    from guassianhand_tpu_torch.parallel.step import replica_spread
    from guassianhand_tpu_torch.train.fit import FitConfig
    from guassianhand_tpu_torch.train.losses import LossWeights
    from guassianhand_tpu_torch.train.vgg import VGGLoss
    plain = kernel_config(flagship_config(), True)
    cfg = dataclasses.replace(plain, renderer=dataclasses.replace(
        plain.renderer, sharded_exchange=True,
        sharded_exchange_required=True))
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=HW,
                                     width=HW, device="cuda")
    samples = [synthetic_batch(scene, seed=s, with_target=True)
               for s in range(mesh.n_data)]
    batch = {k: torch.cat([b[k] for b in samples]) for k in samples[0]}
    fit_cfg = FitConfig(weights=LossWeights(vgg=0.1))
    model = build_model(cfg, seed=0, device="cuda")
    vgg = VGGLoss().to("cuda")
    row = {"n_points": scene.n_points, "batch": mesh.n_data}
    if mesh.rank == 0:
        # the references render unsharded: the renderer's flags own no
        # parameter, so the same model runs with them off
        model.cfg = plain
        try:
            ref_losses, ref_grads = accumulated_step(model, vgg, fit_cfg,
                                                     samples)
        finally:
            model.cfg = cfg
        twin = build_model(dataclasses.replace(plain, compute_dtype=None),
                           seed=0, device="cuda")
        twin.load_state_dict(model.state_dict())
        f32_losses, f32_grads = accumulated_step(twin, vgg, fit_cfg,
                                                 samples)
        del twin
    # the float32 sharded step: the exchange and the reductions without
    # the bf16 pipeline's rounding, from the same weights
    twin = build_model(dataclasses.replace(cfg, compute_dtype=None), seed=0,
                       device="cuda")
    twin.load_state_dict(model.state_dict())
    step, local, given = sharded_step_of(twin, vgg, fit_cfg, batch, mesh)
    torch.cuda.synchronize()
    zero_launches()
    f32_loss = float(step(local)[0])
    torch.cuda.synchronize()
    row["float32_launches"] = read_launches()
    f32_step1 = dict(given)
    del twin, step, local, given
    step, local, given = sharded_step_of(model, vgg, fit_cfg, batch, mesh)
    steps = []
    for i in range(SHARDED_FIT_STEPS):
        torch.cuda.synchronize()
        zero_launches()
        comm.stats.reset()
        t0 = time.perf_counter()
        loss, err = step(local)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({
            "step": i, "ms": ms, "loss": float(loss),
            "exchange_pairs": err["exchange_pairs"].tolist(),
            "overflow": float(err["overflow"]), "launches": read_launches(),
            "comm": comm.stats.snapshot(),
            "replica_spread": replica_spread(model, mesh)})
        if i == 0:
            step1 = dict(given)
    row["steps"] = steps
    if mesh.rank == 0:
        if set(step1) != set(ref_grads):
            raise AssertionError(f"gradients of other parameters: "
                                 f"{sorted(set(step1) ^ set(ref_grads))}")
        if set(f32_step1) != set(f32_grads):
            raise AssertionError(f"float32: gradients of other parameters: "
                                 f"{sorted(set(f32_step1) ^ set(f32_grads))}")
        grads = {}
        for n in sorted(ref_grads):
            g = at_scale_gate(step1[n], ref_grads[n])
            g["gate"] = "at_scale"
            if any(n.startswith(k) for k in FEATURE_TRAINABLES):
                to_f32 = float((step1[n] - f32_grads[n]).norm())
                ref_to_f32 = float((ref_grads[n] - f32_grads[n]).norm())
                g.update(gate="bf16_norm", norm_to_fp32=to_f32,
                         ref_norm_to_fp32=ref_to_f32,
                         ratio=to_f32 / max(ref_to_f32, 1e-30),
                         rel_norm_to_ref=float(
                             (step1[n] - ref_grads[n]).norm()
                             / ref_grads[n].norm().clamp_min(1e-30)))
                g["ok"] = g["ratio"] <= BF16_NORM_RATIO
            grads[n] = g
        ref_loss = float(np.mean(ref_losses))
        f32_ref_loss = float(np.mean(f32_losses))
        row["reference"] = {
            "how": "mean of two unsharded B = 1 steps (one update), the "
                   "features at the ranks' B = 1 shapes",
            "losses": ref_losses, "loss": ref_loss,
            "loss_rel_err": abs(steps[0]["loss"] - ref_loss) / abs(ref_loss),
            "gradients": grads,
            "float32": {
                "how": "one sharded step of the float32 twin against the "
                       "twin's two unsharded B = 1 steps",
                "loss": f32_loss, "ref_loss": f32_ref_loss,
                "loss_rel_err": abs(f32_loss - f32_ref_loss)
                / abs(f32_ref_loss),
                "gradients": {n: at_scale_gate(f32_step1[n], f32_grads[n])
                              for n in sorted(f32_grads)}}}
    return row


def sharded_rank(rank: int, tmp: str) -> None:
    """One rank of phase_sharded: joins the gloo job on cuda:0, runs both
    rows, writes tmp/rank{rank}.json."""
    from guassianhand_tpu_torch.parallel.mesh import (initialize_distributed,
                                                      make_mesh)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    initialize_distributed("file://" + os.path.join(tmp, "rendezvous"),
                           SHARDED_RANKS, rank, backend=SHARDED_BACKEND)
    import torch.distributed as dist
    try:
        out = {"rank": rank, "backend": str(dist.get_backend()),
               "device": str(torch.empty(0, device="cuda").device)}
        out["raster"] = sharded_raster_case(make_mesh(n_data=1))
        with flash_switch(True):
            out["fit"] = sharded_fit_case(make_mesh(n_data=2))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_sharded() -> dict:
    """[sharded]: SHARDED_RANKS processes on the one card, gloo, every
    rank's tensors on cuda:0 (spawned after phase_build, so they load the
    built kernels): sharded_raster_4x256 and sharded_fit_2x2_bf16
    (``sharded_raster_case``, ``sharded_fit_case``). Four processes share
    one card: the times are not a scaling figure. Any rank's failure or a
    timeout fails the phase. Returns rank 0's launches a step."""
    import torch.multiprocessing as mp
    from guassianhand_tpu_torch.parallel.dryrun import join
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(sharded_rank, args=(tmp,),
                                 nprocs=SHARDED_RANKS, join=False,
                                 start_method="spawn")
        # a failed rank raises here; one still running at the limit is
        # killed and TimeoutError fails the phase
        join(ctx, SHARDED_TIMEOUT_S)
        ranks = []
        for r in range(SHARDED_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    log("sharded", backend=ranks[0]["backend"],
        devices=[r["device"] for r in ranks], ranks=SHARDED_RANKS,
        seconds=seconds, note="4 ranks share one card through gloo: "
        "times are not a scaling figure")
    raster = [r["raster"] for r in ranks]
    fits = [r["fit"] for r in ranks]
    for r, x in enumerate(raster):
        log("sharded_raster_4x256", rank=r, **{k: v for k, v in x.items()})
    for r, x in enumerate(fits):
        for s in x["steps"]:
            a2a = s["comm"].get("all_to_all", {})
            log("sharded_fit_step", rank=r, step=s["step"], ms=s["ms"],
                loss=s["loss"], exchange_pairs=s["exchange_pairs"],
                overflow=s["overflow"], all_to_all_calls=a2a.get("calls"),
                all_to_all_bytes=a2a.get("bytes"), comm=s["comm"],
                replica_spread=s["replica_spread"], launches=s["launches"])
    ref = fits[0]["reference"]
    log("sharded_fit_2x2_bf16", config="configs/one_shot.yaml",
        route="kernels", reference=ref,
        float32_launches=[x["float32_launches"] for x in fits],
        rank0_step_ms=[s["ms"] for s in fits[0]["steps"]],
        losses=[s["loss"] for s in fits[0]["steps"]])
    # the gates
    r0 = raster[0]
    failures = []
    if r0["render"]["max_abs_err"] > SHARD_RGB_MAX \
            or r0["render"]["share_over_eps"] > SHARD_PIXEL_SHARE:
        failures.append(f"raster render {r0['render']}")
    failures += [f"raster gradient {k} {v}" for k, v in
                 r0["gradients"].items() if not v["ok"]]
    for r, x in enumerate(raster):
        if x["overflow"] != 0 or sum(x["exchange_pairs"]) <= 50_000:
            failures.append(f"raster rank {r}: overflow {x['overflow']}, "
                            f"pairs {sum(x['exchange_pairs'])}")
    if ref["loss_rel_err"] > SHARD_LOSS_RTOL:
        failures.append(f"fit loss vs reference {ref['loss_rel_err']}")
    failures += [f"fit gradient {k} {v}" for k, v in
                 ref["gradients"].items() if not v["ok"]]
    if ref["float32"]["loss_rel_err"] > SHARD_LOSS_RTOL:
        failures.append(f"float32 fit loss vs reference "
                        f"{ref['float32']['loss_rel_err']}")
    failures += [f"float32 fit gradient {k} {v}" for k, v in
                 ref["float32"]["gradients"].items() if not v["ok"]]
    for r, x in enumerate(fits):
        losses = [s["loss"] for s in x["steps"]]
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            failures.append(f"fit rank {r} losses {losses}")
        if losses != [s["loss"] for s in fits[0]["steps"]]:
            failures.append(f"fit rank {r} losses differ from rank 0's")
        for s in x["steps"]:
            if s["replica_spread"] != 0:
                failures.append(f"fit rank {r} step {s['step']}: replicas "
                                f"differ ({s['replica_spread']})")
            if s["overflow"] != 0 or min(s["exchange_pairs"]) <= 0:
                failures.append(f"fit rank {r} step {s['step']}: overflow "
                                f"{s['overflow']}, pairs "
                                f"{s['exchange_pairs']}")
            if s["comm"].get("all_to_all", {}).get("calls", 0) < 1:
                failures.append(f"fit rank {r}: no all_to_all")
        try:
            check_launches(f"[sharded] fit rank {r}",
                           x["steps"][-1]["launches"],
                           FIT_KERNELS + FLASH_BF16)
            check_launches(f"[sharded] float32 fit rank {r}",
                           x["float32_launches"], FIT_KERNELS + FLASH_FP32)
        except AssertionError as e:
            failures.append(str(e))
    if failures:
        raise AssertionError("[sharded]: " + "; ".join(failures))
    return {"launches": fits[0]["steps"][-1]["launches"],
            "rank0_step_ms": [s["ms"] for s in fits[0]["steps"]]}


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
                route: str = None, want: tuple = None, hw: int = HW,
                requests: int = REQUESTS):
    """``requests`` requests of V views at hw x hw of the full-width
    avatar, on the default route
    or with both kernel switches on (where each request must launch the
    projection once for its V views), of ``model_cfg`` (``slice_config``,
    fp32, unless given); ``want`` the kernels the requests
    must launch (all others must not launch); then a profiled request.
    Returns the last request's composite inputs (the avatar's projected
    Gaussians), the launch counts, the last request's Gaussians and
    cameras, the request rows and the profile."""
    from guassianhand_tpu_torch.cli.render_360 import (orbit_batch,
                                                       render_request)
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.ops.rasterize import multiview_composite_inputs

    route = route or ("kernels" if kernels else "default")
    cfg = kernel_config(model_cfg or slice_config(), kernels)
    t0 = time.perf_counter()
    scene = SyntheticHandScene.build(n_vertices=778, subdivide=2, height=hw,
                                     width=hw, device="cuda")
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
        out = render_request(model, batch, hw, hw)
        torch.cuda.synchronize()
        return batch, out, (t_b - t_a) * 1e3, (time.perf_counter() - t_b) * 1e3

    want = want or (SERVE_KERNELS if kernels else SERVE_DEFAULT)
    with flash_switch(kernels):
        request(1000)                                  # warm-up
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        results = []
        for r in range(requests):
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
            if not row["finite"] or row["shape"] != [1, VIEWS, hw, hw, 3]:
                raise AssertionError(f"request {r}: bad output {row}")
            if not 0.0 < row["comp_mask_mean"] < 1.0:
                raise AssertionError(f"request {r}: empty or full render "
                                     f"{row}")
        log("slice", route=route, requests=requests, views=VIEWS, hw=hw,
            model_ms=[x["model_ms"] for x in rows],
            model_ms_mean=float(np.mean([x["model_ms"] for x in rows])),
            launches=launches, peak_bytes=peak)
        check_launches(f"the serving slice ({route})", launches, want)
        batch, out = results[-1][0], results[-1][1]
        prof = phase_profile(lambda: request(requests),
                             lambda: model.features(batch), rows, route)
    gs = out["3dgs"][0]
    rcfg = cfg.renderer
    w2cs, Ks = batch["w2c_render"][0], batch["K_render"][0]
    inputs = multiview_composite_inputs(
        gs, w2cs, Ks, height=hw, width=hw, sh_degree=rcfg.sh_degree,
        use_rgb=rcfg.use_rgb, config=rcfg.raster)
    return inputs, launches, {"gaussians": gs, "w2cs": w2cs, "Ks": Ks,
                              "rows": rows, "peak_bytes": peak,
                              "profile": prof}


def _device_us(event) -> float:
    return float(event.self_device_time_total)


def profile_kernels(fn) -> list:
    """Run ``fn`` once under torch.profiler: its kernel rows (operators'
    rows repeat their kernels' device time and are left out)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0]


def device_profile(fn):
    """Run ``fn`` once under torch.profiler: (device busy ms, the top
    kernels as [name, ms, count])."""
    events = profile_kernels(fn)
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
    mask. ``model_cfg`` is the model (``slice_config``, fp32,
    unless given), ``want`` the kernels the steps must launch (all others
    must not launch)."""
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    from guassianhand_tpu_torch.train.fit import trainable_mask
    route = route or ("kernels" if kernels else "default")
    cfg = kernel_config(model_cfg or slice_config(), kernels)
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
        captured = kernel_inputs(model, batch)
    return {"launches": launches, "rows": rows, "warmup_loss": warmup_loss,
            "peak_bytes": peak, "busy_ms": busy_ms,
            "busy_share": busy_ms / float(np.mean(ms)), **captured}


def kernel_inputs(model, batch, hw: int = HW) -> dict:
    """One more forward of the fitted ``model`` on ``batch`` at hw x hw
    (under the caller's flash switch) with the interaction attention's
    inputs kept: the kernels' inputs at this batch. Returns the composite
    inputs in the batch's view, the Gaussians, the camera, the attention's
    q, k, v and mask, and the forward's pair count."""
    from guassianhand_tpu_torch.core.camera import Camera
    from guassianhand_tpu_torch.models.one_shot import no_tf32
    from guassianhand_tpu_torch.nn import heads
    from guassianhand_tpu_torch.ops.rasterize import multiview_composite_inputs
    captured = []
    attend = heads.blockwise_attention

    def keep(q, k, v, mask=None, **kw):
        captured.append((q.detach().contiguous(), k.detach().contiguous(),
                         v.detach().contiguous(), mask))
        return attend(q, k, v, mask, **kw)

    heads.blockwise_attention = keep
    try:
        with torch.no_grad(), no_tf32():
            out = model(batch, hw, hw)
    finally:
        heads.blockwise_attention = attend
    gs = out["3dgs"][0]
    rcfg = model.cfg.renderer
    w2c, K = batch["w2c_render"][0], batch["K_render"][0]
    inputs = multiview_composite_inputs(
        gs, w2c, K, height=hw, width=hw, sh_degree=rcfg.sh_degree,
        use_rgb=rcfg.use_rgb, config=rcfg.raster)
    return {"inputs": inputs, "gaussians": gs,
            "camera": Camera.from_w2c(w2c[0], K[0], hw, hw, device="cuda"),
            "attention": captured[0], "n_pairs": int(out["n_pairs"][0])}


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
    # the ranks load the kernels just built
    sharded = phase_sharded()
    sharded_launches = sharded["launches"]
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
    r100k = phase_render_100k(info)
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
    with tempfile.TemporaryDirectory() as out_dir:
        fit512 = phase_fit_512(info, out_dir)
    request512 = phase_request_512(info)
    log("phases_512", seconds={
        "render_100k_512": r100k["seconds"], "fit_512_bf16": fit512["seconds"],
        "request_512_bf16": request512["seconds"]},
        seconds_total=r100k["seconds"] + fit512["seconds"]
        + request512["seconds"],
        render_100k_twin_seconds=r100k["twin_s"])
    phase_bf16_psnr_gate()
    with tempfile.TemporaryDirectory() as out_dir:
        edit = phase_edit(info, out_dir)
        evaluation = phase_eval(info, edit, out_dir)
        edit_launches, eval_launches = edit["launches"], evaluation["launches"]
        del edit
        interhand = phase_interhand(info, out_dir)
        phase_point_generator(info, out_dir)
    ih_fit, ih_eval = interhand["fit_launches"], interhand["eval_launches"]
    ih_rows = interhand["rows"]
    phase_edit_reference()
    for kernels in (False, True):
        phase_reference(kernels)
        phase_fit_reference(kernels)

    def grad_err(row, part):
        return max(v["max_abs_err"] for v in row[part].values())

    def by_path(name):
        return {"serve": serve_launches[name],
                "serve_with_switches": serve_kernel_launches[name],
                "fit": fit_launches[name],
                "fit_with_switches": kfit_launches[name],
                "fit_edit_flagship_bf16": edit_launches[name],
                "eval_flagship_bf16": eval_launches[name],
                "fit_interhand_flagship_bf16": ih_fit[name],
                "eval_interhand_flagship_bf16": ih_eval[name],
                "fit_sharded_flagship_bf16": sharded_launches[name],
                "render_100k_512": r100k["launches"][name],
                "fit_512_flagship_bf16": fit512["launches"][name],
                "request_512_flagship_bf16": request512["launches"][name]}

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
        "library_ms_bench": bench_grad["k3_library_ms"],
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
                "serve_flagship_bf16": flagship_serve[f"{name}_bf16"],
                "fit_edit_flagship_bf16": edit_launches[f"{name}_bf16"],
                "eval_flagship_bf16": eval_launches[f"{name}_bf16"],
                "fit_interhand_flagship_bf16": ih_fit[f"{name}_bf16"],
                "eval_interhand_flagship_bf16": ih_eval[f"{name}_bf16"],
                "fit_sharded_flagship_bf16":
                    sharded_launches[f"{name}_bf16"],
                "render_100k_512": r100k["launches"][f"{name}_bf16"],
                "fit_512_flagship_bf16": fit512["launches"][f"{name}_bf16"],
                "request_512_flagship_bf16":
                    request512["launches"][f"{name}_bf16"]},
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
    comp, grad = ih_rows["composite"], ih_rows["gradients"]
    proj, att = ih_rows["projection"], ih_rows["attention_bf16"]
    at_interhand = {
        "composite_forward": {
            "ms": comp["ms"], "train_ms": grad["k1_train_ms"],
            "bound_ms": comp["bound_ms"],
            "max_abs_err": max(comp["max_abs_err_rgb"],
                               comp["max_abs_err_final_t"])},
        "composite_plan": {"ms": grad["plan_ms"],
                           "equal": grad["plan_equal"]},
        "composite_backward": {
            "ms": grad["k2_ms"], "bound_ms": grad["k2_bound_ms"],
            "max_abs_err": grad["pair_rows_max_abs_err"]},
        "segment_reduce_sorted": {
            "ms": grad["k3_ms"], "bound_ms": grad["k3_bound_ms"],
            "max_abs_err": grad_err(grad, "segment_reduce")},
        "project_forward": {
            "ms": proj["fwd_ms"], "bound_ms": proj["fwd_bound"]["bound_ms"],
            "max_abs_err": max(proj[f"{k}_max_abs_err"]
                               for k in ("mean2d", "depth", "conic"))},
        "project_backward": {
            "ms": proj["bwd_ms"], "bound_ms": proj["bwd_bound"]["bound_ms"],
            "max_abs_err": max(proj[f"grad_{k}_max_abs_err"]
                               for k in ("xyz", "scaling", "rotation"))}}
    at_512 = kernels_at_512(r100k, fit512, request512)
    for name, err in (("flash_forward", ("out",)),
                      ("flash_backward_dkv", ("dk", "dv")),
                      ("flash_backward_dq", ("dq",))):
        at_interhand[f"{name}_bf16"] = {
            "live_rows": att["live"],
            "max_abs_err": max(att[f"{e}_max_abs_err"] for e in err),
            "max_ulps": max(att[f"{e}_max_ulps"] for e in err)}
    for k in kernels:
        if k["name"] in at_interhand:
            k["at_interhand_fit"] = at_interhand[k["name"]]
    for k in kernels:
        if k["name"] in at_512:
            k["at_512"] = at_512[k["name"]]
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                row["max_abs_err"] for row in at_512[k["name"]].values()
                if row.get("max_abs_err") is not None])
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
