// What the tile-composite forward (composite_fwd.cu) and backward
// (composite_bwd.cu) share: the acceptance rule of a pair at a pixel and
// the checkpoint spacing. The checkpoint after the first (b + 1)
// kCheckpoint pairs of tile t is slot slot_base[t] + b, slot_base the
// exclusive prefix sum over the tiles of max(0, ceil(pairs / kCheckpoint)
// - 1) (ops/rasterize_cuda.py::checkpoint_slots).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gh {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;          // pixels a tile
constexpr int kAttr = 9;                     // x y A B C opacity r g b
constexpr int kCheckpoint = 64;              // pairs between checkpoints
constexpr float kAlphaMin = 0.003921568859368563f;  // fp32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// The pair's screen attributes as a CTA stages them in shared memory.
struct PairGeom {
  float2 xy;
  float4 conic_opa;   // A B C opacity
};

// power = -0.5 (A dx dx + C dy dy) - B dx dy, in the twin's order, with
// round-to-nearest intrinsics that the compiler never contracts into FMAs.
__device__ __forceinline__ float pair_power(const PairGeom& g, float px,
                                            float py, float& dx, float& dy) {
  dx = __fsub_rn(g.xy.x, px);
  dy = __fsub_rn(g.xy.y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(g.conic_opa.x, dx), dx),
                               __fmul_rn(__fmul_rn(g.conic_opa.z, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad),
                   __fmul_rn(__fmul_rn(g.conic_opa.y, dx), dy));
}

// alpha = min(0.99, opacity exp(power)) when power <= 0 and alpha >= 1/255,
// else 0 (a NaN power or alpha rejects the pair, as in the twin). `ep` is
// exp(power) and `alpha_raw` opacity exp(power) before the clamp, read
// only where alpha is not 0. No branch, so that the evaluations of several
// pairs interleave. expf is the accurate libm exp: no --use_fast_math.
__device__ __forceinline__ float pair_alpha(const PairGeom& g, float power,
                                            float& ep, float& alpha_raw) {
  ep = expf(power);
  alpha_raw = __fmul_rn(g.conic_opa.w, ep);
  // min(alpha_raw, 0.99) that keeps a NaN, as torch.clamp does
  const float alpha = alpha_raw > kAlphaMax ? kAlphaMax : alpha_raw;
  return power <= 0.0f && alpha >= kAlphaMin ? alpha : 0.0f;
}

// A power below this bound gives alpha < 1/(255 e) < 1/255 whatever the
// rounding, so the pair is rejected there without evaluating exp; +inf for
// an opacity <= 0 or NaN, which pair_alpha rejects everywhere too.
__device__ __forceinline__ float power_floor(float opacity) {
  return opacity > 0.0f ? -logf(255.0f * opacity) - 1.0f : INFINITY;
}

}  // namespace gh
