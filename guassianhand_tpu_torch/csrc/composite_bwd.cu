// Tile-composite backward of the 3DGS rasterizer, for Hopper (sm_90a).
//
// Replaces: guassianhand_tpu/ops/rasterize_pallas.py::composite_backward
// (body _bwd_kernel), reached from ops/rasterize.py::_composite_bwd.
//
// What it computes: for every (Gaussian, tile) pair, the gradient of the
// loss with respect to the pair's screen attributes, summed over the tile's
// pixels, from dL/drgb (H, W, 3), dL/dT_final (H, W) and what the forward's
// training mode kept: rgb (H, W, 3), final T (H, W), n_contrib (H, W) and the
// chunk checkpoints (T, C) of composite_fwd.cu. Per pixel, back to front
// over the pairs the forward composited (those before n_contrib that pass
// the power and alpha gates):
//   T_i      = T_{i+1} / (1 - alpha_i)            (T before pair i)
//   e_i      = dL/drgb . c_i,   w_i = alpha_i T_i
//   r_i      = sum_{j>i} w_j e_j + dL/dT_final T_final
//   dalpha_i = e_i T_i - r_i / (1 - alpha_i)
//   dpower_i = dalpha_i * opacity exp(power)   (the 0.99 clamp passes the
//              gradient straight through, as in the CUDA reference)
// and from dpower the mean2d (2) and conic (3) terms, d opacity =
// exp(power) dalpha and d colour = w dL/drgb. Output (9, P) fp32: row c
// holds component c of every pair, in the attribute order
// [x y A B C opacity r g b], pairs in binned order.
//
// What bounds it on this card: the pixel x pair evaluations on the CUDA
// cores (the OPS_BWD_* constants of ops/rasterize_cuda.py count them: 12
// for a pair that fails the power gate, 16 for one under the alpha gate,
// 59 for a live pair, the per-pair sum over the tile's pixels included).
// The bytes are small by comparison: each pair costs a 4-byte id and a
// 36-byte attribute gather shared by the tile's 256 pixels and writes 36
// bytes; each pixel reads 44 bytes.
//
// What held the one-CTA-a-tile design back: the busiest tile (5,276 walked
// pairs at the fit) ran on one SM, and there every pair's 9 gradient
// components were summed over each warp with 5 shuffles each: 360 warp
// shuffles a pair.
//
// The design:
//   - One CTA per chunk of gh::kCheckpoint = 64 pairs of a tile, all
//     independent, numbered tile by tile: tile t's chunks start at item
//     slot_base[t] + t, slot_base the forward's (composite_common.cuh), so
//     a CTA finds its tile by a scan of slot_base and no plan is built. The
//     chunk starts at its back end from the forward's checkpoint there,
//     T = T_b and r_b = dL/drgb . (rgb - C_b) + dL/dT T_final (C_b the
//     colour composited up to the boundary), or from (T_final, dL/dT
//     T_final) for a tile's last chunk. So a heavy tile's chunks run on
//     many SMs, each pair's sum over the tile's 256 pixels stays inside the
//     one CTA that owns the pair's chunk, and the division T / (1 - alpha)
//     runs over at most 64 pairs. A pixel skips exp where power is below
//     the pair's gh::power_floor (alpha < 1/255 there).
//   - Pairs are walked in groups of 32. Each warp reduces a group with a
//     transposed (butterfly) reduction: at level l = 0..4 the lanes of a
//     pair of partners each keep the half of the pending pairs their bit l
//     selects and add the partner's half, so after 31 shuffles a component
//     lane j holds the warp's sum for pair j of the group: about one
//     shuffle a pair and component per warp, not five, and the pending
//     halves wait in registers. The 8 warps' sums are then added in warp
//     order through shared memory (double-buffered, one barrier a group).
//   - Pairs behind every pixel's last composited pair get a zero row.
// Every sum is taken in a fixed order and nothing is atomic on floats, so
// the output is the same from run to run.
//
// Numerics: power and alpha are composite_common.cuh's, so every gate is
// decided as the forward decided it. T is recovered by division from the
// chunk's back end, as in the CUDA reference. Build without
// --use_fast_math.
#include "composite_common.cuh"

namespace {

using gh::kPix;

constexpr int kWarps = kPix / 32;
constexpr int kGrad = 9;                     // the attribute order
constexpr int kGroup = 32;                   // pairs a butterfly reduces
constexpr int kChunk = gh::kCheckpoint;      // pairs a CTA

// A CTA's chunk of a tile.
struct Chunk {
  int chunk;      // its number in the tile
  int n_chunks;   // the tile's, max(1, ceil(pairs / kChunk))
  int first;      // its first pair in pair_gid
  int count;      // its pairs, 0 for an empty tile
};

// Item i, of tile t: chunk i - (slot_base[t] + t). A tile of c pairs has
// max(0, ceil(c / kChunk) - 1) checkpoints and one chunk more.
__device__ __forceinline__ Chunk chunk_of(int i, int t,
                                          const int32_t* __restrict__ tile_range,
                                          const int32_t* __restrict__ slot_base) {
  Chunk c;
  c.chunk = i - (slot_base[t] + t);
  c.n_chunks = slot_base[t + 1] - slot_base[t] + 1;
  const int begin = tile_range[t];
  c.first = begin + c.chunk * kChunk;
  c.count = max(0, min(kChunk, tile_range[t + 1] - begin - c.chunk * kChunk));
  return c;
}

// The running state of one pixel's walk, back to front.
struct Walk {
  float T;        // T after the pair being walked
  float r;        // the suffix sum r_i of the header
  float gr, gg, gb;
  float px, py;
  int walked;     // the chunk's pairs this pixel composited some of
};

// The pixel's 9 gradient components for pair j of the chunk (0 when the
// pixel does not walk it or a gate rejects it), advancing the walk.
// s_color's w is the pair's gh::power_floor.
__device__ __forceinline__ void pair_grad(const gh::PairGeom* s_geom,
                                          const float4* s_color, int j,
                                          Walk& w, float g[kGrad]) {
#pragma unroll
  for (int c = 0; c < kGrad; ++c) g[c] = 0.0f;
  if (j < 0 || j >= w.walked) return;
  const gh::PairGeom geo = s_geom[j];
  const float4 col = s_color[j];
  float dx, dy, ep, alpha_raw;
  const float power = gh::pair_power(geo, w.px, w.py, dx, dy);
  if (!(power <= 0.0f && power >= col.w)) return;   // alpha < 1/255 here
  const float alpha = gh::pair_alpha(geo, power, ep, alpha_raw);
  if (alpha == 0.0f) return;
  const float4 co = geo.conic_opa;
  const float one_m = 1.0f - alpha;
  const float t_before = w.T / one_m;
  const float wt = alpha * t_before;
  const float e = w.gr * col.x + w.gg * col.y + w.gb * col.z;
  const float dalpha = e * t_before - w.r / one_m;
  w.r += wt * e;
  w.T = t_before;
  const float dpower = dalpha * alpha_raw;
  g[0] = -dpower * (co.x * dx + co.y * dy);
  g[1] = -dpower * (co.z * dy + co.y * dx);
  g[2] = -0.5f * dpower * dx * dx;
  g[3] = -dpower * dx * dy;
  g[4] = -0.5f * dpower * dy * dy;
  g[5] = ep * dalpha;
  g[6] = wt * w.gr;
  g[7] = wt * w.gg;
  g[8] = wt * w.gb;
}

// One butterfly level: `cur` holds the newer half of the pending pairs,
// `held` the older; the lanes whose bit `mask` is set keep the newer.
__device__ __forceinline__ void butterfly(float cur[kGrad],
                                          const float held[kGrad], int lane,
                                          int mask) {
  const bool newer = (lane & mask) != 0;
#pragma unroll
  for (int c = 0; c < kGrad; ++c) {
    const float keep = newer ? cur[c] : held[c];
    const float give = newer ? held[c] : cur[c];
    cur[c] = keep + __shfl_xor_sync(0xffffffffu, give, mask);
  }
}

__device__ __forceinline__ void hold(float dst[kGrad], const float src[kGrad]) {
#pragma unroll
  for (int c = 0; c < kGrad; ++c) dst[c] = src[c];
}

__global__ void __launch_bounds__(kPix, 2)
composite_bwd_kernel(const int32_t* __restrict__ tile_range,
                     const int32_t* __restrict__ pair_gid,
                     const float* __restrict__ attrs,
                     const int32_t* __restrict__ slot_base, int num_tiles,
                     int ntx, int height, int width,
                     const float* __restrict__ grad_rgb,
                     const float* __restrict__ grad_t,
                     const float* __restrict__ rgb,
                     const float* __restrict__ final_t,
                     const int32_t* __restrict__ n_contrib,
                     const float4* __restrict__ checkpoints, int n_pairs,
                     float* __restrict__ out_grad) {
  extern __shared__ float4 smem[];
  gh::PairGeom* s_geom = reinterpret_cast<gh::PairGeom*>(smem);
  float4* s_color = reinterpret_cast<float4*>(s_geom + kChunk);
  float* s_part = reinterpret_cast<float*>(s_color + kChunk);  // [2][warps][9][32]
  __shared__ int s_top;
  __shared__ int s_tile;

  const int tid = threadIdx.x;
  const int i = blockIdx.x;
  if (i >= slot_base[num_tiles] + num_tiles) return;
  if (tid == 0) s_top = 0;
  // the tile whose items [slot_base[t] + t, slot_base[t + 1] + t + 1) hold i
  for (int t = tid; t < num_tiles; t += kPix) {
    if (slot_base[t] + t <= i && i <= slot_base[t + 1] + t) s_tile = t;
  }
  __syncthreads();
  const int tile = s_tile;
  const Chunk it = chunk_of(i, tile, tile_range, slot_base);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pxi = (tile % ntx) * gh::kTile + tid % gh::kTile;
  const int pyi = (tile / ntx) * gh::kTile + tid / gh::kTile;

  Walk w = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, static_cast<float>(pxi),
            static_cast<float>(pyi), 0};
  if (pxi < width && pyi < height) {
    const size_t p = static_cast<size_t>(pyi) * width + pxi;
    const float t_final = final_t[p];
    w.gr = grad_rgb[3 * p + 0];
    w.gg = grad_rgb[3 * p + 1];
    w.gb = grad_rgb[3 * p + 2];
    w.T = t_final;
    w.r = grad_t[p] * t_final;
    if (it.chunk < it.n_chunks - 1) {
      const float4 ck = checkpoints[
          static_cast<size_t>(slot_base[tile] + it.chunk) * kPix + tid];
      w.T = ck.x;
      w.r += w.gr * (rgb[3 * p + 0] - ck.y) + w.gg * (rgb[3 * p + 1] - ck.z)
           + w.gb * (rgb[3 * p + 2] - ck.w);
    }
    w.walked = min(max(n_contrib[p] - it.chunk * kChunk, 0), it.count);
  }
  const int warp_top = __reduce_max_sync(0xffffffffu, w.walked);
  if (lane == 0 && warp_top > 0) atomicMax(&s_top, warp_top);
  for (int j = tid; j < it.count; j += kPix) {
    const float* a = attrs + static_cast<size_t>(pair_gid[it.first + j]) * gh::kAttr;
    s_geom[j].xy = make_float2(a[0], a[1]);
    s_geom[j].conic_opa = make_float4(a[2], a[3], a[4], a[5]);
    s_color[j] = make_float4(a[6], a[7], a[8], gh::power_floor(a[5]));
  }
  __syncthreads();
  const int top = s_top;

  // pairs behind every pixel's last composited pair get no gradient
  for (int j = top + tid; j < it.count; j += kPix) {
#pragma unroll
    for (int c = 0; c < kGrad; ++c)
      out_grad[static_cast<size_t>(c) * n_pairs + it.first + j] = 0.0f;
  }

  int buf = 0;
  for (int hi = top - 1; hi >= 0; hi -= kGroup) {
    // pair m of the group is hi - m; after the levels lane m holds its sum
    float cur[kGrad], h0[kGrad], h1[kGrad], h2[kGrad], h3[kGrad], h4[kGrad];
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      pair_grad(s_geom, s_color, hi - m, w, cur);
      if ((m & 1) == 0) { hold(h0, cur); continue; }
      butterfly(cur, h0, lane, 1);
      if ((m & 2) == 0) { hold(h1, cur); continue; }
      butterfly(cur, h1, lane, 2);
      if ((m & 4) == 0) { hold(h2, cur); continue; }
      butterfly(cur, h2, lane, 4);
      if ((m & 8) == 0) { hold(h3, cur); continue; }
      butterfly(cur, h3, lane, 8);
      if ((m & 16) == 0) { hold(h4, cur); continue; }
      butterfly(cur, h4, lane, 16);
    }
    float* part = s_part + buf * (kWarps * kGrad * kGroup);
#pragma unroll
    for (int c = 0; c < kGrad; ++c)
      part[(warp * kGrad + c) * kGroup + lane] = cur[c];
    __syncthreads();
    // The next group writes the other buffer; the one after it writes this
    // buffer only after its own barrier, which every thread reaches after
    // these reads.
    for (int s = tid; s < kGrad * kGroup; s += kPix) {
      const int c = s / kGroup;
      const int m = s % kGroup;
      const int j = hi - m;
      if (j < 0) continue;
      float sum = 0.0f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) sum += part[(v * kGrad + c) * kGroup + m];
      out_grad[static_cast<size_t>(c) * n_pairs + it.first + j] = sum;
    }
    buf ^= 1;
  }
}

}  // namespace

// Launches `max_items` (>= num_tiles + n_pairs / 64) CTAs on `stream` (a
// cudaStream_t); does not synchronise. `slot_base` (num_tiles + 1 ints) is
// the checkpoint slot bases of the forward that kept `checkpoints`
// (gh_composite_plan's). Returns cudaGetLastError() as an int, 0 on
// success.
extern "C" int gh_composite_backward(
    const void* tile_range, const void* pair_gid, const void* attrs,
    const void* slot_base, int num_tiles, int max_items, int ntx, int height,
    int width, const void* grad_rgb, const void* grad_t, const void* rgb,
    const void* final_t, const void* n_contrib, const void* checkpoints,
    int n_pairs, void* out_grad, void* stream) {
  const size_t smem =
      static_cast<size_t>(kChunk) * (sizeof(gh::PairGeom) + sizeof(float4)) +
      2 * kWarps * kGrad * kGroup * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_items > 0) {
    composite_bwd_kernel<<<max_items, kPix, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tile_range),
        static_cast<const int32_t*>(pair_gid),
        static_cast<const float*>(attrs),
        static_cast<const int32_t*>(slot_base), num_tiles, ntx, height, width,
        static_cast<const float*>(grad_rgb),
        static_cast<const float*>(grad_t), static_cast<const float*>(rgb),
        static_cast<const float*>(final_t),
        static_cast<const int32_t*>(n_contrib),
        static_cast<const float4*>(checkpoints), n_pairs,
        static_cast<float*>(out_grad));
  }
  return static_cast<int>(cudaGetLastError());
}
