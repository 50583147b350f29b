// Tile-composite backward of the 3DGS rasterizer, for Hopper (sm_90a).
//
// Replaces: guassianhand_tpu/ops/rasterize_pallas.py::composite_backward
// (body _bwd_kernel), reached from ops/rasterize.py::_composite_bwd.
//
// What it computes: for every (Gaussian, tile) pair, the gradient of the
// loss with respect to the pair's screen attributes, summed over the tile's
// pixels, from dL/drgb (H, W, 3), dL/dT_final (H, W) and the forward's
// final T (H, W) and n_contrib (H, W). Per pixel, back to front over the
// pairs the forward composited (those before n_contrib that pass the power
// and alpha gates):
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
// bytes; each pixel reads 28 bytes.
//
// What the design does about it: one CTA per 16 x 16 tile and one thread
// per pixel, as in the forward; pairs are staged 128 at a time in shared
// memory and walked back to front from the CTA's largest n_contrib, so a
// tile's pairs past every pixel's last composited pair are never evaluated
// (they get a zero row). Each pair belongs to exactly one tile, so its
// gradient is reduced inside the CTA that owns the tile: a warp shuffle
// sum, skipped when no lane of the warp is live, then a fixed-order sum of
// the 8 warps' partials in shared memory. No global atomics, and the result
// is the same from run to run. The TPU kernel's suffix matmul, one-hot
// reduction and DMA windows are TPU layout and are not carried over.
//
// Numerics: power and alpha are computed with the forward's round-to-
// nearest intrinsics, so every gate is decided as the forward decided it.
// T is recovered by division from the forward's final T, as in the CUDA
// reference. Build without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;          // threads per CTA
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 128;                  // pairs staged per batch
constexpr int kAttr = 9;                     // x y A B C opacity r g b
constexpr int kGrad = 9;                     // the same order
constexpr float kAlphaMin = 0.003921568859368563f;  // fp32(1/255)
constexpr float kAlphaMax = 0.99f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const int32_t* __restrict__ tile_range,
                     const int32_t* __restrict__ pair_gid,
                     const float* __restrict__ attrs, int ntx, int height,
                     int width, const float* __restrict__ grad_rgb,
                     const float* __restrict__ grad_t,
                     const float* __restrict__ final_t,
                     const int32_t* __restrict__ n_contrib, int n_pairs,
                     float* __restrict__ out_grad) {
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conic_opa[kBatch];
  __shared__ float s_r[kBatch];
  __shared__ float s_g[kBatch];
  __shared__ float s_b[kBatch];
  __shared__ float s_part[kWarps][kGrad][kBatch];
  __shared__ int s_max_contrib;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pxi = (tile % ntx) * kTile + tid % kTile;
  const int pyi = (tile / ntx) * kTile + tid / kTile;
  const bool inside = pxi < width && pyi < height;
  const float px = static_cast<float>(pxi);
  const float py = static_cast<float>(pyi);
  const int lo = tile_range[tile];
  const int hi = tile_range[tile + 1];

  float T = 1.0f;        // T after the pair being walked
  float r = 0.0f;        // the suffix sum r_i of the header
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;
  int n = 0;
  if (inside) {
    const size_t p = static_cast<size_t>(pyi) * width + pxi;
    T = final_t[p];
    n = n_contrib[p];
    gr = grad_rgb[3 * p + 0];
    gg = grad_rgb[3 * p + 1];
    gb = grad_rgb[3 * p + 2];
    r = grad_t[p] * T;
  }
  if (tid == 0) s_max_contrib = 0;
  __syncthreads();
  if (n > 0) atomicMax(&s_max_contrib, n);
  __syncthreads();
  const int max_contrib = s_max_contrib;

  // pairs behind every pixel's last composited pair get no gradient
  for (int k = lo + max_contrib + tid; k < hi; k += kPix) {
    for (int c = 0; c < kGrad; ++c)
      out_grad[static_cast<size_t>(c) * n_pairs + k] = 0.0f;
  }

  for (int end = lo + max_contrib; end > lo; end -= kBatch) {
    const int start = max(lo, end - kBatch);
    const int count = end - start;
    if (tid < count) {
      const float* a = attrs + static_cast<size_t>(pair_gid[start + tid]) * kAttr;
      s_xy[tid] = make_float2(a[0], a[1]);
      s_conic_opa[tid] = make_float4(a[2], a[3], a[4], a[5]);
      s_r[tid] = a[6];
      s_g[tid] = a[7];
      s_b[tid] = a[8];
    }
    __syncthreads();
    for (int j = count - 1; j >= 0; --j) {
      float g[kGrad] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bool live = false;
      if (start - lo + j < n) {
        const float2 xy = s_xy[j];
        const float4 co = s_conic_opa[j];
        const float dx = __fsub_rn(xy.x, px);
        const float dy = __fsub_rn(xy.y, py);
        // -0.5 * (A dx dx + C dy dy) - B dx dy, as the forward computes it
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (power <= 0.0f) {
          const float ep = expf(power);
          const float alpha_raw = __fmul_rn(co.w, ep);
          const float alpha = fminf(alpha_raw, kAlphaMax);
          if (alpha >= kAlphaMin) {
            live = true;
            const float one_m = 1.0f - alpha;
            const float t_before = T / one_m;
            const float w = alpha * t_before;
            const float e = gr * s_r[j] + gg * s_g[j] + gb * s_b[j];
            const float dalpha = e * t_before - r / one_m;
            r += w * e;
            T = t_before;
            const float dpower = dalpha * alpha_raw;
            g[0] = -dpower * (co.x * dx + co.y * dy);
            g[1] = -dpower * (co.z * dy + co.y * dx);
            g[2] = -0.5f * dpower * dx * dx;
            g[3] = -dpower * dx * dy;
            g[4] = -0.5f * dpower * dy * dy;
            g[5] = ep * dalpha;
            g[6] = w * gr;
            g[7] = w * gg;
            g[8] = w * gb;
          }
        }
      }
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int c = 0; c < kGrad; ++c) g[c] = warp_sum(g[c]);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kGrad; ++c) s_part[warp][c][j] = g[c];
      }
    }
    __syncthreads();
    // The next batch's loads touch only s_xy .. s_b, which no thread reads
    // past the barrier above; its walk writes s_part only after the barrier
    // that follows those loads, which every thread reaches after this sum.
    if (tid < count) {
#pragma unroll
      for (int c = 0; c < kGrad; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_part[w][c][tid];
        out_grad[static_cast<size_t>(c) * n_pairs + start + tid] = s;
      }
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t); does not synchronise. Returns
// cudaGetLastError() as an int, 0 on success.
extern "C" int gh_composite_backward(const void* tile_range,
                                     const void* pair_gid, const void* attrs,
                                     int num_tiles, int ntx, int height,
                                     int width, const void* grad_rgb,
                                     const void* grad_t, const void* final_t,
                                     const void* n_contrib, int n_pairs,
                                     void* out_grad, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, kPix, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tile_range),
        static_cast<const int32_t*>(pair_gid),
        static_cast<const float*>(attrs), ntx, height, width,
        static_cast<const float*>(grad_rgb), static_cast<const float*>(grad_t),
        static_cast<const float*>(final_t),
        static_cast<const int32_t*>(n_contrib), n_pairs,
        static_cast<float*>(out_grad));
  }
  return static_cast<int>(cudaGetLastError());
}
