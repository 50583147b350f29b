// Tile-composite forward of the 3DGS rasterizer, for Hopper (sm_90a).
//
// Replaces: guassianhand_tpu/ops/rasterize_pallas.py::composite_forward
// (body _fwd_kernel, helpers _block_alpha/_prefix_products/_forward_block),
// both calls: render mode (store_cpx=False) and training mode
// (store_cpx=True), which keeps what the backward needs.
//
// What it computes: per 16x16 pixel tile, front-to-back alpha compositing
// over the tile's depth-sorted (Gaussian, tile) pairs, with the acceptance
// rule of ops/common.py:
//   power = -0.5 (A dx^2 + C dy^2) - B dx dy;  skip the pair if power > 0
//   alpha = min(0.99, opacity * exp(power));   skip the pair if alpha < 1/255
//   stop before the pair that would take T (1 - alpha) below 1e-4
// Outputs: rgb (H, W, 3) = sum_i c_i alpha_i T_i and the final
// transmittance T (H, W), fp32. Training mode also writes n_contrib (H, W)
// int32: the count of the tile's pairs walked up to and including the
// pixel's last composited pair. The TPU kernel stores every pair's incoming
// T (cpx, TB x 256 x 128 floats) so that its backward can skip the prefix
// products; here each thread walks its pixel's pairs in sequence, so one
// int per pixel tells the backward (csrc/composite_bwd.cu) where to start
// its back-to-front walk, and it recovers T by division from final T. Both
// modes run the same instructions on the floats, so training mode's rgb and
// final T are bit-identical to render mode's.
//
// What bounds it on this card: the pixel x pair evaluations on the CUDA
// cores, 26 fp32 operations for a pair that is composited (a multiply-add
// counted as two, expf as one) and 12 or 16 for one a gate rejects; the
// OPS_* constants of ops/rasterize_cuda.py count them. The bytes are small by
// comparison: each pair costs a 4-byte id plus a 36-byte attribute gather
// that the 256 pixels of a tile share, and each pixel writes 16 bytes.
//
// What the design does about it: one CTA per tile with one thread per pixel,
// so every pair fetched is evaluated 256 times from shared memory; pairs
// come in batches of 256, one per thread, into structure-of-arrays shared
// memory (9 KB per batch); each thread walks the batch in depth order; the
// CTA leaves as soon as every pixel is done (__syncthreads_count). Pixels
// outside the image (image sizes that are not multiples of 16) help load and
// write nothing. The stacked multi-view canvas is one image to this kernel:
// its view bands are tile-row aligned.
//
// Numerics: power, alpha and T(1 - alpha) use round-to-nearest intrinsics,
// which the compiler never contracts into FMAs, so the gates see the same
// fp32 values as the plain PyTorch twin (ops/rasterize_cuda.py). expf is
// the accurate CUDA libm exp: build without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;          // threads per CTA, pairs per batch
constexpr int kAttr = 9;                     // x y A B C opacity r g b
constexpr float kAlphaMin = 0.003921568859368563f;  // fp32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const int32_t* __restrict__ tile_range,
                     const int32_t* __restrict__ pair_gid,
                     const float* __restrict__ attrs, int ntx, int height,
                     int width, float* __restrict__ out_rgb,
                     float* __restrict__ out_t,
                     int32_t* __restrict__ out_contrib) {
  __shared__ float2 s_xy[kPix];
  __shared__ float4 s_conic_opa[kPix];
  __shared__ float s_r[kPix];
  __shared__ float s_g[kPix];
  __shared__ float s_b[kPix];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int pxi = (tile % ntx) * kTile + tid % kTile;
  const int pyi = (tile / ntx) * kTile + tid / kTile;
  const bool inside = pxi < width && pyi < height;
  const float px = static_cast<float>(pxi);
  const float py = static_cast<float>(pyi);
  const int lo = tile_range[tile];
  const int hi = tile_range[tile + 1];

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int contrib = 0;
  bool done = !inside;

  for (int base = lo; base < hi; base += kPix) {
    // Also the barrier that keeps this batch's loads from overwriting
    // pairs that slower threads still read from the previous batch.
    if (__syncthreads_count(done) == kPix) break;
    const int k = base + tid;
    if (k < hi) {
      const float* a = attrs + static_cast<size_t>(pair_gid[k]) * kAttr;
      s_xy[tid] = make_float2(a[0], a[1]);
      s_conic_opa[tid] = make_float4(a[2], a[3], a[4], a[5]);
      s_r[tid] = a[6];
      s_g[tid] = a[7];
      s_b[tid] = a[8];
    }
    __syncthreads();
    const int n = min(kPix, hi - base);
    for (int j = 0; j < n && !done; ++j) {
      const float2 xy = s_xy[j];
      const float4 co = s_conic_opa[j];
      const float dx = __fsub_rn(xy.x, px);
      const float dy = __fsub_rn(xy.y, py);
      // -0.5 * (A dx dx + C dy dy) - B dx dy, in the twin's order
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                   __fmul_rn(__fmul_rn(co.z, dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                    __fmul_rn(__fmul_rn(co.y, dx), dy));
      if (power > 0.0f) continue;
      const float alpha = fminf(__fmul_rn(co.w, expf(power)), kAlphaMax);
      if (alpha < kAlphaMin) continue;
      const float test_t = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, T);
      cr += s_r[j] * w;
      cg += s_g[j] * w;
      cb += s_b[j] * w;
      T = test_t;
      contrib = base - lo + j + 1;
    }
  }

  if (inside) {
    const size_t p = static_cast<size_t>(pyi) * width + pxi;
    out_rgb[3 * p + 0] = cr;
    out_rgb[3 * p + 1] = cg;
    out_rgb[3 * p + 2] = cb;
    out_t[p] = T;
    if (out_contrib != nullptr) out_contrib[p] = contrib;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t); does not synchronise. `out_contrib`
// is null in render mode. Returns cudaGetLastError() as an int, 0 on success.
extern "C" int gh_composite_forward(const void* tile_range,
                                    const void* pair_gid, const void* attrs,
                                    int num_tiles, int ntx, int height,
                                    int width, void* out_rgb, void* out_t,
                                    void* out_contrib, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, kPix, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tile_range),
        static_cast<const int32_t*>(pair_gid),
        static_cast<const float*>(attrs), ntx, height, width,
        static_cast<float*>(out_rgb), static_cast<float*>(out_t),
        static_cast<int32_t*>(out_contrib));
  }
  return static_cast<int>(cudaGetLastError());
}
