// Exact softmax attention, forward and backward, for Hopper (sm_90a).
//
// Replaces: guassianhand_tpu/ops/blockwise_attention.py::
// _flash_attention_masked, which calls JAX's bundled Pallas TPU flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py: forward
// _flash_attention_impl, backward _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), reached with GH_FLASH_ATTN=1 from the
// interaction attention (nn/heads.py::SelfAttn).
//
// What it computes: for each head h of q, k, v (L, H, D) float32,
//   out = softmax(q k^T / sqrt(D)) v  and  lse = the rows' log-sum-exp,
// and in the backward, with delta = rowsum(dout * out) (a torch reduction,
// as JAX computes it outside its kernels),
//   P = exp(q k^T / sqrt(D) - lse),  dS = P * (dout v^T - delta),
//   dq = dS k / sqrt(D),  dk = dS^T q / sqrt(D),  dv = P^T dout.
// The mask of the JAX call (segment ids: masked rows neither attend nor are
// attended to, their outputs zeroed by the blend) is applied by the wrapper
// (ops/flash_attention_cuda.py): it gathers the L live rows, these kernels
// attend among them alone, and it scatters the result back, so masked rows
// get 0 out and 0 gradient and no score outside live x live is computed.
//
// What bounds it on this card: operations on the tensor cores. Every
// product runs as mma.sync m16n8k8 in TF32 with fp32 accumulation, in the
// split ("3xTF32") form: each fp32 operand x becomes hi = tf32_rna(x) and
// lo = tf32_rna(x - hi), and a.b is taken as hi.hi + hi.lo + lo.hi, the
// small terms first. One TF32 product alone keeps about 11 bits and misses
// the port's tolerances (out atol 2e-5 + rtol 1e-4, gradients 1e-4 *
// scale) by an order of magnitude; the split keeps the error within a small
// factor of a plain fp32 product's. Per score the products are 4 D flops
// forward, 8 D dkv and 6 D dq; three TF32 products each at 495 TFLOP/s
// dense give 165 TFLOP/s, so at the fit (L = 14,914, H = 4, D = 32:
// 889.7 M scores) the bound is 0.690 ms forward, 1.380 ms dkv and 1.035 ms
// dq. The rest (the max, one accurate expf, the sums, the split of P and
// dS: about 7 fp32 operations a score) stays under that.
//
// The design:
//   - A CTA is 4 warps and 64 rows of one head; each warp owns 16 rows (a
//     query in the forward and dq, a key in dkv), held as the MMA's A
//     fragments in registers, split once, the row operand of the scores
//     (q, or k in dkv) times the softmax scale first. 64 rows give
//     ceil(14,914 / 64) x 4 = 936 CTAs at the fit. The forward and dq fit
//     3 CTAs on an SM (about 69 KB of shared memory and 168 registers a
//     thread each), 396 at once on 132 SMs: 2.4 waves; dkv holds 2 (its
//     K and V fragments and four accumulators take 213 registers): 3.5.
//   - The other operand streams through shared memory in 64-row tiles,
//     double-buffered with cp.async (16 B a copy, rows past L zero-filled):
//     K and V in the forward and dq; Q, dout, lse and delta in dkv. The
//     next tile's copy is in flight while the current tile's MMAs run;
//     each thread splits the chunks it copied in place once they land
//     (raw in the hi half of a row, lo beside it), and one barrier a tile
//     publishes the split and frees the other buffer.
//   - P and dS never leave registers. The accumulator gives a thread
//     columns {2t, 2t+1} of an 8-column block (t = lane % 4) and the A
//     fragment wants columns {t, t+4}; since a sum over keys (queries in
//     dkv) does not care about order, A's column t is key 2t and column
//     t+4 key 2t+1, and the B fragment's rows are read in that order. So
//     the accumulator c0..c3 is the A fragment {c0, c2, c1, c3} as it
//     stands, and the online softmax's row max and sum are quad reductions.
//     The head dimension is permuted too: for products over d, k-step s
//     takes d = 8t + 2s and 8t + 2s + 1, adjacent, so a thread's two
//     16-byte loads of d = 8t..8t+7 hold four steps' B register pairs as
//     they stand; products into d read d = 4g..4g+3 (g = lane / 4) of two
//     rows. A shared row of 68 words (hi 32, lo 32, 4 of padding) keeps
//     both patterns free of bank conflicts.
//   - Rounding onto TF32 is done on the bits, two integer operations
//     (cvt.rna.tf32.f32 lowers to four on this card, a NaN guard among
//     them); a split is five. Products over d keep their small terms in an
//     accumulator of their own, added to the hi.hi terms at the end: two
//     independent chains of MMAs, and a smaller error.
//   - dkv and dq are two kernels, as in JAX: dkv gives a warp 16 keys and
//     loops over every query tile, recomputing P; dq gives a warp 16
//     queries and loops over every key tile. No sum crosses CTAs.
//   - Sums: each tile's products go into a fresh accumulator, which is
//     then added to the running one (rescaled by the online softmax's
//     correction in the forward): a blocked sum, so an output is a sum of
//     L / 64 partial sums rather than one chain of L / 8 MMA steps, whose
//     accumulation rounds far more coarsely than an fp32 add. Each output
//     element is written by one thread after a sum in a fixed order, with
//     no float atomics: two calls give the same bits.
//   - Keys past L score -inf (forward) or get P = 0 (backward), tested in
//     the last tile only; rows past L load zeros and write nothing.
// Head width D = 32, the interaction attention's (131 // 4); the TPU
// kernel's 512-row padding and (8, 128) blocks are TPU layout and are not
// carried over. expf and logf are the accurate libm functions: build
// without --use_fast_math. wgmma would reach the tensor cores' full rate,
// but tf32 wgmma reads B only K-major from shared memory, so P.V, dS^T.Q,
// P^T.dout and dS.K would each need a transposed copy of their tile.
//
// The bf16 kernels, for the bf16 q, k, v that the model's bf16 compute
// dtype gives, are csrc/flash_attention_bf16.cu (wgmma and TMA).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a CTA, 16 a warp
constexpr int kTile = 64;           // rows of the streamed operand a tile
constexpr int kD = 32;              // head width
constexpr int kRowWords = 2 * kD + 4;          // hi, lo, padding
constexpr int kBuf = kTile * kRowWords;        // floats a staged tensor
constexpr int kChunks = kTile * kD / 4;        // 16-byte copies a tensor
static_assert(kChunks % kThreads == 0, "copies split evenly");
constexpr int kCopies = kChunks / kThreads;    // a thread's, a tensor

// ---------------------------------------------------------------- split TF32

// cvt.rna.tf32.f32(x) for every x but a NaN: round to nearest, ties away
// from zero, onto 10 mantissa bits, on the bits. The instruction itself
// lowers to four operations on this card (a NaN guard among them), this to
// two.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// A fragment of m16n8k8 tf32 in its two halves.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// The accumulator of an 8-column block as the A fragment of a product over
// those columns: {c0, c2, c1, c3} (column t <- 2t, t + 4 <- 2t + 1).
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in split TF32: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, bl0, bl1);
  mma(d, a.hi, bh0, bh1);
}

// ----------------------------------------------------- fragments and tiles

__device__ __forceinline__ const float* row_ptr(const float* base, int row,
                                                int h, int heads) {
  return base + (static_cast<size_t>(row) * heads + h) * kD;
}

// A warp's 16 rows [r, r + 16) of head h, times mult, as the A fragments
// of a product over d: k-step s takes d = 8t + 2s (column t) and
// 8t + 2s + 1 (column t + 4).
__device__ __forceinline__ void load_a(const float* base, int r, int n, int h,
                                       int heads, float mult,
                                       FragA (&f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float x[2][8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + g + 8 * half;
    const float4* src =
        reinterpret_cast<const float4*>(row_ptr(base, row, h, heads) + 8 * t);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = row < n ? src[0] : zero;
    const float4 b = row < n ? src[1] : zero;
    x[half][0] = a.x; x[half][1] = a.y; x[half][2] = a.z; x[half][3] = a.w;
    x[half][4] = b.x; x[half][5] = b.y; x[half][6] = b.z; x[half][7] = b.w;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
    f[s] = split_a(x[0][2 * s] * mult, x[1][2 * s] * mult,
                   x[0][2 * s + 1] * mult, x[1][2 * s + 1] * mult);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// This thread's 16-byte copies of rows [r0, r0 + kTile) of head h into the
// hi halves of a staged tile; rows past n are zero-filled.
__device__ __forceinline__ void stage(float* buf, const float* base, int r0,
                                      int n, int h, int heads) {
#pragma unroll
  for (int m = 0; m < kCopies; ++m) {
    const int c = threadIdx.x + kThreads * m;
    const int row = c >> 3, col = 4 * (c & 7);
    const bool valid = r0 + row < n;
    cp_async16(buf + row * kRowWords + col,
               valid ? row_ptr(base, r0 + row, h, heads) + col : base, valid);
  }
}

// Splits in place the chunks this thread staged: hi over the raw value, lo
// beside it. Call after the copies landed.
__device__ __forceinline__ void split_staged(float* buf) {
#pragma unroll
  for (int m = 0; m < kCopies; ++m) {
    const int c = threadIdx.x + kThreads * m;
    float* p = buf + (c >> 3) * kRowWords + 4 * (c & 7);
    const float4 x = *reinterpret_cast<const float4*>(p);
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(p) = hi;
    *reinterpret_cast<uint4*>(p + kD) = lo;
  }
}

// B of a product over d with the tile's rows as columns: rows rb + g,
// d = 8t..8t+7; k-step s is the adjacent pair d = 8t + 2s, 8t + 2s + 1, so
// each 16-byte load holds two steps' register pairs as they stand.
struct RowB {
  uint4 hi0, hi1, lo0, lo1;
};

__device__ __forceinline__ RowB load_row_b(const float* buf, int rb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = buf + (rb + g) * kRowWords + 8 * t;
  RowB b;
  b.hi0 = *reinterpret_cast<const uint4*>(p);
  b.hi1 = *reinterpret_cast<const uint4*>(p + 4);
  b.lo0 = *reinterpret_cast<const uint4*>(p + kD);
  b.lo1 = *reinterpret_cast<const uint4*>(p + kD + 4);
  return b;
}

__device__ __forceinline__ uint32_t lane4(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d = a . (8 tile rows)^T over d, the 4 k-steps of D = 32: the small
// terms of all four steps in an accumulator of their own, the hi.hi terms
// in d, then the two added. Two independent chains of MMAs, and the small
// terms are summed among themselves before they meet the large ones.
__device__ __forceinline__ void mma_over_d(float (&d)[4], const FragA (&a)[4],
                                           const RowB& b) {
  float sm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(sm, a[0].lo, b.hi0.x, b.hi0.y);
  mma(sm, a[0].hi, b.lo0.x, b.lo0.y);
  mma(sm, a[1].lo, b.hi0.z, b.hi0.w);
  mma(sm, a[1].hi, b.lo0.z, b.lo0.w);
  mma(sm, a[2].lo, b.hi1.x, b.hi1.y);
  mma(sm, a[2].hi, b.lo1.x, b.lo1.y);
  mma(sm, a[3].lo, b.hi1.z, b.hi1.w);
  mma(sm, a[3].hi, b.lo1.z, b.lo1.w);
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] = 0.0f;
  mma(d, a[0].hi, b.hi0.x, b.hi0.y);
  mma(d, a[1].hi, b.hi0.z, b.hi0.w);
  mma(d, a[2].hi, b.hi1.x, b.hi1.y);
  mma(d, a[3].hi, b.hi1.z, b.hi1.w);
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] += sm[c];
}

// B of a product over the tile's rows into d: rows rb + 2t and rb + 2t + 1
// (A's columns t and t + 4), d = 4g..4g+3; n-block j is d = 4g + j.
struct ColB {
  uint4 hi0, lo0, hi1, lo1;
};

__device__ __forceinline__ ColB load_col_b(const float* buf, int rb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = buf + (rb + 2 * t) * kRowWords + 4 * g;
  ColB b;
  b.hi0 = *reinterpret_cast<const uint4*>(p);
  b.lo0 = *reinterpret_cast<const uint4*>(p + kD);
  b.hi1 = *reinterpret_cast<const uint4*>(p + kRowWords);
  b.lo1 = *reinterpret_cast<const uint4*>(p + kRowWords + kD);
  return b;
}

// d[j] += a . (8 tile rows) for the 4 n-blocks of D = 32.
__device__ __forceinline__ void mma_into_d(float (&d)[4][4], const FragA& a,
                                           const ColB& b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    mma3(d[j], a, lane4(b.hi0, j), lane4(b.hi1, j), lane4(b.lo0, j),
         lane4(b.lo1, j));
}

__device__ __forceinline__ void zero(float (&d)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[j][c] = 0.0f;
}

// Rows r + g and r + g + 8 of an output from its n-block accumulators:
// c0 of block j is d = 8t + j, c1 d = 8t + 4 + j (c2, c3 the second row).
__device__ __forceinline__ void store_d(float* base, int r, int n, int h,
                                        int heads, const float (&d)[4][4],
                                        float mult0, float mult1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + g + 8 * half;
    if (row >= n) continue;
    const float mult = half ? mult1 : mult0;
    const int c = 2 * half;
    float4* dst = reinterpret_cast<float4*>(
        base + (static_cast<size_t>(row) * heads + h) * kD + 8 * t);
    dst[0] = make_float4(d[0][c] * mult, d[1][c] * mult, d[2][c] * mult,
                         d[3][c] * mult);
    dst[1] = make_float4(d[0][c + 1] * mult, d[1][c + 1] * mult,
                         d[2][c + 1] * mult, d[3][c + 1] * mult);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int kBlocks = kTile / 8;  // 8-row blocks of a tile

// ------------------------------------------------------------------ kernels

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int n, int heads, float scale,
                 float* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ __align__(16) float smem[];  // [stage][K, V][kBuf]
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  FragA qa[4];
  load_a(q, r, n, h, heads, scale, qa);  // the scores come out scaled
  float acc[4][4];
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY;  // rows r + g, r + g + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's columns' sums

  const int tiles = (n + kTile - 1) / kTile;
  stage(smem, k, 0, n, h, heads);
  stage(smem + kBuf, v, 0, n, h, heads);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    float* ks = smem + (i & 1) * 2 * kBuf;
    float* vs = ks + kBuf;
    cp_async_wait_all();
    split_staged(ks);
    split_staged(vs);
    // the split visible to all; every warp is done with the other stage
    __syncthreads();
    if (i + 1 < tiles) {
      float* next = smem + ((i + 1) & 1) * 2 * kBuf;
      stage(next, k, (i + 1) * kTile, n, h, heads);
      stage(next + kBuf, v, (i + 1) * kTile, n, h, heads);
      cp_async_commit();
    }
    const int k0 = i * kTile;
    float s[kBlocks][4];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b)
      mma_over_d(s[b], qa, load_row_b(ks, 8 * b));
    if (k0 + kTile > n) {  // the last tile: keys past n score -inf
#pragma unroll
      for (int b = 0; b < kBlocks; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + 8 * b + 2 * t + (c & 1) >= n) s[b][c] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      mx0 = fmaxf(mx0, fmaxf(s[b][0], s[b][1]));
      mx1 = fmaxf(mx1, fmaxf(s[b][2], s[b][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float part[4][4];
    zero(part);
    float lp0 = 0.0f, lp1 = 0.0f;
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      s[b][0] = expf(s[b][0] - mx0);
      s[b][1] = expf(s[b][1] - mx0);
      s[b][2] = expf(s[b][2] - mx1);
      s[b][3] = expf(s[b][3] - mx1);
      lp0 += s[b][0] + s[b][1];
      lp1 += s[b][2] + s[b][3];
      mma_into_d(part, acc_as_a(s[b]), load_col_b(vs, 8 * b));
    }
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);  // 0 first
    l0 = fmaf(l0, corr0, lp0);
    l1 = fmaf(l1, corr1, lp1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][0] = fmaf(acc[j][0], corr0, part[j][0]);
      acc[j][1] = fmaf(acc[j][1], corr0, part[j][1]);
      acc[j][2] = fmaf(acc[j][2], corr1, part[j][2]);
      acc[j][3] = fmaf(acc[j][3], corr1, part[j][3]);
    }
    m0 = mx0;
    m1 = mx1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_d(out, r, n, h, heads, acc, 1.0f / l0, 1.0f / l1);
  if (t == 0) {
    float* lse_h = lse + static_cast<size_t>(h) * n;
    if (r + g < n) lse_h[r + g] = m0 + logf(l0);
    if (r + g + 8 < n) lse_h[r + g + 8] = m1 + logf(l1);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int n, int heads,
                 float scale, float* __restrict__ dk, float* __restrict__ dv) {
  // [stage][Q, dout][kBuf], then [stage][lse, delta][kTile]
  extern __shared__ __align__(16) float smem[];
  float* rows_lse = smem + 4 * kBuf;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  FragA ka[4], va[4];
  load_a(k, r, n, h, heads, scale, ka);  // the scores come out scaled
  load_a(v, r, n, h, heads, 1.0f, va);
  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);
  const float* lse_h = lse + static_cast<size_t>(h) * n;
  const float* delta_h = delta + static_cast<size_t>(h) * n;

  auto stage_all = [&](int i) {
    float* buf = smem + (i & 1) * 2 * kBuf;
    const int q0 = i * kTile;
    stage(buf, q, q0, n, h, heads);
    stage(buf + kBuf, dout, q0, n, h, heads);
    // threads 0..63 copy lse, 64..127 delta
    const int j = threadIdx.x & (kTile - 1);
    const bool is_lse = threadIdx.x < kTile;
    const bool valid = q0 + j < n;
    cp_async4(rows_lse + (i & 1) * 2 * kTile + (is_lse ? 0 : kTile) + j,
              (is_lse ? lse_h : delta_h) + (valid ? q0 + j : 0), valid);
    cp_async_commit();
  };

  const int tiles = (n + kTile - 1) / kTile;
  stage_all(0);
  for (int i = 0; i < tiles; ++i) {
    float* qs = smem + (i & 1) * 2 * kBuf;
    float* dos = qs + kBuf;
    const float* l_s = rows_lse + (i & 1) * 2 * kTile;
    const float* d_s = l_s + kTile;
    cp_async_wait_all();
    split_staged(qs);
    split_staged(dos);
    __syncthreads();
    if (i + 1 < tiles) stage_all(i + 1);
    const int q0 = i * kTile;
    const bool tail = q0 + kTile > n;  // queries past n: P = 0
    float pdk[4][4], pdv[4][4];
    zero(pdk);
    zero(pdv);
#pragma unroll 2
    for (int b = 0; b < kBlocks; ++b) {
      float st[4], dpt[4];
      mma_over_d(st, ka, load_row_b(qs, 8 * b));
      mma_over_d(dpt, va, load_row_b(dos, 8 * b));
      // column c & 1 of the block: query 2t or 2t + 1
      const float2 lse2 =
          *reinterpret_cast<const float2*>(l_s + 8 * b + 2 * t);
      const float2 del2 =
          *reinterpret_cast<const float2*>(d_s + 8 * b + 2 * t);
      const int qi = q0 + 8 * b + 2 * t;
      float p[4], dsv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool odd = c & 1;
        p[c] = expf(st[c] - (odd ? lse2.y : lse2.x));
        if (tail && qi + odd >= n) p[c] = 0.0f;
        dsv[c] = p[c] * (dpt[c] - (odd ? del2.y : del2.x));
      }
      mma_into_d(pdv, acc_as_a(p), load_col_b(dos, 8 * b));
      mma_into_d(pdk, acc_as_a(dsv), load_col_b(qs, 8 * b));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dk_acc[j][c] += pdk[j][c];
        dv_acc[j][c] += pdv[j][c];
      }
  }
  store_d(dk, r, n, h, heads, dk_acc, scale, scale);
  store_d(dv, r, n, h, heads, dv_acc, 1.0f, 1.0f);
}

__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, int n, int heads,
                float scale, float* __restrict__ dq) {
  extern __shared__ __align__(16) float smem[];  // [stage][K, V][kBuf]
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  FragA qa[4], da[4];
  load_a(q, r, n, h, heads, scale, qa);  // the scores come out scaled
  load_a(dout, r, n, h, heads, 1.0f, da);
  const float* lse_h = lse + static_cast<size_t>(h) * n;
  const float* delta_h = delta + static_cast<size_t>(h) * n;
  const float lse0 = r + g < n ? lse_h[r + g] : 0.0f;
  const float lse1 = r + g + 8 < n ? lse_h[r + g + 8] : 0.0f;
  const float del0 = r + g < n ? delta_h[r + g] : 0.0f;
  const float del1 = r + g + 8 < n ? delta_h[r + g + 8] : 0.0f;
  float acc[4][4];
  zero(acc);

  const int tiles = (n + kTile - 1) / kTile;
  stage(smem, k, 0, n, h, heads);
  stage(smem + kBuf, v, 0, n, h, heads);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    float* ks = smem + (i & 1) * 2 * kBuf;
    float* vs = ks + kBuf;
    cp_async_wait_all();
    split_staged(ks);
    split_staged(vs);
    __syncthreads();
    if (i + 1 < tiles) {
      float* next = smem + ((i + 1) & 1) * 2 * kBuf;
      stage(next, k, (i + 1) * kTile, n, h, heads);
      stage(next + kBuf, v, (i + 1) * kTile, n, h, heads);
      cp_async_commit();
    }
    const int k0 = i * kTile;
    const bool tail = k0 + kTile > n;  // keys past n: P = 0
    float part[4][4];
    zero(part);
#pragma unroll 2
    for (int b = 0; b < kBlocks; ++b) {
      float s[4], dp[4];
      mma_over_d(s, qa, load_row_b(ks, 8 * b));
      mma_over_d(dp, da, load_row_b(vs, 8 * b));
      const int key = k0 + 8 * b + 2 * t;
      float dsv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool second = c >= 2;
        float p = expf(s[c] - (second ? lse1 : lse0));
        if (tail && key + (c & 1) >= n) p = 0.0f;
        dsv[c] = p * (dp[c] - (second ? del1 : del0));
      }
      mma_into_d(part, acc_as_a(dsv), load_col_b(ks, 8 * b));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] += part[j][c];
  }
  store_d(dq, r, n, h, heads, acc, scale, scale);
}

constexpr int kSmemKV = 2 * 2 * kBuf * 4;                 // bytes
constexpr int kSmemDkv = kSmemKV + 2 * 2 * kTile * 4;     // + lse, delta

dim3 grid_for(int n, int heads) {
  return dim3((n + kRows - 1) / kRows, heads);
}

}  // namespace

// All three launch on `stream` (a cudaStream_t) and do not synchronise.
// q, k, v, out, dout, dq, dk, dv are contiguous (n, heads, 32) float32;
// lse and delta (heads, n). Each returns cudaGetLastError() as an int, 0 on
// success.
extern "C" int gh_flash_forward(const void* q, const void* k, const void* v,
                                int n, int heads, float scale, void* out,
                                void* lse, void* stream) {
  if (n > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemKV);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_kernel<<<grid_for(n, heads), kThreads, kSmemKV,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), n, heads, scale,
        static_cast<float*>(out), static_cast<float*>(lse));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gh_flash_backward_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     int n, int heads, float scale, void* dk,
                                     void* dv, void* stream) {
  if (n > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemDkv);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dkv_kernel<<<grid_for(n, heads), kThreads, kSmemDkv,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), n,
        heads, scale, static_cast<float*>(dk), static_cast<float*>(dv));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gh_flash_backward_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta, int n,
                                    int heads, float scale, void* dq,
                                    void* stream) {
  if (n > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemKV);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dq_kernel<<<grid_for(n, heads), kThreads, kSmemKV,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), n,
        heads, scale, static_cast<float*>(dq));
  }
  return static_cast<int>(cudaGetLastError());
}
