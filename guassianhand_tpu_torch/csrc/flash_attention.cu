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
// What bounds it on this card: operations. Per head the forward does
// 4 L^2 D flops, the backward 8 L^2 D (dkv) and 6 L^2 D (dq) plus an exp
// per score; at the fit, L = 15,404 and D = 32, that is 121 GFLOP forward
// against 7 MB of q, k, v and out. The fp32 parity of the port (TF32 off)
// rules out the tensor cores: TF32 or bf16 mma would break the 2e-5
// tolerance, so the products run as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak).
//
// What the design does about it: one thread owns one row (a query in the
// forward and dq, a key in dkv) and keeps it, and its accumulators, in
// registers; a CTA of 128 rows of one head streams the other operand in
// 64-row tiles through shared memory, where every thread reads the same
// row at once (a broadcast), as float4: one shared load feeds 4 FMAs. The
// forward is the online softmax: scores in chunks of 16, summed apart and
// added to the running sums with one rescale a chunk (a blocked sum, which
// rounds less than one sequence of 15k terms). dkv gives a CTA a block of keys and loops over all
// query tiles; dq gives a CTA a block of queries and loops over all key
// tiles. Each output element is written by the thread that owns it after a
// sum in a fixed order: no atomics, the same result from run to run. Rows
// past L (L not a multiple of the block) help load and write nothing.
// Head width D = 32, the interaction attention's (131 // 4); the TPU
// kernel's 512-row padding and (8, 128) blocks are TPU layout and are not
// carried over. expf and logf are the accurate libm functions: build
// without --use_fast_math.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // rows a CTA, one a thread
constexpr int kTile = 64;      // rows of the streamed operand a shared tile
constexpr int kChunk = 16;     // forward scores between two rescales
constexpr int kD = 32;         // head width
constexpr int kV = kD / 4;     // float4 a row

__device__ __forceinline__ const float4* row_ptr(const float* base, int row,
                                                 int h, int heads) {
  return reinterpret_cast<const float4*>(
      base + (static_cast<size_t>(row) * heads + h) * kD);
}

__device__ __forceinline__ void load_row(const float* base, int row, int h,
                                         int heads, bool live, float* r) {
  const float4* src = row_ptr(base, row, h, heads);
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    const float4 x = live ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * c] = x.x;
    r[4 * c + 1] = x.y;
    r[4 * c + 2] = x.z;
    r[4 * c + 3] = x.w;
  }
}

__device__ __forceinline__ void store_row(float* base, int row, int h,
                                          int heads, const float* r,
                                          float mult) {
  float4* dst = reinterpret_cast<float4*>(
      base + (static_cast<size_t>(row) * heads + h) * kD);
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    dst[c] = make_float4(r[4 * c] * mult, r[4 * c + 1] * mult,
                         r[4 * c + 2] * mult, r[4 * c + 3] * mult);
  }
}

// rows [row0, row0 + valid) of head h into a (kTile, kD) shared tile; the
// rest of the tile is 0
__device__ __forceinline__ void load_tile(float4* tile, const float* base,
                                          int row0, int valid, int h,
                                          int heads) {
  for (int i = threadIdx.x; i < kTile * kV; i += kThreads) {
    const int r = i / kV;
    tile[i] = r < valid ? row_ptr(base, row0 + r, h, heads)[i % kV]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float dot_row(const float* r, const float4* t) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    const float4 x = t[c];
    acc = fmaf(r[4 * c], x.x, acc);
    acc = fmaf(r[4 * c + 1], x.y, acc);
    acc = fmaf(r[4 * c + 2], x.z, acc);
    acc = fmaf(r[4 * c + 3], x.w, acc);
  }
  return acc;
}

__device__ __forceinline__ void axpy_row(float a, const float4* t, float* r) {
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    const float4 x = t[c];
    r[4 * c] = fmaf(a, x.x, r[4 * c]);
    r[4 * c + 1] = fmaf(a, x.y, r[4 * c + 1]);
    r[4 * c + 2] = fmaf(a, x.z, r[4 * c + 2]);
    r[4 * c + 3] = fmaf(a, x.w, r[4 * c + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int n, int heads, float scale,
                 float* __restrict__ out, float* __restrict__ lse) {
  __shared__ float4 s_k[kTile * kV];
  __shared__ float4 s_v[kTile * kV];
  const int h = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  float qr[kD], acc[kD];
  load_row(q, row, h, heads, live, qr);
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    const int nk = min(kTile, n - k0);
    __syncthreads();  // the previous tile is read by every thread
    load_tile(s_k, k, k0, nk, h, heads);
    load_tile(s_v, v, k0, nk, h, heads);
    __syncthreads();
    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float dot = dot_row(qr, s_k + (c0 + j) * kV);
        s[j] = c0 + j < nk ? dot * scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      // the chunk's sums apart, then one rescale-and-add into the running
      // ones: each output is a sum of L / kChunk partial sums, not of L
      // terms in one sequence
      float part[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) part[d] = 0.0f;
      float l_part = 0.0f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - mx);
        l_part += p;
        axpy_row(p, s_v + (c0 + j) * kV, part);
      }
      const float corr = expf(m - mx);  // 0 before the first chunk
      l = fmaf(l, corr, l_part);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(acc[d], corr, part[d]);
      m = mx;
    }
  }
  if (live) {
    store_row(out, row, h, heads, acc, 1.0f / l);
    lse[static_cast<size_t>(h) * n + row] = m + logf(l);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int n, int heads,
                 float scale, float* __restrict__ dk, float* __restrict__ dv) {
  __shared__ float4 s_q[kTile * kV];
  __shared__ float4 s_do[kTile * kV];
  __shared__ float s_lse[kTile];
  __shared__ float s_delta[kTile];
  const int h = blockIdx.y;
  const int key = blockIdx.x * kThreads + threadIdx.x;
  const bool live = key < n;
  float kr[kD], vr[kD], dkr[kD], dvr[kD];
  load_row(k, key, h, heads, live, kr);
  load_row(v, key, h, heads, live, vr);
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dkr[d] = 0.0f;
    dvr[d] = 0.0f;
  }
  const float* lse_h = lse + static_cast<size_t>(h) * n;
  const float* delta_h = delta + static_cast<size_t>(h) * n;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    const int nq = min(kTile, n - q0);
    __syncthreads();
    load_tile(s_q, q, q0, nq, h, heads);
    load_tile(s_do, dout, q0, nq, h, heads);
    if (threadIdx.x < kTile) {
      const bool in = threadIdx.x < nq;
      s_lse[threadIdx.x] = in ? lse_h[q0 + threadIdx.x] : 0.0f;
      s_delta[threadIdx.x] = in ? delta_h[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float4* qi = s_q + i * kV;
      const float4* doi = s_do + i * kV;
      const float p = expf(dot_row(kr, qi) * scale - s_lse[i]);
      const float ds = p * (dot_row(vr, doi) - s_delta[i]);
      axpy_row(p, doi, dvr);
      axpy_row(ds, qi, dkr);
    }
  }
  if (live) {
    store_row(dk, key, h, heads, dkr, scale);
    store_row(dv, key, h, heads, dvr, 1.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, int n, int heads,
                float scale, float* __restrict__ dq) {
  __shared__ float4 s_k[kTile * kV];
  __shared__ float4 s_v[kTile * kV];
  const int h = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  float qr[kD], dor[kD], dqr[kD];
  load_row(q, row, h, heads, live, qr);
  load_row(dout, row, h, heads, live, dor);
#pragma unroll
  for (int d = 0; d < kD; ++d) dqr[d] = 0.0f;
  const float lse_i = live ? lse[static_cast<size_t>(h) * n + row] : 0.0f;
  const float delta_i = live ? delta[static_cast<size_t>(h) * n + row] : 0.0f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    const int nk = min(kTile, n - k0);
    __syncthreads();
    load_tile(s_k, k, k0, nk, h, heads);
    load_tile(s_v, v, k0, nk, h, heads);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float4* kj = s_k + j * kV;
      const float p = expf(dot_row(qr, kj) * scale - lse_i);
      const float ds = p * (dot_row(dor, s_v + j * kV) - delta_i);
      axpy_row(ds, kj, dqr);
    }
  }
  if (live) store_row(dq, row, h, heads, dqr, scale);
}

dim3 grid_for(int n, int heads) {
  return dim3((n + kThreads - 1) / kThreads, heads);
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
    flash_fwd_kernel<<<grid_for(n, heads), kThreads, 0,
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
    flash_dkv_kernel<<<grid_for(n, heads), kThreads, 0,
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
    flash_dq_kernel<<<grid_for(n, heads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), n,
        heads, scale, static_cast<float*>(dq));
  }
  return static_cast<int>(cudaGetLastError());
}
