// Sorted-segment sum for Hopper (sm_90a).
//
// Replaces: guassianhand_tpu/ops/segreduce_pallas.py::segment_reduce_sorted
// (-> _pallas_reduce, body _kernel), the rasterizer backward's reduction of
// per-pair gradients to per-Gaussian gradients.
//
// What it computes: out[s, r] = sum of vals[r, k] over the k whose
// ids[k] == s, for s in [0, n); ids (P,) int32 ascending, vals (R, P) fp32,
// out (n, R) fp32. Ids >= n are dropped; a segment with no ids gets 0.
//
// What bounds it on this card: bytes. Every value is read once and added
// once (R P additions against 4 (R + 1) P bytes read), so device memory at
// 3.35 TB/s is the limit: the ids, the values and the output, each moved
// once.
//
// What the design does about it: the Pallas kernel carries its sums across
// a sequential grid, which blocks on this card do not have. Here one thread
// owns one segment. It finds the segment's run of ids with two binary
// searches over the sorted ids, run in lockstep so that their loads
// overlap (the searches' dependent L2 round trips are most of the kernel's
// time: runs are about two pairs long on the fit path). It then walks its
// run once, reading up to kRowsAtOnce rows per step, so those loads are
// independent and in flight together, and writes its row of the output.
// Neighbouring threads own neighbouring runs, so a warp's reads fall on a
// few consecutive lines. Every output is written by the one thread that
// owns it and summed in a fixed order: no atomics, and the same result
// from run to run. The TPU kernel's window/chunk geometry, its one-hot
// matmul and its span guard are TPU layout and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsAtOnce = 16;

// The number of ids below key0 and below key1 (two lower bounds), by a
// branch-free binary search whose two probes share each step.
__device__ __forceinline__ void lower_bounds(const int32_t* __restrict__ ids,
                                             int n, int key0, int key1,
                                             int* pos0, int* pos1) {
  int a = 0, b = 0;
  int step = 1;
  while (step <= n) step <<= 1;
  for (step >>= 1; step > 0; step >>= 1) {
    const int ia = a + step, ib = b + step;
    const bool ta = ia <= n && ids[ia - 1] < key0;
    const bool tb = ib <= n && ids[ib - 1] < key1;
    a = ta ? ia : a;
    b = tb ? ib : b;
  }
  *pos0 = a;
  *pos1 = b;
}

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const int32_t* __restrict__ ids,
                      const float* __restrict__ vals, int n_items,
                      int n_rows, int n_segments, float* __restrict__ out) {
  const int seg = blockIdx.x * kThreads + threadIdx.x;
  if (seg >= n_segments) return;
  int lo, hi;
  lower_bounds(ids, n_items, seg, seg + 1, &lo, &hi);
  float* dst = out + static_cast<size_t>(seg) * n_rows;
  for (int r0 = 0; r0 < n_rows; r0 += kRowsAtOnce) {
    float acc[kRowsAtOnce];
#pragma unroll
    for (int j = 0; j < kRowsAtOnce; ++j) acc[j] = 0.0f;
    for (int k = lo; k < hi; ++k) {
#pragma unroll
      for (int j = 0; j < kRowsAtOnce; ++j) {
        if (r0 + j < n_rows)
          acc[j] += vals[static_cast<size_t>(r0 + j) * n_items + k];
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsAtOnce; ++j) {
      if (r0 + j < n_rows) dst[r0 + j] = acc[j];
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t); does not synchronise. Returns
// cudaGetLastError() as an int, 0 on success.
extern "C" int gh_segment_reduce_sorted(const void* ids, const void* vals,
                                        int n_items, int n_rows,
                                        int n_segments, void* out,
                                        void* stream) {
  if (n_segments > 0) {
    const int blocks = (n_segments + kThreads - 1) / kThreads;
    segment_reduce_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), static_cast<const float*>(vals),
        n_items, n_rows, n_segments, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
