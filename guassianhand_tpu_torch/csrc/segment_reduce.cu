// Sorted-segment sum for Hopper (sm_90a), optionally read through a
// permutation.
//
// Replaces: guassianhand_tpu/ops/segreduce_pallas.py::segment_reduce_sorted
// (-> _pallas_reduce, body _kernel), the rasterizer backward's reduction of
// per-pair gradients to per-Gaussian gradients, together with the key-value
// sort that puts the pairs in Gaussian order before it
// (guassianhand_tpu/ops/rasterize.py:387-389).
//
// What it computes: out[s, r] = the sum of vals[r, p(k)] over the k whose
// ids[p(k)] == s, for s in [0, n), with p(k) = order[k] when an order is
// given and p(k) = k otherwise; ids[p(k)] ascend in k. ids (P,) int32,
// order (P,) int32, vals (R, P) fp32, out (n, R) fp32. Ids outside [0, n)
// are dropped; a segment with no ids gets 0. Each sum is taken in ascending
// k, from 0: the same additions in the same order as one thread walking
// the segment, so the result does not depend on the launch.
//
// What bounds it on this card: bytes, and below them launch latency. Every
// value is read once and added once (R P additions against 4 (R + 2) P
// bytes read): device memory at 3.35 TB/s is the limit for the ids, the
// order, the values and the output, each moved once. Read through the
// order, the ids and values are a gather: each 4-byte value brings its own
// 32-byte sector, and at the fit that traffic (one sector a value, all in
// L2, where the backward has just written them) takes more time than the
// rest of the kernel; the gather into Gaussian order that the backward ran
// as a separate pass before this kernel cost the same.
//
// What the design does about it: one thread per sorted item; no search.
// Thread k reads p(k) (coalesced) and ids[p(k)]; the first kPeek lanes also
// read p(k + 32) and its id, the next warp's first items, since only the
// warp's last run can go on past the warp, and mostly into the next warp's
// first few items. The neighbours' ids come by warp shuffles (the warp's
// first lane loads the one before the warp), so each lane knows whether
// its item starts or ends a run, and a ballot of the run ends gives each
// run-start lane its run within the warp. Every lane asks for the 9 values
// of its item beside its id, and for those of a next warp's item where the
// warp's last run takes it: at most three dependent loads (position, id,
// values) for everything a warp sums in the common case. The start lane
// adds its run's values, shuffled to it one item at a time, in ascending
// k; every row is shuffled with no branch between the shuffles, so they
// overlap (a branch between them made each wait out the one before). A run
// longer than that is walked on by the whole warp 32 items at a time
// (positions, ids and values loaded by all lanes, the sum kept by the
// start lane), so a run of thousands of pairs costs a loop of warp-wide
// steps, not a thread's serial walk. The start lane of each run also
// zero-fills the empty segments between the previous id and its own, and
// the last item's lane those after it; the warp writes each such gap
// together, coalesced, while the values are still on their way. A launch
// with no items fills the output with zeros, so no memset is needed. Every
// output is written by one lane, in a fixed order, with no atomics: two
// calls are equal to the bit. Nine rows a pass and at most 64 registers
// keep 8 CTAs of 128 threads (32 warps) on an SM. The TPU kernel's
// window/chunk geometry, its one-hot matmul and its span guard are TPU
// layout and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsAtOnce = 9;  // rows a pass: the backward's 9 in one
constexpr int kPeek = 8;  // the next warp's items a warp looks at first
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int item_pos(const int32_t* __restrict__ order,
                                        int k) {
  return order ? __ldg(order + k) : k;
}

__device__ __forceinline__ int clamp_to(int x, int n) {
  return x < 0 ? 0 : (x > n ? n : x);
}

// Zero rows [a, b) of `out` (n_rows floats a row), the warp together, for
// every lane whose `has` is set and whose [a, b) is not empty (a warp pays
// a step for each such lane, so lanes with nothing to fill stay out).
__device__ __forceinline__ void fill_gaps(float* __restrict__ out, int n_rows,
                                          bool has, int a, int b, int lane) {
  unsigned todo = __ballot_sync(kFull, has && a < b);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    float* gap = out + static_cast<size_t>(__shfl_sync(kFull, a, src)) * n_rows;
    const int len = (__shfl_sync(kFull, b, src) - __shfl_sync(kFull, a, src))
                    * n_rows;
    for (int t = lane; t < len; t += 32) gap[t] = 0.0f;
  }
}

// Rows [r0, r0 + kRowsAtOnce) of vals (n_items values a row, n_rows rows)
// at item position `pos`, where `take`; 0 elsewhere.
__device__ __forceinline__ void load_rows(float (&v)[kRowsAtOnce],
                                          const float* __restrict__ vals,
                                          int n_items, int r0, int n_rows,
                                          int pos, bool take) {
#pragma unroll
  for (int j = 0; j < kRowsAtOnce; ++j)
    v[j] = (take && r0 + j < n_rows)
               ? __ldg(vals + static_cast<size_t>(r0 + j) * n_items + pos)
               : 0.0f;
}

// Adds to acc the values of the crossing run's items in lanes [0, count)
// of w, in lane order, on the owner lane. Every row is shuffled, past the
// last too (they hold 0 and are never stored): a branch between the
// shuffles would make each wait for the one before.
__device__ __forceinline__ void add_lanes(float (&acc)[kRowsAtOnce],
                                          const float (&w)[kRowsAtOnce],
                                          int count, int owner, int lane) {
  for (int t = 0; t < count; ++t) {
#pragma unroll
    for (int j = 0; j < kRowsAtOnce; ++j) {
      const float x = __shfl_sync(kFull, w[j], t);
      if (lane == owner) acc[j] += x;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 8)
segment_reduce_kernel(const int32_t* __restrict__ ids,
                      const int32_t* __restrict__ order,
                      const float* __restrict__ vals, int n_items,
                      int n_rows, int n_segments, float* __restrict__ out) {
  if (n_items == 0) {  // no items: every segment is empty
    const size_t total = static_cast<size_t>(n_segments) * n_rows;
    for (size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
         t < total; t += static_cast<size_t>(gridDim.x) * kThreads)
      out[t] = 0.0f;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int warp_first = k - lane;
  if (warp_first >= n_items) return;  // the whole warp is past the items

  // this warp's items and the next warp's first kPeek, which may finish
  // this warp's last run: positions, then ids, each one load wide
  const bool valid = k < n_items;
  const bool valid_next = lane < kPeek && k + 32 < n_items;
  const int pos = valid ? item_pos(order, k) : 0;
  const int pos_next = valid_next ? item_pos(order, k + 32) : 0;
  // this item's values, asked for beside its id (a lane whose id is
  // dropped never adds them)
  float v[kRowsAtOnce];
  load_rows(v, vals, n_items, 0, n_rows, pos, valid);
  const int id = valid ? __ldg(ids + pos) : 0;
  const int id_next = valid_next ? __ldg(ids + pos_next) : 0;
  // the neighbours' ids: shuffled within the warp; the item before the
  // warp is loaded, the one after it is the next warp's first
  int prev = __shfl_up_sync(kFull, id, 1);
  int next = __shfl_down_sync(kFull, id, 1);
  const int after = __shfl_sync(kFull, id_next, 0);
  if (lane == 0 && valid && k > 0) prev = __ldg(ids + item_pos(order, k - 1));
  if (lane == 31) next = after;
  const bool has_next = k + 1 < n_items;
  const bool start = valid && (k == 0 || prev != id);
  const bool end = valid && (!has_next || next != id);
  const bool kept = valid && id >= 0 && id < n_segments;

  // each run start's run within the warp: up to the first end at or after
  // it; with none, the run goes on into the next warp
  const unsigned ends = __ballot_sync(kFull, end);
  const unsigned ends_here = ends & (kFull << lane);
  const int last = ends_here ? __ffs(ends_here) - 1 : 31;
  const bool sums = start && kept;
  const int len = sums ? last - lane + 1 : 0;
  const int max_len = __reduce_max_sync(kFull, len);
  // the run that goes on past the warp (at most one: the warp's last), and
  // how many of the next warp's first kPeek items it takes (a prefix)
  const unsigned crossing = __ballot_sync(kFull, sums && !ends_here);
  const int owner = crossing ? __ffs(crossing) - 1 : 0;
  const int run_id = __shfl_sync(kFull, id, owner);
  const bool in_run_next = crossing && valid_next && id_next == run_id;
  const unsigned taken = __ballot_sync(kFull, in_run_next);
  const int count = (taken == kFull) ? 32 : __ffs(~taken) - 1;

  // the empty segments, before each run and after the last item, zeroed
  // while the values are on their way
  fill_gaps(out, n_rows, start,
            clamp_to(k == 0 ? 0 : prev + 1, n_segments),
            clamp_to(id, n_segments), lane);
  fill_gaps(out, n_rows, valid && !has_next,
            clamp_to(id + 1, n_segments), n_segments, lane);

  for (int r0 = 0; r0 < n_rows; r0 += kRowsAtOnce) {
    const int rows = min(kRowsAtOnce, n_rows - r0);
    float w[kRowsAtOnce], acc[kRowsAtOnce];
    if (r0 > 0) load_rows(v, vals, n_items, r0, n_rows, pos, valid);
    load_rows(w, vals, n_items, r0, n_rows, pos_next, in_run_next);
#pragma unroll
    for (int j = 0; j < kRowsAtOnce; ++j) acc[j] = 0.0f;
    // each run's items in ascending k, shuffled to its start lane
    for (int t = 0; t < max_len; ++t) {
      const int src_lane = min(lane + t, 31);
#pragma unroll
      for (int j = 0; j < kRowsAtOnce; ++j) {
        const float x = __shfl_sync(kFull, v[j], src_lane);
        if (t < len) acc[j] += x;
      }
    }
    // the run past the warp: the next warp's first items, then, for a
    // run longer than that, 32 items at a time walked by the whole warp
    if (crossing) {
      add_lanes(acc, w, count, owner, lane);
      for (int base = warp_first + 32 + kPeek, more = count == kPeek; more;
           base += 32) {
        const int j_item = base + lane;
        const int p = j_item < n_items ? item_pos(order, j_item) : 0;
        const bool in_run = j_item < n_items && __ldg(ids + p) == run_id;
        const unsigned m = __ballot_sync(kFull, in_run);
        const int c = (m == kFull) ? 32 : __ffs(~m) - 1;
        load_rows(w, vals, n_items, r0, n_rows, p, in_run);
        add_lanes(acc, w, c, owner, lane);
        more = c == 32;
      }
    }
    if (sums) {
      float* dst = out + static_cast<size_t>(id) * n_rows + r0;
#pragma unroll
      for (int j = 0; j < kRowsAtOnce; ++j)
        if (j < rows) dst[j] = acc[j];
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t); does not synchronise. `order` may
// be null (the identity). Returns cudaGetLastError() as an int, 0 on
// success.
extern "C" int gh_segment_reduce_sorted(const void* ids, const void* order,
                                        const void* vals, int n_items,
                                        int n_rows, int n_segments, void* out,
                                        void* stream) {
  if (n_segments > 0) {
    int blocks = (n_items + kThreads - 1) / kThreads;
    if (n_items == 0) {
      const long long total = static_cast<long long>(n_segments) * n_rows;
      blocks = static_cast<int>((total + kThreads - 1) / kThreads);
      blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
    }
    segment_reduce_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids),
        static_cast<const int32_t*>(order), static_cast<const float*>(vals),
        n_items, n_rows, n_segments, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
