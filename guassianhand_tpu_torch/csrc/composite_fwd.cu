// Tile-composite forward of the 3DGS rasterizer, for Hopper (sm_90a).
//
// Replaces: guassianhand_tpu/ops/rasterize_pallas.py::composite_forward
// (body _fwd_kernel, helpers _block_alpha/_prefix_products/_forward_block),
// both calls: render mode (store_cpx=False) and training mode
// (store_cpx=True), which keeps what the backward needs.
//
// What it computes: per 16x16 pixel tile, front-to-back alpha compositing
// over the tile's depth-sorted (Gaussian, tile) pairs, with the acceptance
// rule of ops/common.py (composite_common.cuh::pair_alpha):
//   power = -0.5 (A dx^2 + C dy^2) - B dx dy;  skip the pair if power > 0
//   alpha = min(0.99, opacity * exp(power));   skip the pair if alpha < 1/255
//   stop before the pair that would take T (1 - alpha) below 1e-4
// Outputs: rgb (H, W, 3) = sum_i c_i alpha_i T_i and the final
// transmittance T (H, W), fp32. Training mode also writes n_contrib (H, W)
// int32, the count of the tile's pairs walked up to and including the
// pixel's last composited pair, and keeps the chunk checkpoints below: with
// them the backward (composite_bwd.cu) starts each chunk at its back end.
//
// What bounds it on this card: the pixel x pair evaluations on the CUDA
// cores, 26 fp32 operations for a pair that is composited (a multiply-add
// counted as two, expf as one) and 12 or 16 for one a gate rejects; the
// OPS_* constants of ops/rasterize_cuda.py count them. The bytes are small by
// comparison: each pair costs a 4-byte id plus a 36-byte attribute gather
// that the 256 pixels of a tile share, and each pixel writes 16 bytes.
//
// What held the one-CTA-a-tile design back: the hand scenes pile their
// pairs onto few tiles (the avatar's 252,900 pairs on 100 of 1,024 tiles,
// 9,876 in the busiest), so the busiest tile's walk ran on one SM while the
// rest of the card idled, one dependent chain a pair (shared-memory load,
// power, gates, expf, alpha, T (1 - alpha), the stop test) with 8 warps to
// hide it: about 118 ns a pair.
//
// The design. A pixel's transmittance recurrence must run pair after pair
// in the twin's order and rounding (a product of chunk products, or a
// parallel prefix product, could flip n_contrib at the 1e-4 stop), but
// alpha does not depend on T, and the 256 pixels of a tile do not depend
// on each other. So the chunk plan (below, built by its own one-CTA
// kernel) cuts every tile of more than 512 pairs
// (ops/rasterize_cuda.py::FWD_LIGHT) into
// chunks of kChunk = 256 pairs and its pixels into kGroups = 4 groups of
// 4 rows; each (chunk, group) is one CTA of 256 threads:
//   1. it stages the chunk's pairs in shared memory, and 4 threads a pixel
//      evaluate the chunk's alphas at the group's 64 pixels into shared
//      memory (64 KB), two pairs at once, a warp skipping exp when none of
//      its pixels can reach 1/255;
//   2. it takes the group's running state (T, rgb, n_contrib, stopped)
//      from the CTA of the chunk before, through device memory, as soon as
//      that one has published it (chunk 0 starts from T = 1);
//   3. one thread a pixel runs the recurrence over the chunk's alphas,
//      eight pairs at a time (walk_group): first the chain T (1 - alpha)
//      and the colour multiply-adds with no stop test, then, only if the
//      group's last T fell below 1e-4, the same eight pairs again with it;
//   4. it writes the state to a checkpoint every kCheckpoint = 64 pairs
//      and, for the tile's last chunk, the outputs.
// The chunks of one tile run on many SMs and their alpha passes in
// parallel; only the cheap recurrence and the hand-offs stay in sequence,
// 256 pairs a hand-off. A chunk whose group has stopped everywhere by the
// time it starts skips its alphas. A tile of at most 512 pairs is one CTA,
// whole: a thread a pixel, its pairs staged 256 at a time, eight alphas
// evaluated at once before they are walked, no hand-off (the balanced
// bench scene has no tile of more).
//
// The hand-off: a CTA takes its item number from a ticket counter as it
// starts, and items are numbered round by round (the chunk plan), so
// a CTA that waits for chunk c - 1 waits for an item with a smaller ticket,
// whose CTA is already running and waits only for smaller tickets in turn:
// no deadlock, whatever order the hardware starts CTAs in. The publishing
// CTA writes its state, passes a CTA barrier and sets the group's flag with
// a release store; the waiting CTA's first thread spins on an acquire load
// of that flag (and traps after 2^24 polls, seconds, so a fault ends the
// launch instead of hanging it), passes a CTA barrier, and its threads read
// the state from L2. The state at every checkpoint is what training mode
// keeps: (T, r, g, b) a pixel every 64 pairs inside a tile, 16 bytes x 256
// pixels x at most P / 64 checkpoints (plus a 4-byte n_contrib and a flag
// word for the hand-off, freed after the launch).
//
// Numerics: as the twin (ops/rasterize_cuda.py::composite_plain) and as the
// one-CTA design: the same round-to-nearest intrinsics, the same order of
// the recurrence, rejected pairs changing nothing. Both modes run the same
// instructions on the floats, so training mode's rgb and final T are
// bit-identical to render mode's.
#include "composite_common.cuh"

namespace {

using gh::kPix;

// --- the chunk plan ---------------------------------------------------------
//
// A plan cuts a tile's depth-sorted pairs into chunks of `chunk` pairs (a
// tile with no pair is one empty chunk) and its 256 pixels into `groups`
// groups of rows; a work item is one (tile, chunk, group). A tile of at
// most `light` pairs is instead one item, whole (group -1). Items are
// numbered round by round: round c holds chunk c of every tile that is cut
// and has more than c chunks, tiles with the most chunks first, each
// tile's groups in a row; the whole tiles follow, in tile order. So chunk
// c - 1 of a tile always has a smaller number than chunk c, which the
// hand-off between the chunks of one tile relies on, and the chunks of the
// longest chains start first. The plan also writes the checkpoint slot
// bases (composite_common.cuh), which the backward takes from the forward.

struct Item {
  int tile;
  int chunk;
  int group;
  int n_chunks;   // of the tile, at least 1
  int first;      // the chunk's first pair in pair_gid
  int count;      // pairs in the chunk, 0 for an empty tile
};

// The work item numbered `i` (< the plan's item count), from the plan's
// (tile, chunk, group) table.
__device__ __forceinline__ Item plan_item(int i,
                                          const int4* __restrict__ items,
                                          const int32_t* __restrict__ tile_range,
                                          int chunk) {
  const int4 e = items[i];
  Item it;
  it.tile = e.x;
  it.chunk = e.y;
  it.group = e.z;
  const int begin = tile_range[it.tile];
  const int pairs = tile_range[it.tile + 1] - begin;
  if (it.group < 0) {   // a light tile, whole
    it.n_chunks = 1;
    it.first = begin;
    it.count = pairs;
    return it;
  }
  it.n_chunks = max(1, (pairs + chunk - 1) / chunk);
  it.first = begin + it.chunk * chunk;
  it.count = max(0, min(chunk, pairs - it.chunk * chunk));
  return it;
}

constexpr int kPlanThreads = 1024;

// Exclusive prefix sum of v over the CTA's kPlanThreads threads; `total`
// gets the sum. Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
  total = s_warp[31];
  __syncthreads();
  return before;
}

// One CTA of kPlanThreads threads. The items of the plan (`chunk` pairs,
// `groups` pixel groups, tiles of at most `light` pairs whole),
// ranked as ops/rasterize_cuda.py::chunk_plan_plain ranks them; the
// checkpoint slot bases (a slot every kCheckpoint pairs inside a tile);
// the item count. `scratch` holds 2 n_rounds + 1 + 3 num_tiles ints,
// n_rounds = max(1, ceil(pairs / chunk)).
__global__ void __launch_bounds__(kPlanThreads)
composite_plan_kernel(const int32_t* __restrict__ tile_range, int num_tiles,
                      int chunk, int groups, int light, int n_rounds,
                      int4* __restrict__ items, int32_t* __restrict__ n_items,
                      int32_t* __restrict__ slot_base,
                      int32_t* __restrict__ scratch) {
  __shared__ int s_warp[32];
  int32_t* hist = scratch;                        // n_rounds + 1
  int32_t* round_start = hist + n_rounds + 1;     // n_rounds
  int32_t* multi = round_start + n_rounds;        // num_tiles
  int32_t* multi_chunks = multi + num_tiles;      // num_tiles
  int32_t* rank = multi_chunks + num_tiles;       // num_tiles
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int c = tid; c <= n_rounds; c += kPlanThreads) hist[c] = 0;
  __syncthreads();
  // each cut tile's chunk count (0 for a whole one): their histogram, one
  // atomic per distinct count a warp; the slot bases; the tiles of more
  // than one chunk in tile order; each other tile's place among the cut
  // tiles of one chunk, or among the whole ones
  int slots = 0, n_multi = 0, n_single = 0, n_whole = 0, cut_chunks = 0;
  int tot;
  for (int base = 0; base < num_tiles; base += kPlanThreads) {
    const int t = base + tid;
    const bool valid = t < num_tiles;
    const int pairs = valid ? tile_range[t + 1] - tile_range[t] : 0;
    const bool whole = valid && pairs <= light;
    const int nch = valid && !whole ? max(1, (pairs + chunk - 1) / chunk) : 0;
    const unsigned peers = __match_any_sync(0xffffffffu, nch);
    if (nch > 0 && lane == __ffs(peers) - 1) atomicAdd(hist + nch, __popc(peers));
    const int ckpt = valid ? max(0, (pairs - 1) / gh::kCheckpoint) : 0;
    const int s = block_exclusive_scan(ckpt, s_warp, tot);
    if (valid) slot_base[t] = slots + s;
    slots += tot;
    const int m = block_exclusive_scan(nch > 1, s_warp, tot);
    if (nch > 1) {
      multi[n_multi + m] = t;
      multi_chunks[n_multi + m] = nch;
    }
    n_multi += tot;
    int tot_w;
    const int o = block_exclusive_scan(nch == 1, s_warp, tot);
    const int w = block_exclusive_scan(whole, s_warp, tot_w);
    if (nch == 1) rank[t] = o + n_single;
    if (whole) rank[t] = w + n_whole;
    n_single += tot;
    n_whole += tot_w;
    block_exclusive_scan(nch, s_warp, tot);
    cut_chunks += tot;
  }
  if (tid == 0) {
    slot_base[num_tiles] = slots;
    *n_items = groups * cut_chunks + n_whole;
  }
  __syncthreads();
  // round c holds the cut tiles of more than c chunks; its first item
  const int n_cut = num_tiles - n_whole;
  int below = 0, started = 0;
  for (int base = 0; base < n_rounds; base += kPlanThreads) {
    const int c = base + tid;
    const int hv = c < n_rounds ? hist[c] : 0;
    const int hs = block_exclusive_scan(hv, s_warp, tot);
    const int in_round = c < n_rounds ? n_cut - (below + hs + hv) : 0;
    below += tot;
    const int rs = block_exclusive_scan(in_round, s_warp, tot);
    if (c < n_rounds) round_start[c] = started + rs;
    started += tot;
  }
  // a cut tile's rank: the tiles of more chunks, or as many and an earlier
  // tile, before it
  for (int i = tid; i < n_multi; i += kPlanThreads) {
    const int nch = multi_chunks[i];
    int r = 0;
    for (int k = 0; k < n_multi; ++k) {
      const int nk = multi_chunks[k];
      r += nk > nch || (nk == nch && k < i);
    }
    rank[multi[i]] = r;
  }
  __syncthreads();
  for (int t = tid; t < num_tiles; t += kPlanThreads) {
    const int pairs = tile_range[t + 1] - tile_range[t];
    if (pairs <= light) {
      items[groups * cut_chunks + rank[t]] = make_int4(t, 0, -1, 0);
      continue;
    }
    const int nch = max(1, (pairs + chunk - 1) / chunk);
    const int r = nch > 1 ? rank[t] : n_multi + rank[t];
    for (int c = 0; c < nch; ++c)
      for (int g = 0; g < groups; ++g)
        items[groups * (round_start[c] + r) + g] = make_int4(t, c, g, 0);
  }
}

constexpr int kGroups = 4;                   // pixel groups of a heavy tile
constexpr int kGroupPix = kPix / kGroups;    // 64 pixels: 4 rows
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kGroupPix; // threads a pixel, alpha pass
constexpr int kChunk = 256;                  // pairs a heavy work item
constexpr int kStep = 8;                     // recurrence steps a group
constexpr int kStopped = 1 << 30;            // flag bit of the published n_contrib
static_assert(kChunk % gh::kCheckpoint == 0, "chunks end on checkpoints");
static_assert(gh::kCheckpoint % kStep == 0, "groups end on checkpoints");

__device__ __forceinline__ int load_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

struct Smem {
  float alpha[kChunk * kGroupPix];           // [pair][pixel of the group]
  float2 xy[kChunk];
  float4 conic_opa[kChunk];
  float4 color[kChunk];                      // r g b, power floor
};

// One pixel's running composite.
struct Pixel {
  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int contrib = 0;
  bool done = false;
};

// The recurrence over kStep pairs in the twin's order, their alphas `al`
// (0 where rejected) and colours `col`; `index` is the first one's number
// in its tile. The fast path runs the chain T (1 - alpha) with no stop
// test: a rejected pair multiplies T by 1 and adds 0, so it changes
// nothing, and T only falls, so the group stopped nowhere if its last T is
// still >= 1e-4. Otherwise the group runs again from its start with the
// stop test at every pair (once a pixel).
__device__ __forceinline__ void walk_group(Pixel& q, const float (&al)[kStep],
                                           const float4 (&col)[kStep],
                                           int index) {
  float t = q.T, r = q.cr, g = q.cg, b = q.cb;
  int n = q.contrib;
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    const float w = __fmul_rn(al[u], t);
    t = __fmul_rn(t, __fsub_rn(1.0f, al[u]));
    r += col[u].x * w;
    g += col[u].y * w;
    b += col[u].z * w;
    n = al[u] != 0.0f ? index + u + 1 : n;
  }
  if (t >= gh::kTEps) {
    q.T = t;
    q.cr = r;
    q.cg = g;
    q.cb = b;
    q.contrib = n;
    return;
  }
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    if (q.done || al[u] == 0.0f) continue;
    const float test_t = __fmul_rn(q.T, __fsub_rn(1.0f, al[u]));
    if (test_t < gh::kTEps) {
      q.done = true;
      continue;
    }
    const float w = __fmul_rn(al[u], q.T);
    q.cr += col[u].x * w;
    q.cg += col[u].y * w;
    q.cb += col[u].z * w;
    q.T = test_t;
    q.contrib = index + u + 1;
  }
}

// The checkpoint of pixel `pix` after the first `walked` pairs of its tile
// (a multiple of gh::kCheckpoint), unless no pair follows.
__device__ __forceinline__ void checkpoint(const Pixel& q, int walked,
                                           int tile_pairs, int slot0, int pix,
                                           float4* state_f, int32_t* state_i) {
  if (walked >= tile_pairs) return;
  const size_t s = static_cast<size_t>(slot0 + walked / gh::kCheckpoint - 1) * kPix + pix;
  state_f[s] = make_float4(q.T, q.cr, q.cg, q.cb);
  state_i[s] = q.contrib | (q.done ? kStopped : 0);
}

// The state of pixel `pix` at checkpoint `slot`, as checkpoint() wrote it.
__device__ __forceinline__ void load_state(Pixel& q, const float4* state_f,
                                           const int32_t* state_i, int slot,
                                           int pix) {
  const size_t s = static_cast<size_t>(slot) * kPix + pix;
  const float4 st = __ldcg(state_f + s);
  const int si = __ldcg(state_i + s);
  q.T = st.x;
  q.cr = st.y;
  q.cg = st.z;
  q.cb = st.w;
  q.contrib = si & (kStopped - 1);
  q.done = (si & kStopped) != 0;
}

// Stage pairs [first, first + n) and pad them with empty pairs (alpha 0,
// colour 0) up to a whole number of kStep groups; returns that number of
// pairs.
__device__ __forceinline__ int stage(Smem& sm, const int32_t* pair_gid,
                                     const float* attrs, int first, int n) {
  const int padded = (n + kStep - 1) / kStep * kStep;
  for (int j = threadIdx.x; j < padded; j += kThreads) {
    if (j < n) {
      const float* a = attrs + static_cast<size_t>(pair_gid[first + j]) * gh::kAttr;
      sm.xy[j] = make_float2(a[0], a[1]);
      sm.conic_opa[j] = make_float4(a[2], a[3], a[4], a[5]);
      sm.color[j] = make_float4(a[6], a[7], a[8], gh::power_floor(a[5]));
    } else {
      sm.xy[j] = make_float2(0.0f, 0.0f);
      sm.conic_opa[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      sm.color[j] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
    }
  }
  return padded;
}

__device__ __forceinline__ void write_pixel(const Pixel& q, int pxi, int pyi,
                                            int width, float* out_rgb,
                                            float* out_t,
                                            int32_t* out_contrib) {
  const size_t p = static_cast<size_t>(pyi) * width + pxi;
  out_rgb[3 * p + 0] = q.cr;
  out_rgb[3 * p + 1] = q.cg;
  out_rgb[3 * p + 2] = q.cb;
  out_t[p] = q.T;
  if (out_contrib != nullptr) out_contrib[p] = q.contrib;
}

// A light tile: one CTA, a thread a pixel, the tile's pairs staged
// kChunk at a time and each thread evaluating kStep alphas at once before
// walking them.
__device__ void light_tile(Smem& sm, const Item& it,
                           const int32_t* pair_gid, const float* attrs,
                           int slot0, int ntx, int height, int width,
                           float* out_rgb, float* out_t, int32_t* out_contrib,
                           float4* state_f, int32_t* state_i) {
  const int pix = threadIdx.x;
  const int pxi = (it.tile % ntx) * gh::kTile + pix % gh::kTile;
  const int pyi = (it.tile / ntx) * gh::kTile + pix / gh::kTile;
  const float px = static_cast<float>(pxi);
  const float py = static_cast<float>(pyi);
  Pixel q;
  for (int base = 0; base < it.count; base += kChunk) {
    __syncthreads();   // the previous batch is no longer read
    const int n = stage(sm, pair_gid, attrs, it.first + base,
                        min(kChunk, it.count - base));
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kStep) {
      if (!q.done) {
        float al[kStep];
        float4 col[kStep];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const gh::PairGeom g = {sm.xy[j0 + u], sm.conic_opa[j0 + u]};
          float dx, dy, ep, alpha_raw;
          const float power = gh::pair_power(g, px, py, dx, dy);
          al[u] = gh::pair_alpha(g, power, ep, alpha_raw);
          col[u] = sm.color[j0 + u];
        }
        walk_group(q, al, col, base + j0);
      }
      if ((j0 + kStep) % gh::kCheckpoint == 0)
        checkpoint(q, base + j0 + kStep, it.count, slot0, pix, state_f, state_i);
    }
  }
  if (pxi < width && pyi < height)
    write_pixel(q, pxi, pyi, width, out_rgb, out_t, out_contrib);
}

__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const int32_t* __restrict__ tile_range,
                     const int32_t* __restrict__ pair_gid,
                     const float* __restrict__ attrs,
                     const int4* __restrict__ items,
                     const int32_t* __restrict__ n_items,
                     const int32_t* __restrict__ slot_base,
                     int ntx, int height, int width,
                     float* __restrict__ out_rgb, float* __restrict__ out_t,
                     int32_t* __restrict__ out_contrib,
                     float4* __restrict__ state_f,
                     int32_t* __restrict__ state_i,
                     int32_t* __restrict__ sync) {
  // sync[0]: the ticket counter; sync[1 + kGroups slot + group]: the flag
  // of a group's hand-off at checkpoint `slot`
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ int s_ticket;
  __shared__ bool s_ready;

  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int ticket = s_ticket;
  if (ticket >= *n_items) return;
  const Item it = plan_item(ticket, items, tile_range, kChunk);
  const int slot0 = slot_base[it.tile];
  if (it.group < 0) {
    light_tile(sm, it, pair_gid, attrs, slot0, ntx, height, width, out_rgb,
               out_t, out_contrib, state_f, state_i);
    return;
  }

  // A heavy tile's chunk at one group of its rows. This thread's pixel of
  // the group; the group's rows are 4 of the tile's 16.
  const int gp = tid % kGroupPix;
  const int pix = it.group * kGroupPix + gp;   // in the tile, row-major
  const int pxi = (it.tile % ntx) * gh::kTile + pix % gh::kTile;
  const int pyi = (it.tile / ntx) * gh::kTile + pix / gh::kTile;
  const float px = static_cast<float>(pxi);
  const float py = static_cast<float>(pyi);

  // 1. stage the chunk, and take the pixels' running state now if the
  // chunk before has published it already: a group whose 64 pixels have
  // all stopped skips its alphas and its walk
  const int n = stage(sm, pair_gid, attrs, it.first, it.count);
  const int walked = it.chunk * kChunk;   // the tile's pairs before the chunk
  const int slot_in = slot0 + walked / gh::kCheckpoint - 1;
  const int flag_in = 1 + kGroups * slot_in + it.group;   // in sync
  if (tid == 0) s_ready = it.chunk == 0 || load_acquire(sync + flag_in) != 0;
  __syncthreads();
  Pixel q;   // pixels outside the image composite too, unwritten
  bool have_state = s_ready;
  if (have_state && it.chunk > 0 && tid < kGroupPix)
    load_state(q, state_f, state_i, slot_in, pix);
  const bool skip = __syncthreads_and(!have_state || tid >= kGroupPix || q.done)
                    && have_state;

  // 2. kLanes threads a pixel evaluate its alphas, pair j by lane
  // j % kLanes, two pairs at once, skipping exp where no pixel of the warp
  // can reach 1/255 (gh::power_floor, kept in the colour's w)
  if (!skip) {
    for (int j = tid / kGroupPix; j < n; j += 2 * kLanes) {
      const int k = min(j + kLanes, n - 1);
      const gh::PairGeom g0 = {sm.xy[j], sm.conic_opa[j]};
      const gh::PairGeom g1 = {sm.xy[k], sm.conic_opa[k]};
      float dx, dy, ep, alpha_raw;
      const float p0 = gh::pair_power(g0, px, py, dx, dy);
      const float p1 = gh::pair_power(g1, px, py, dx, dy);
      const bool reach = (p0 <= 0.0f && p0 >= sm.color[j].w)
                         || (p1 <= 0.0f && p1 >= sm.color[k].w);
      float a0 = 0.0f, a1 = 0.0f;
      if (__any_sync(0xffffffffu, reach)) {
        a0 = gh::pair_alpha(g0, p0, ep, alpha_raw);
        a1 = gh::pair_alpha(g1, p1, ep, alpha_raw);
      }
      sm.alpha[j * kGroupPix + gp] = a0;
      if (j + kLanes < n) sm.alpha[(j + kLanes) * kGroupPix + gp] = a1;
    }
  }

  // 3. the running state, if it was not there yet, from the chunk before
  if (!have_state) {
    if (tid == 0) {
      int spins = 0;
      while (load_acquire(sync + flag_in) == 0) {
        if (++spins > (1 << 24)) __trap();
      }
    }
    __syncthreads();
    if (tid < kGroupPix) load_state(q, state_f, state_i, slot_in, pix);
  } else {
    __syncthreads();
  }

  // 4. one thread a pixel walks the chunk's alphas, each group's alphas and
  // colours read while the group before is walked, with a checkpoint every
  // gh::kCheckpoint pairs that are not the tile's last
  if (tid < kGroupPix) {
    const int tile_pairs = tile_range[it.tile + 1] - tile_range[it.tile];
    float al[kStep];
    float4 col[kStep];
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      al[u] = sm.alpha[u * kGroupPix + gp];
      col[u] = sm.color[u];
    }
    for (int j0 = 0; j0 < n; j0 += kStep) {
      const int next = min(j0 + kStep, n - kStep);
      float al_next[kStep];
      float4 col_next[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        al_next[u] = sm.alpha[(next + u) * kGroupPix + gp];
        col_next[u] = sm.color[next + u];
      }
      if (!q.done) walk_group(q, al, col, walked + j0);
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        al[u] = al_next[u];
        col[u] = col_next[u];
      }
      if ((j0 + kStep) % gh::kCheckpoint == 0)
        checkpoint(q, walked + j0 + kStep, tile_pairs, slot0, pix, state_f,
                   state_i);
    }
  }

  if (it.chunk < it.n_chunks - 1) {
    // the barrier orders the group's stores before the first thread's
    // release, which publishes them at device scope
    __syncthreads();
    if (tid == 0) {
      store_release(sync + flag_in + kGroups * (kChunk / gh::kCheckpoint), 1);
    }
  } else if (tid < kGroupPix && pxi < width && pyi < height) {
    write_pixel(q, pxi, pyi, width, out_rgb, out_t, out_contrib);
  }
}

}  // namespace

// The chunk plan (above) of `num_tiles` tiles and `n_pairs` pairs, for
// `chunk` pairs and `groups` pixel groups an item and tiles of at most
// `light` pairs whole (the forward's: 256, 4 and 512): `items`
// (groups x (num_tiles + n_pairs / chunk) int4), `n_items` (1 int),
// `slot_base` (num_tiles + 1 ints), `scratch` 2 n_rounds + 1 + 3 num_tiles
// ints, n_rounds = max(1, ceil(n_pairs / chunk)). One CTA on `stream`.
// Returns cudaGetLastError() as an int.
extern "C" int gh_composite_plan(const void* tile_range, int num_tiles,
                                 int chunk, int groups, int light,
                                 int n_rounds, void* items, void* n_items,
                                 void* slot_base, void* scratch,
                                 void* stream) {
  composite_plan_kernel<<<1, kPlanThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile_range), num_tiles, chunk, groups,
      light, n_rounds, static_cast<int4*>(items), static_cast<int32_t*>(n_items),
      static_cast<int32_t*>(slot_base), static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// Zeroes `sync` (n_sync = 1 + 4 max_slots ints) and launches `max_items`
// CTAs on `stream` (a cudaStream_t); does not synchronise. The plan
// (items, n_items, slot_base) is gh_composite_plan's for `chunk` = 256
// pairs and `groups` = 4 (anything else is refused with
// cudaErrorInvalidValue), whole tiles of any size; `state_f`/`state_i`
// max_slots x 256 float4/int (state_f is the checkpoint tensor of training
// mode). `out_contrib` is null in render mode. Returns
// cudaGetLastError() as an int, 0 on success.
extern "C" int gh_composite_forward(
    const void* tile_range, const void* pair_gid, const void* attrs,
    const void* items, const void* n_items, const void* slot_base,
    int chunk, int groups, int max_items, int ntx, int height, int width,
    void* out_rgb, void* out_t, void* out_contrib, void* state_f,
    void* state_i, void* sync, int n_sync, void* stream) {
  if (chunk != kChunk || groups != kGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(sync, 0, static_cast<size_t>(n_sync) * sizeof(int32_t),
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_items > 0) {
    composite_fwd_kernel<<<max_items, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tile_range),
        static_cast<const int32_t*>(pair_gid),
        static_cast<const float*>(attrs), static_cast<const int4*>(items),
        static_cast<const int32_t*>(n_items),
        static_cast<const int32_t*>(slot_base), ntx, height, width,
        static_cast<float*>(out_rgb), static_cast<float*>(out_t),
        static_cast<int32_t*>(out_contrib), static_cast<float4*>(state_f),
        static_cast<int32_t*>(state_i), static_cast<int32_t*>(sync));
  }
  return static_cast<int>(cudaGetLastError());
}
