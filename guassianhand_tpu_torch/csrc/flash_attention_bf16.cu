// Exact softmax attention in bf16, forward and backward, for Hopper
// (sm_90a): warpgroup MMAs (wgmma) fed by the Tensor Memory Accelerator.
//
// Replaces: guassianhand_tpu/ops/blockwise_attention.py::
// _flash_attention_masked on bf16 q, k, v (the model's bf16 compute dtype,
// configs/one_shot.yaml), which calls JAX's bundled Pallas TPU flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py: forward
// _flash_attention_impl, backward _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), reached with GH_FLASH_ATTN=1 from the
// interaction attention (nn/heads.py::SelfAttn). The float32 kernels are
// csrc/flash_attention.cu; the wrapper (ops/flash_attention_cuda.py)
// gathers the live rows, so these kernels attend among L rows with no mask.
//
// What it computes, at the rounding points of JAX's kernel on bf16 inputs
// (the twins in ops/flash_attention_cuda.py round at the same points):
//   forward: S = q k^T from bf16 operands with fp32 accumulation, times the
//     scale in fp32 (q is not scaled in bf16); over the keys in 128-key
//     tiles (JAX's block_k), in order, an online softmax in fp32 whose
//     P = exp(S - m), m the running maximum with this tile, is rounded to
//     bf16 for P.V (fp32 accumulation); out = acc / l rounded to bf16 once;
//     lse = m + log(l) in fp32;
//   backward, with delta = rowsum(f32(out) * f32(dout)) from torch:
//     P = exp(S scale - lse) and dP = dout v^T in fp32, dS = (dP - delta) P
//     scale in fp32; dv += bf16(P)^T dout, dk += bf16(dS)^T q,
//     dq += bf16(dS) k, fp32 sums, each rounded to bf16 once.
// Keys past L score -inf in the forward and get P = 0 in the backward;
// rows past L load zeros (TMA's fill) and write nothing.
//
// What bounds it on this card: at head width D = 32 the products are small
// (4 D flops a score forward, 8 D dkv, 6 D dq at 989 TFLOP/s: 0.115, 0.230,
// 0.173 ms at the fit's L = 14,914, H = 4), and one exp a score on the
// special-function units (16 a clock an SM) takes about 0.21 ms. Above
// both lies instruction issue: the scores' exp is 6 instructions (one of
// them on the SFU; exp_sfu, as accurate as expf, which takes 8), and with
// the scale, the max, the sum and the bf16 packing a forward score costs
// 10.5 warp-lane issue slots (dq about 11.5, dkv about 13.5 with its two
// packings and its lse and delta reads from shared memory): some 770
// instructions a warp a 128-key tile in the forward.
// The design spends few slots besides: one thread issues a tile's loads,
// a wgmma is one instruction for a warpgroup, and no CTA-wide barrier is
// taken in the loops.
//
// The design:
//   - A CTA is two consumer warpgroups of 64 rows each (queries in the
//     forward and dq, keys in dkv) and a producer warpgroup: 128 rows of
//     one head, ceil(L / 128) x H CTAs (468 at the fit), one CTA an SM,
//     3.55 waves on 132 SMs. The producer gives its registers up
//     (setmaxnreg: 24 a thread) so that each consumer thread has 240.
//   - The producer's first warp keeps TMA loads in flight through a ring
//     of kStages tiles in shared memory, with a full and an empty mbarrier
//     a stage: K and V tiles of 128 keys in the forward, 64 in dq; Q, dout
//     and the rows' lse and delta (copied by the warp's 32 lanes) tiles of
//     64 queries in dkv. Each tile is a 2-D box of the (L, H D) tensor at
//     column 32 h, so the head stride needs no copy; rows past L are filled
//     with zeros. The CTA's own rows (Q; K and V in dkv; Q and dout in dq)
//     are loaded once the same way.
//   - Every operand lies in shared memory as rows of 64 bytes (32 bf16),
//     64-byte swizzled by the TMA, and serves both ways: K-major where a
//     product runs over d (S = Q K^T, dP = dout V^T, and their transposes
//     in dkv: m64n128k16 or m64n64k16, A and B from shared memory, two
//     k-steps of 16 d), MN-major where it runs over the rows (P.V, P^T.dout,
//     dS^T.Q, dS.K: m64n32k16, B read across its rows, which bf16 wgmma
//     allows, so nothing is transposed). One descriptor form serves all:
//     64-byte swizzle, 512 bytes from one group of 8 rows to the next.
//   - P and dS never leave registers: the fp32 accumulator of S over 16
//     keys, packed pairwise to bf16x2, is the A fragment of the next
//     product as it stands.
//   - Overlap: the forward issues P.V at the end of a tile and takes it
//     into its sum at the next, after that tile's S, so the product runs
//     beside the next score wait; one row-max reduction and correction a
//     128-key tile. dq and dkv issue the next tile's S and dP before this
//     tile's exps (dq also takes dS.K one tile late), so the tensor cores
//     work beside them. The two warpgroups of a CTA interleave their exps
//     and waits on the SM's schedulers. Measured on the card, the forward
//     is faster without the next tile's scores in flight (the 64 registers
//     they hold are the ones ptxas needs to keep many exps in flight), the
//     backward kernels with them, and a strict ping-pong of the two
//     warpgroups' exps (FA3's) is slower: a warp alone does not fill a
//     scheduler's issue slots.
//   - Every wgmma and wait is issued unconditionally, the first and last
//     tiles peeled by compile-time flags: a wgmma issued under a run-time
//     condition, or a register of its A or accumulator written between its
//     issue and its wait, makes ptxas serialise all of them.
//   - Sums: each tile's products go into a fresh accumulator (scale-d 0 on
//     the first k-step), which is then added in fp32 to the running one,
//     rescaled by the softmax correction in the forward: an output is a sum
//     of L / 128 (forward) or L / 64 (backward) partial sums. Each output
//     element is written by one thread after a sum in a fixed order, with
//     no float atomics: two calls give the same bits. dkv and dq are two
//     kernels, as in JAX.
// expf (for the corrections and the masked last tile) and logf are the
// accurate libm functions, and exp_sfu keeps their accuracy: build without
// --use_fast_math. Head width 32 only; the TMA maps are encoded on the host
// (cuTensorMapEncodeTiled: link with -lcuda).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;                    // head width
constexpr int kRowBytes = 2 * kD;         // a staged row: 32 bf16
constexpr int kWgRows = 64;               // rows of a consumer warpgroup
constexpr int kWgs = 2;                   // consumer warpgroups of a CTA
constexpr int kBlockRows = kWgs * kWgRows;  // rows of a CTA
constexpr int kConsumers = kWgs * 128;      // consumer threads
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kBox = 64;                  // rows of a TMA box
constexpr int kFwdTile = 128;             // keys of a forward tile
constexpr int kBwdTile = 64;              // rows of a backward tile
constexpr int kStages = 4;                // tiles in flight
// dq frees a tile's stage one tile late, after it waited for the next
// tile: with fewer than 3 stages it would wait forever.
static_assert(kStages >= 3, "a stage is freed one tile after the next loads");

// ------------------------------------------------------- shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes, so that the 64-byte
// swizzle of the TMA and of wgmma (a pattern of 512 bytes) agree.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrives and announces `bytes` of TMA transfers on the barrier.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// kBox rows of head h from row0 (rows past the tensor are zero-filled)
// into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         int h, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(h * kD), "r"(row0), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N of this warp's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving uses of an accumulator across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The descriptor of a tile of 64-byte rows at shared address addr, 64-byte
// swizzled: 512 bytes from one group of 8 rows to the next, read K-major
// (rows are M or N, 32 bytes a k-step: add 2 for the second) or MN-major
// (rows are K, 1024 bytes a k-step: add 64). The leading offset is unused
// by both at these widths; it is set to the same 512 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(512 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// d = a . b^T (scale_d 1) or a . b^T alone (scale_d 0): m64n128k16,
// A and B K-major from shared memory.
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = a . b^T (scale_d 1) or a . b^T alone (scale_d 0): m64n64k16,
// A and B K-major from shared memory.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = a . b (scale_d 1) or a . b alone (scale_d 0): m64n32k16, A from
// registers (bf16x2), B MN-major from shared memory.
__device__ __forceinline__ void wgmma_m64n32_rs(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


// ------------------------------------------------------------ helpers

// bf16x2 of (lo, hi), each rounded to nearest even: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The accumulator of 16 columns (n-blocks 2s and 2s + 1, d[8s..8s+7]),
// rounded to bf16, as the A fragment of a product over those columns.
template <int N>
__device__ __forceinline__ void as_a(const float (&d)[N], int s,
                                     uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * s], d[8 * s + 1]);
  a[1] = pack_bf16(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack_bf16(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack_bf16(d[8 * s + 6], d[8 * s + 7]);
}

// exp(x) for finite x below 88, the scores' exp: 2^t on the SFU
// (ex2.approx, 2 ulp, as expf's own MUFU.EX2), t = x log2e rounded, times
// 1 + the rounding error of t (exact by an FMA, plus x times the error of
// the constant log2e) times ln 2, so that the result keeps expf's accuracy
// for any |t| (expf instead reduces t to [-0.5, 0.5] and scales by 2^j):
// 6 instructions where expf takes 8. Not for -inf (the masked keys of the
// forward's last tile take expf).
__device__ __forceinline__ float exp_sfu(float x) {
  const float t = x * 1.44269502f;
  const float r = fmaf(x, 1.925963033500011e-08f, fmaf(x, 1.44269502f, -t));
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  return fmaf(e * r, 0.693147181f, e);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows row and row + 8 of an output (n-block j: c0, c1 are d = 8j + 2t,
// 8j + 2t + 1 of the first row, c2, c3 of the second), each divided by its
// row's divisor and rounded to bf16.
__device__ __forceinline__ void store_rows(uint16_t* base, int row, int n,
                                           int h, int heads,
                                           const float (&d)[16], float div0,
                                           float div1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= n) continue;
    const float div = half ? div1 : div0;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        base + (static_cast<size_t>(r) * heads + h) * kD);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[4 * j + t] =
          pack_bf16(d[4 * j + 2 * half] / div, d[4 * j + 2 * half + 1] / div);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// The barriers after init, for every thread of the CTA.
__device__ __forceinline__ void barriers_ready() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
}

// Keeps the compiler from moving the packing of A fragments in among the
// wgmmas that read them.
template <int S>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

// Compile-time flags for the tile steps.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};
using Yes = Flag<true>;
using No = Flag<false>;

// The producer warpgroup gives up registers for the consumers: 24 a
// thread, and each consumer what is left of a scheduler's quarter of the
// SM's 65,536 (one warp of each warpgroup a scheduler): 240 with two
// consumer warpgroups.
constexpr int kConsumerRegs = ((16384 / 32 - 24) / kWgs) / 8 * 8;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs)
               : "memory");
}

// acc = acc * corr + part, row by row (c0, c1 of an n-block are the first
// row, c2, c3 the second).
__device__ __forceinline__ void add_scaled(float (&acc)[16], float corr0,
                                           float corr1,
                                           const float (&part)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[4 * j] = fmaf(acc[4 * j], corr0, part[4 * j]);
    acc[4 * j + 1] = fmaf(acc[4 * j + 1], corr0, part[4 * j + 1]);
    acc[4 * j + 2] = fmaf(acc[4 * j + 2], corr1, part[4 * j + 2]);
    acc[4 * j + 3] = fmaf(acc[4 * j + 3], corr1, part[4 * j + 3]);
  }
}


// ------------------------------------------------------------- forward

// Shared memory of the forward: Q (the CTA's 128 rows), kStages K tiles
// and kStages V tiles of 128 keys, then the barriers.
constexpr int kFwdTileBytes = kFwdTile * kRowBytes;
constexpr int kFwdK = kBlockRows * kRowBytes;
constexpr int kFwdV = kFwdK + kStages * kFwdTileBytes;
constexpr int kFwdBar = kFwdV + kStages * kFwdTileBytes;
constexpr int kFwdSmem = kFwdBar + 8 * (2 * kStages + 1) + 1024;

// S = Q K^T of 128 keys: two k-steps of 16 d.
__device__ __forceinline__ void scores128(float (&s)[64], uint64_t qd,
                                          uint32_t ktile) {
  const uint64_t kd = desc(ktile);
  wgmma_m64n128_ss(s, qd, kd, 0);
  wgmma_m64n128_ss(s, qd + 2, kd + 2, 1);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, int n,
                      int heads, float scale, uint16_t* __restrict__ out,
                      float* __restrict__ lse) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_u32(aligned_smem(smem_raw));
  const uint32_t full = s0 + kFwdBar, empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;
  const int h = blockIdx.y, r0 = blockIdx.x * kBlockRows;
  const int tiles = (n + kFwdTile - 1) / kFwdTile;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    mbar_init(qbar, 1);
  }
  barriers_ready();

  if (threadIdx.x >= kConsumers) {  // the producer: one lane loads
    producer_regs();
    if (threadIdx.x == kConsumers) {
      mbar_expect(qbar, kBlockRows * kRowBytes);
      for (int b = 0; b < kBlockRows / kBox; ++b)
        tma_rows(s0 + b * kBox * kRowBytes, &tq, h, r0 + b * kBox, qbar);
      for (int i = 0; i < tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, (i / kStages - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect(bar, 2 * kFwdTileBytes);
        const uint32_t kt = s0 + kFwdK + st * kFwdTileBytes;
        const uint32_t vt = s0 + kFwdV + st * kFwdTileBytes;
        for (int b = 0; b < kFwdTile / kBox; ++b) {
          tma_rows(kt + b * kBox * kRowBytes, &tk, h, i * kFwdTile + b * kBox,
                   bar);
          tma_rows(vt + b * kBox * kRowBytes, &tv, h, i * kFwdTile + b * kBox,
                   bar);
        }
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = r0 + wg * kWgRows + warp * 16 + g;  // and row + 8
  const uint64_t qd = desc(s0 + wg * kWgRows * kRowBytes);
  float sa[64], sb[64], acc[16], part[16];
  uint32_t pa[8][4], pb[8][4];
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY;  // rows row, row + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's columns' sums
  float c0 = 0.0f, c1 = 0.0f;  // the correction of the tile whose P.V runs
  mbar_wait(qbar, 0);

  // Tile j: S = Q K^T into s, the softmax, P into p and P.V issued at the
  // end, taken into acc at the next tile once that tile's S is in
  // (`first`: there is no earlier P.V; `last`: keys past n score -inf).
  // Both flags are compile-time, so that every wgmma and wait is issued
  // unconditionally and ptxas keeps them asynchronous; consecutive tiles
  // use two register sets, the loop runs two tiles a turn.
  auto tile = [&](auto first_t, auto last_t, int j, float(&s)[64],
                  uint32_t(&p)[8][4]) {
    constexpr bool first = decltype(first_t)::value;
    constexpr bool last = decltype(last_t)::value;
    const int st = j % kStages;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    fence_regs(s);
    wgmma_fence();
    scores128(s, qd, s0 + kFwdK + st * kFwdTileBytes);
    wgmma_commit();
    wgmma_wait<0>();  // and P.V of tile j - 1
    fence_regs(s);
    if constexpr (!first) {  // P.V of tile j - 1 into acc, its stage freed
      fence_regs(part);
      add_scaled(acc, c0, c1, part);
      mbar_arrive(empty + 8 * ((j - 1) % kStages));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], scale);
    if constexpr (last) {
      const int k0 = j * kFwdTile;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * b], s[4 * b + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * b + 2], s[4 * b + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float lp0 = 0.0f, lp1 = 0.0f;
    // the last tile's masked keys are -inf: expf there
    auto exp_s = [](float x) { return last ? expf(x) : exp_sfu(x); };
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      s[4 * b] = exp_s(s[4 * b] - mx0);
      s[4 * b + 1] = exp_s(s[4 * b + 1] - mx0);
      s[4 * b + 2] = exp_s(s[4 * b + 2] - mx1);
      s[4 * b + 3] = exp_s(s[4 * b + 3] - mx1);
      lp0 += s[4 * b] + s[4 * b + 1];
      lp1 += s[4 * b + 2] + s[4 * b + 3];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) as_a(s, k, p[k]);
    c0 = expf(m0 - mx0);  // 0 at the first tile
    c1 = expf(m1 - mx1);
    l0 = fmaf(l0, c0, lp0);
    l1 = fmaf(l1, c1, lp1);
    m0 = mx0;
    m1 = mx1;
    const uint64_t vd = desc(s0 + kFwdV + st * kFwdTileBytes);
    fence_frags(p);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 8; ++k) wgmma_m64n32_rs(part, p[k], vd + 64 * k, k);
    wgmma_commit();
  };
  if (tiles == 1) {
    tile(Yes{}, Yes{}, 0, sa, pa);
  } else {
    tile(Yes{}, No{}, 0, sa, pa);
    int j = 1;
#pragma unroll 1
    for (; j + 2 < tiles; j += 2) {
      tile(No{}, No{}, j, sb, pb);
      tile(No{}, No{}, j + 1, sa, pa);
    }
    if (j + 2 == tiles) {
      tile(No{}, No{}, j, sb, pb);
      tile(No{}, Yes{}, j + 1, sa, pa);
    } else {
      tile(No{}, Yes{}, j, sb, pb);
    }
  }
  wgmma_wait<0>();
  fence_regs(part);
  add_scaled(acc, c0, c1, part);
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows(out, row, n, h, heads, acc, l0, l1);
  if (t == 0) {
    float* lse_h = lse + static_cast<size_t>(h) * n;
    if (row < n) lse_h[row] = m0 + logf(l0);
    if (row + 8 < n) lse_h[row + 8] = m1 + logf(l1);
  }
}

// ------------------------------------------------------------------ dkv

// Shared memory of dkv: K and V (the CTA's 128 keys), kStages Q and dout
// tiles of 64 queries, kStages rows of lse and delta, then the barriers.
constexpr int kBwdTileBytes = kBwdTile * kRowBytes;
constexpr int kDkvQ = 2 * kBlockRows * kRowBytes;
constexpr int kDkvDo = kDkvQ + kStages * kBwdTileBytes;
constexpr int kDkvRows = kDkvDo + kStages * kBwdTileBytes;
constexpr int kRowsBytes = 2 * kBwdTile * 4;  // lse, delta of a tile
constexpr int kDkvBar = kDkvRows + kStages * kRowsBytes;
constexpr int kDkvSmem = kDkvBar + 8 * (2 * kStages + 1) + 1024;

// d = a . b^T over d = 0..31 for 64 rows of b: two k-steps of 16 d.
__device__ __forceinline__ void over_d64(float (&d)[32], uint64_t a,
                                         uint32_t btile) {
  const uint64_t bd = desc(btile);
  wgmma_m64n64_ss(d, a, bd, 0);
  wgmma_m64n64_ss(d, a + 2, bd + 2, 1);
}

// d = a . (64 rows of a tile) into d = 0..31, a from registers: four
// k-steps of 16 rows, a fresh sum.
__device__ __forceinline__ void over_rows64(float (&d)[16],
                                            const uint32_t (&a)[4][4],
                                            uint32_t tile) {
  const uint64_t bd = desc(tile);
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_m64n32_rs(d, a[s], bd + 64 * s, s);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int n, int heads,
                      float scale, uint16_t* __restrict__ dk,
                      uint16_t* __restrict__ dv) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t full = s0 + kDkvBar, empty = full + 8 * kStages;
  const uint32_t kvbar = empty + 8 * kStages;
  const int h = blockIdx.y, r0 = blockIdx.x * kBlockRows;
  const int tiles = (n + kBwdTile - 1) / kBwdTile;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * st, kConsumers);
    }
    mbar_init(kvbar, 1);
  }
  barriers_ready();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= kConsumers) {  // the producer: its first warp loads
    producer_regs();
    if (threadIdx.x >= kConsumers + 32) return;
    if (lane == 0) {
      mbar_expect(kvbar, 2 * kBlockRows * kRowBytes);
      for (int b = 0; b < kBlockRows / kBox; ++b) {
        tma_rows(s0 + b * kBox * kRowBytes, &tk, h, r0 + b * kBox, kvbar);
        tma_rows(s0 + (kBlockRows + b * kBox) * kRowBytes, &tv, h,
                 r0 + b * kBox, kvbar);
      }
    }
    const float* lse_h = lse + static_cast<size_t>(h) * n;
    const float* delta_h = delta + static_cast<size_t>(h) * n;
    for (int i = 0; i < tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * st, (i / kStages - 1) & 1);
      float* rows = reinterpret_cast<float*>(smem + kDkvRows +
                                             st * kRowsBytes);
      const int q0 = i * kBwdTile;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * lane + e, qi = q0 + c;
        rows[c] = qi < n ? lse_h[qi] : 0.0f;
        rows[kBwdTile + c] = qi < n ? delta_h[qi] : 0.0f;
      }
      const uint32_t bar = full + 8 * st;
      if (lane == 0) {
        mbar_expect(bar, 2 * kBwdTileBytes);
        tma_rows(s0 + kDkvQ + st * kBwdTileBytes, &tq, h, q0, bar);
        tma_rows(s0 + kDkvDo + st * kBwdTileBytes, &tdo, h, q0, bar);
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int t = lane & 3;
  const int row = r0 + wg * kWgRows + warp * 16 + (lane >> 2);  // a key
  const uint64_t kd = desc(s0 + wg * kWgRows * kRowBytes);
  const uint64_t vd = desc(s0 + (kBlockRows + wg * kWgRows) * kRowBytes);
  float dk_acc[16], dv_acc[16];
  zero(dk_acc);
  zero(dv_acc);
  // S^T and dP^T of a tile (rows keys, columns queries), two tiles' worth
  float sa[32], da[32], sb[32], db[32];
  mbar_wait(kvbar, 0);
  mbar_wait(full, 0);
  fence_regs(sa);
  fence_regs(da);
  wgmma_fence();
  over_d64(sa, kd, s0 + kDkvQ);
  over_d64(da, vd, s0 + kDkvDo);
  wgmma_commit();

  // Tile i: its S^T and dP^T are in sT and dpT (issued one tile before);
  // the next tile's go into the other pair before this tile's P and dS
  // (`more`, a compile-time flag: there is a next tile).
  auto tile = [&](auto more_t, int i, float(&sT)[32], float(&dpT)[32],
                  float(&sT_n)[32], float(&dpT_n)[32]) {
    constexpr bool more = decltype(more_t)::value;
    const int st = i % kStages;
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    if constexpr (more) {
      const int st1 = (i + 1) % kStages;
      mbar_wait(full + 8 * st1, ((i + 1) / kStages) & 1);
      fence_regs(sT_n);
      fence_regs(dpT_n);
      wgmma_fence();
      over_d64(sT_n, kd, s0 + kDkvQ + st1 * kBwdTileBytes);
      over_d64(dpT_n, vd, s0 + kDkvDo + st1 * kBwdTileBytes);
      wgmma_commit();
    }
    const float* l_s =
        reinterpret_cast<const float*>(smem + kDkvRows + st * kRowsBytes);
    const float* d_s = l_s + kBwdTile;
    const int q0 = i * kBwdTile;
    const bool tail = !more && q0 + kBwdTile > n;  // queries past n: P = 0
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      // columns 8b + 2t and 8b + 2t + 1: c & 1 of the block
      const float2 lse2 =
          *reinterpret_cast<const float2*>(l_s + 8 * b + 2 * t);
      const float2 del2 =
          *reinterpret_cast<const float2*>(d_s + 8 * b + 2 * t);
      const int qi = q0 + 8 * b + 2 * t;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool odd = c & 1;
        float p = exp_sfu(__fmul_rn(sT[4 * b + c], scale) -
                       (odd ? lse2.y : lse2.x));
        if (tail && qi + odd >= n) p = 0.0f;
        dpT[4 * b + c] =
            (dpT[4 * b + c] - (odd ? del2.y : del2.x)) * p * scale;
        sT[4 * b + c] = p;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      as_a(sT, s, pa[s]);
      as_a(dpT, s, dsa[s]);
    }
    const uint32_t qt = s0 + kDkvQ + st * kBwdTileBytes;
    const uint32_t dot = s0 + kDkvDo + st * kBwdTileBytes;
    float pdv[16], pdk[16];
    fence_frags(pa);
    fence_frags(dsa);
    fence_regs(pdv);
    fence_regs(pdk);
    wgmma_fence();
    over_rows64(pdv, pa, dot);  // P^T dout
    over_rows64(pdk, dsa, qt);  // dS^T Q
    wgmma_commit();
    wgmma_wait<0>();  // and the next tile's S^T, dP^T, issued before
    fence_regs(pdv);
    fence_regs(pdk);
    mbar_arrive(empty + 8 * st);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      dk_acc[c] += pdk[c];
      dv_acc[c] += pdv[c];
    }
  };
  int i = 0;
#pragma unroll 1
  for (; i + 2 < tiles; i += 2) {
    tile(Yes{}, i, sa, da, sb, db);
    tile(Yes{}, i + 1, sb, db, sa, da);
  }
  if (i + 2 == tiles) {
    tile(Yes{}, i, sa, da, sb, db);
    tile(No{}, i + 1, sb, db, sa, da);
  } else {
    tile(No{}, i, sa, da, sb, db);
  }
  store_rows(dk, row, n, h, heads, dk_acc, 1.0f, 1.0f);
  store_rows(dv, row, n, h, heads, dv_acc, 1.0f, 1.0f);
}

// ------------------------------------------------------------------- dq

// Shared memory of dq: Q and dout (the CTA's 128 queries), kStages K and
// V tiles of 64 keys, then the barriers.
constexpr int kDqK = 2 * kBlockRows * kRowBytes;
constexpr int kDqV = kDqK + kStages * kBwdTileBytes;
constexpr int kDqBar = kDqV + kStages * kBwdTileBytes;
constexpr int kDqSmem = kDqBar + 8 * (2 * kStages + 1) + 1024;

__global__ void __launch_bounds__(kThreads, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int n, int heads,
                     float scale, uint16_t* __restrict__ dq) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_u32(aligned_smem(smem_raw));
  const uint32_t full = s0 + kDqBar, empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;
  const int h = blockIdx.y, r0 = blockIdx.x * kBlockRows;
  const int tiles = (n + kBwdTile - 1) / kBwdTile;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    mbar_init(qbar, 1);
  }
  barriers_ready();

  if (threadIdx.x >= kConsumers) {  // the producer: one lane loads
    producer_regs();
    if (threadIdx.x == kConsumers) {
      mbar_expect(qbar, 2 * kBlockRows * kRowBytes);
      for (int b = 0; b < kBlockRows / kBox; ++b) {
        tma_rows(s0 + b * kBox * kRowBytes, &tq, h, r0 + b * kBox, qbar);
        tma_rows(s0 + (kBlockRows + b * kBox) * kRowBytes, &tdo, h,
                 r0 + b * kBox, qbar);
      }
      for (int i = 0; i < tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, (i / kStages - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect(bar, 2 * kBwdTileBytes);
        tma_rows(s0 + kDqK + st * kBwdTileBytes, &tk, h, i * kBwdTile, bar);
        tma_rows(s0 + kDqV + st * kBwdTileBytes, &tv, h, i * kBwdTile, bar);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = r0 + wg * kWgRows + warp * 16 + (lane >> 2);  // a query
  const uint64_t qd = desc(s0 + wg * kWgRows * kRowBytes);
  const uint64_t dod = desc(s0 + (kBlockRows + wg * kWgRows) * kRowBytes);
  const float* lse_h = lse + static_cast<size_t>(h) * n;
  const float* delta_h = delta + static_cast<size_t>(h) * n;
  const float lse0 = row < n ? lse_h[row] : 0.0f;
  const float lse1 = row + 8 < n ? lse_h[row + 8] : 0.0f;
  const float del0 = row < n ? delta_h[row] : 0.0f;
  const float del1 = row + 8 < n ? delta_h[row + 8] : 0.0f;
  float acc[16], part[16];
  zero(acc);
  float sa[32], da[32], sb[32], db[32];  // S and dP, two tiles' worth
  uint32_t ga[4][4], gb[4][4];           // dS as A fragments, two tiles'
  mbar_wait(qbar, 0);
  mbar_wait(full, 0);
  fence_regs(sa);
  fence_regs(da);
  wgmma_fence();
  over_d64(sa, qd, s0 + kDqK);    // S = Q K^T
  over_d64(da, dod, s0 + kDqV);   // dP = dout V^T
  wgmma_commit();

  // Tile i: its S and dP are in s and dp (issued one tile before), the
  // next tile's go into the other pair before this tile's dS (`more`);
  // this tile's dS K is taken into acc one tile later (`first`: there is
  // none of an earlier tile). Both flags are compile-time, as in the
  // forward.
  auto tile = [&](auto more_t, auto first_t, int i, float(&s)[32],
                  float(&dp)[32], float(&s_n)[32], float(&dp_n)[32],
                  uint32_t(&dsa)[4][4]) {
    constexpr bool more = decltype(more_t)::value;
    constexpr bool first = decltype(first_t)::value;
    const int st = i % kStages;
    // in flight: S and dP of tile i, then dS K of tile i - 1
    if constexpr (first) wgmma_wait<0>(); else wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    if constexpr (more) {
      const int st1 = (i + 1) % kStages;
      mbar_wait(full + 8 * st1, ((i + 1) / kStages) & 1);
      fence_regs(s_n);
      fence_regs(dp_n);
      wgmma_fence();
      over_d64(s_n, qd, s0 + kDqK + st1 * kBwdTileBytes);
      over_d64(dp_n, dod, s0 + kDqV + st1 * kBwdTileBytes);
      wgmma_commit();
    }
    const int k0 = i * kBwdTile;
    const bool tail = !more && k0 + kBwdTile > n;  // keys past n: P = 0
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool second = c & 2;
      float p = exp_sfu(__fmul_rn(s[c], scale) - (second ? lse1 : lse0));
      if (tail && k0 + 8 * (c >> 2) + 2 * t + (c & 1) >= n) p = 0.0f;
      dp[c] = (dp[c] - (second ? del1 : del0)) * p * scale;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) as_a(dp, k, dsa[k]);
    if constexpr (!first) {  // dS K of tile i - 1 into acc, its stage freed
      if constexpr (more) wgmma_wait<1>(); else wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] += part[c];
      mbar_arrive(empty + 8 * ((i - 1) % kStages));
    }
    fence_frags(dsa);
    fence_regs(part);
    wgmma_fence();
    over_rows64(part, dsa, s0 + kDqK + st * kBwdTileBytes);  // dS K
    wgmma_commit();
  };
  if (tiles == 1) {
    tile(No{}, Yes{}, 0, sa, da, sb, db, ga);
  } else {
    tile(Yes{}, Yes{}, 0, sa, da, sb, db, ga);
    int i = 1;
#pragma unroll 1
    for (; i + 2 < tiles; i += 2) {
      tile(Yes{}, No{}, i, sb, db, sa, da, gb);
      tile(Yes{}, No{}, i + 1, sa, da, sb, db, ga);
    }
    if (i + 2 == tiles) {
      tile(Yes{}, No{}, i, sb, db, sa, da, gb);
      tile(No{}, No{}, i + 1, sa, da, sb, db, ga);
    } else {
      tile(No{}, No{}, i, sb, db, sa, da, gb);
    }
  }
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] += part[c];
  store_rows(dq, row, n, h, heads, acc, 1.0f, 1.0f);
}

// A 2-D map of the (n, heads, 32) bf16 tensor at base as (n, 32 heads):
// boxes of kBox rows x 32 values, 64-byte swizzled, rows past n read as 0.
bool encode(CUtensorMap* map, const void* base, int n, int heads) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(heads) * kD,
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(heads) * kRowBytes};
  const cuuint32_t box[2] = {kD, kBox};
  const cuuint32_t step[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

dim3 grid_for(int n, int heads) {
  return dim3((n + kBlockRows - 1) / kBlockRows, heads);
}

}  // namespace

// All three launch on `stream` (a cudaStream_t) and do not synchronise.
// q, k, v, out, dout, dq, dk, dv are contiguous (n, heads, 32) bf16 (their
// 16 bits), 16-byte aligned; lse and delta (heads, n) float32. Each returns
// cudaGetLastError() as an int, 0 on success, or cudaErrorInvalidValue if
// a tensor map could not be encoded.
extern "C" int gh_flash_forward_bf16(const void* q, const void* k,
                                     const void* v, int n, int heads,
                                     float scale, void* out, void* lse,
                                     void* stream) {
  if (n > 0) {
    CUtensorMap tq, tk, tv;
    if (!encode(&tq, q, n, heads) || !encode(&tk, k, n, heads) ||
        !encode(&tv, v, n, heads))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_bf16_kernel<<<grid_for(n, heads), kThreads, kFwdSmem,
                            static_cast<cudaStream_t>(stream)>>>(
        tq, tk, tv, n, heads, scale, static_cast<uint16_t*>(out),
        static_cast<float*>(lse));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gh_flash_backward_dkv_bf16(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          int n, int heads, float scale,
                                          void* dk, void* dv, void* stream) {
  if (n > 0) {
    CUtensorMap tq, tk, tv, tdo;
    if (!encode(&tq, q, n, heads) || !encode(&tk, k, n, heads) ||
        !encode(&tv, v, n, heads) || !encode(&tdo, dout, n, heads))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dkv_bf16_kernel<<<grid_for(n, heads), kThreads, kDkvSmem,
                            static_cast<cudaStream_t>(stream)>>>(
        tq, tk, tv, tdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), n, heads, scale,
        static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gh_flash_backward_dq_bf16(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         int n, int heads, float scale,
                                         void* dq, void* stream) {
  if (n > 0) {
    CUtensorMap tq, tk, tv, tdo;
    if (!encode(&tq, q, n, heads) || !encode(&tk, k, n, heads) ||
        !encode(&tv, v, n, heads) || !encode(&tdo, dout, n, heads))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dq_bf16_kernel<<<grid_for(n, heads), kThreads, kDqSmem,
                           static_cast<cudaStream_t>(stream)>>>(
        tq, tk, tv, tdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), n, heads, scale,
        static_cast<uint16_t*>(dq));
  }
  return static_cast<int>(cudaGetLastError());
}
