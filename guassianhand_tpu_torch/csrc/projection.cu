// Fused EWA projection of 3D Gaussians and its adjoint, for Hopper (sm_90a),
// for V views in one launch.
//
// Replaces: guassianhand_tpu/ops/projection_pallas.py::project_gaussians_pallas
// (-> the _project custom_vjp -> _call; kernels _proj_fwd_kernel and
// _proj_bwd_kernel, math _fwd_math), the rasterizer's preprocess with
// RasterizeConfig.projection_impl = "pallas", which ops/rasterize.py:527
// batches over the views with jax.vmap (a view axis on the Pallas grid).
//
// What it computes, per Gaussian and view: world to camera (R, t), the
// pinhole projection through the full 4x4 projection to pixel means, the
// EWA 2D covariance J W Sigma W^T J^T with the view-space x/y clamped at
// 1.3 tan(fov/2) and +0.3 px dilation, its inverse (the conic), the radius
// ceil(3 sqrt(lambda_max)) and the visibility (in front of z = 0.2, det > 0,
// radius > 0). The forward reads 10 floats a Gaussian (xyz, scale, the raw
// quaternion) and writes 8 values a Gaussian and view (mean2d x/y, depth,
// conic A/B/C, radius, visible). The adjoint recomputes the forward of each
// view, reads the same 10 plus the 5 cotangents of mean2d and conic of each
// view, and writes the 10 gradients of xyz, scale and quaternion, summed
// over the views; a view where the row is not visible adds 0 and depth gets
// no gradient, as in the TPU kernel. Each view's 30 camera constants
// (ops/projection_cuda.py::camera_consts) come in one (V, 30) array.
//
// What bounds it on this card: launch latency, then one thread's dependent
// chain. About 150 fp32 operations a Gaussian and view forward and 450
// backward (IEEE divisions and square roots among them) against 72 and 100
// bytes moved: at 30,808 Gaussians the bytes bound is 0.6 and 0.9 us, under
// the cost of one launch, and the chain of one thread (a few hundred
// dependent instructions) is longer than the loads.
//
// What the design does about it: one launch for all views. The forward's
// grid is (ceil(N / 128), V): a CTA holds 128 Gaussians of one view and
// reads that view's constants once into shared memory, so the 30,808
// Gaussians of the fit make 241 CTAs and reach all 132 SMs (256-thread
// CTAs made 121), and a request's 4 views are one launch of 964 CTAs
// instead of four launches. The adjoint runs one thread a Gaussian over
// every view in order, all V views' constants in shared memory, and sums
// the views' gradients in view order in registers: no atomics, the same
// bits from run to run, one launch for any V; it is compiled once for one
// view (the fit's case, straight-line code) and once for any count. The
// quaternion rows load as one 16-byte load where the array is 16-byte
// aligned. The TPU kernel's 4096-wide blocks and its padding to them are
// TPU layout and are not carried over; the arrays keep the port's layout
// (N, 3) / (N, 4) in and (V, N, 2) / (V, N) / (V, N, 3) out, so the
// wrapper copies nothing.
//
// Numerics: every operation is a round-to-nearest intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn), applied in the order of the plain
// PyTorch twin (ops/projection_cuda.py::_fwd_math and
// project_adjoint_plain), which follows the JAX kernel's expressions. The
// compiler contracts none of them into FMAs, so each value rounds as the
// twin's eager PyTorch ops round it on the card: the discrete outputs
// (radius, visible) come out equal, and so does the sum over views, which
// the twin adds in the same order. The quaternion norm uses rsqrtf, the
// function torch.rsqrt calls on the card. max/min/clamp keep PyTorch's NaN
// propagation.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kConsts = 30;
constexpr float kNearCullZ = 0.2f;
constexpr float kCovDilation = 0.3f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
// torch.maximum / torch.minimum / torch.clamp: a NaN operand wins
__device__ __forceinline__ float maxnan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minnan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
// a0 * b0 + a1 * b1 + a2 * b2 (+ c), summed left to right
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}
__device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// The forward's values, kept for the adjoint.
struct Fwd {
  float tz, hx, hy, pw, m2x, m2y, rx, ry, tx, ty, inv_z, inv_z2;
  float c0[3], c1[3];
  float qn[4], qnorm;
  float m[9];  // m00 m01 m02 m10 m11 m12 m20 m21 m22
  float w0[3], w1[3], u[3], v[3];
  float a, b, c, det, inv_det, radius;
  bool in_front, visible;
};

__device__ __forceinline__ void fwd_math(const float* __restrict__ cs, float x,
                                         float y, float z, float sx, float sy,
                                         float sz, float qr, float qx,
                                         float qy, float qz, Fwd& f) {
  const float R00 = cs[0], R01 = cs[1], R02 = cs[2];
  const float R10 = cs[3], R11 = cs[4], R12 = cs[5];
  const float R20 = cs[6], R21 = cs[7], R22 = cs[8];
  const float t0 = cs[9], t1 = cs[10], t2 = cs[11];
  const float F00 = cs[12], F01 = cs[13], F02 = cs[14], F03 = cs[15];
  const float F10 = cs[16], F11 = cs[17], F12 = cs[18], F13 = cs[19];
  const float F30 = cs[20], F31 = cs[21], F32 = cs[22], F33 = cs[23];
  const float fx = cs[24], fy = cs[25], limx = cs[26], limy = cs[27];
  const float W = cs[28], H = cs[29];

  const float pcx = add(dot3(R00, x, R01, y, R02, z), t0);
  const float pcy = add(dot3(R10, x, R11, y, R12, z), t1);
  f.tz = add(dot3(R20, x, R21, y, R22, z), t2);
  f.in_front = f.tz > kNearCullZ;
  const float tzs = f.in_front ? f.tz : 1.0f;

  f.hx = add(dot3(F00, x, F01, y, F02, z), F03);
  f.hy = add(dot3(F10, x, F11, y, F12, z), F13);
  const float hw = add(dot3(F30, x, F31, y, F32, z), F33);
  f.pw = dv(1.0f, add(hw, 1e-7f));
  f.m2x = sub(mul(mul(add(mul(f.hx, f.pw), 1.0f), 0.5f), W), 0.5f);
  f.m2y = sub(mul(mul(add(mul(f.hy, f.pw), 1.0f), 0.5f), H), 0.5f);

  f.rx = dv(pcx, tzs);
  f.ry = dv(pcy, tzs);
  const float txtz = minnan(maxnan(f.rx, -limx), limx);
  const float tytz = minnan(maxnan(f.ry, -limy), limy);
  f.tx = mul(txtz, tzs);
  f.ty = mul(tytz, tzs);

  f.inv_z = dv(1.0f, tzs);
  f.inv_z2 = mul(f.inv_z, f.inv_z);
  const float k0 = mul(fx, f.inv_z);
  const float k2x = mul(mul(fx, f.tx), f.inv_z2);
  const float k1 = mul(fy, f.inv_z);
  const float k2y = mul(mul(fy, f.ty), f.inv_z2);
  f.c0[0] = sub(mul(k0, R00), mul(k2x, R20));
  f.c0[1] = sub(mul(k0, R01), mul(k2x, R21));
  f.c0[2] = sub(mul(k0, R02), mul(k2x, R22));
  f.c1[0] = sub(mul(k1, R10), mul(k2y, R20));
  f.c1[1] = sub(mul(k1, R11), mul(k2y, R21));
  f.c1[2] = sub(mul(k1, R12), mul(k2y, R22));

  f.qnorm = rsqrtf(add(add(add(mul(qr, qr), mul(qx, qx)), mul(qy, qy)),
                       mul(qz, qz)));
  const float r = mul(qr, f.qnorm), xq = mul(qx, f.qnorm);
  const float yq = mul(qy, f.qnorm), zq = mul(qz, f.qnorm);
  f.qn[0] = r; f.qn[1] = xq; f.qn[2] = yq; f.qn[3] = zq;
  float* m = f.m;
  m[0] = sub(1.0f, mul(2.0f, add(mul(yq, yq), mul(zq, zq))));
  m[1] = mul(2.0f, sub(mul(xq, yq), mul(r, zq)));
  m[2] = mul(2.0f, add(mul(xq, zq), mul(r, yq)));
  m[3] = mul(2.0f, add(mul(xq, yq), mul(r, zq)));
  m[4] = sub(1.0f, mul(2.0f, add(mul(xq, xq), mul(zq, zq))));
  m[5] = mul(2.0f, sub(mul(yq, zq), mul(r, xq)));
  m[6] = mul(2.0f, sub(mul(xq, zq), mul(r, yq)));
  m[7] = mul(2.0f, add(mul(yq, zq), mul(r, xq)));
  m[8] = sub(1.0f, mul(2.0f, add(mul(xq, xq), mul(yq, yq))));

  // w_j = sum_i m_ij c_i
  for (int j = 0; j < 3; ++j) {
    f.w0[j] = dot3(m[j], f.c0[0], m[3 + j], f.c0[1], m[6 + j], f.c0[2]);
    f.w1[j] = dot3(m[j], f.c1[0], m[3 + j], f.c1[1], m[6 + j], f.c1[2]);
  }
  const float s[3] = {sx, sy, sz};
  for (int j = 0; j < 3; ++j) {
    f.u[j] = mul(s[j], f.w0[j]);
    f.v[j] = mul(s[j], f.w1[j]);
  }

  f.a = add(dot3(f.u[0], f.u[0], f.u[1], f.u[1], f.u[2], f.u[2]), kCovDilation);
  f.b = dot3(f.u[0], f.v[0], f.u[1], f.v[1], f.u[2], f.v[2]);
  f.c = add(dot3(f.v[0], f.v[0], f.v[1], f.v[1], f.v[2], f.v[2]), kCovDilation);

  f.det = sub(mul(f.a, f.c), mul(f.b, f.b));
  const bool det_ok = f.det > 0.0f;
  f.inv_det = dv(1.0f, det_ok ? f.det : 1.0f);

  const float mid = mul(0.5f, add(f.a, f.c));
  const float disc = __fsqrt_rn(maxnan(sub(mul(mid, mid), f.det), 0.1f));
  const float radius =
      ceilf(mul(3.0f, __fsqrt_rn(maxnan(add(mid, disc), 0.0f))));
  f.visible = f.in_front && det_ok && radius > 0.0f;
  f.radius = f.visible ? radius : 0.0f;
}

// One row's xyz, scale and raw quaternion.
struct Row {
  float x, y, z, sx, sy, sz, qr, qx, qy, qz;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ xyz,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ rot,
                                        bool rot_aligned, int i) {
  Row w;
  w.x = __ldg(xyz + 3 * i);
  w.y = __ldg(xyz + 3 * i + 1);
  w.z = __ldg(xyz + 3 * i + 2);
  w.sx = __ldg(scale + 3 * i);
  w.sy = __ldg(scale + 3 * i + 1);
  w.sz = __ldg(scale + 3 * i + 2);
  if (rot_aligned) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(rot) + i);
    w.qr = q.x; w.qx = q.y; w.qy = q.z; w.qz = q.w;
  } else {
    w.qr = __ldg(rot + 4 * i);
    w.qx = __ldg(rot + 4 * i + 1);
    w.qy = __ldg(rot + 4 * i + 2);
    w.qz = __ldg(rot + 4 * i + 3);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ scale,
                   const float* __restrict__ rot, bool rot_aligned,
                   const float* __restrict__ consts, int n,
                   float* __restrict__ mean2d, float* __restrict__ depth,
                   float* __restrict__ conic, float* __restrict__ radius,
                   bool* __restrict__ visible) {
  __shared__ float cs[kConsts];
  const int view = blockIdx.y;
  if (threadIdx.x < kConsts)
    cs[threadIdx.x] = consts[view * kConsts + threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Row w = load_row(xyz, scale, rot, rot_aligned, i);
  Fwd f;
  fwd_math(cs, w.x, w.y, w.z, w.sx, w.sy, w.sz, w.qr, w.qx, w.qy, w.qz, f);
  const size_t o = static_cast<size_t>(view) * n + i;
  reinterpret_cast<float2*>(mean2d)[o] = make_float2(f.m2x, f.m2y);
  depth[o] = f.tz;
  conic[3 * o] = mul(f.c, f.inv_det);
  conic[3 * o + 1] = mul(-f.b, f.inv_det);
  conic[3 * o + 2] = mul(f.a, f.inv_det);
  radius[o] = f.radius;
  visible[o] = f.visible;
}

// The adjoint of one view: the gradients of xyz (3), scale (3) and the raw
// quaternion (4) from the cotangents of mean2d (gm) and conic (gcn).
__device__ __forceinline__ void adjoint(const float* __restrict__ cs,
                                        const Row& w, const float gm[2],
                                        const float gcn[3], float g_xyz[3],
                                        float g_scale[3], float g_rot[4]) {
  Fwd f;
  fwd_math(cs, w.x, w.y, w.z, w.sx, w.sy, w.sz, w.qr, w.qx, w.qy, w.qz, f);
  const float R00 = cs[0], R01 = cs[1], R02 = cs[2];
  const float R10 = cs[3], R11 = cs[4], R12 = cs[5];
  const float R20 = cs[6], R21 = cs[7], R22 = cs[8];
  const float F00 = cs[12], F01 = cs[13], F02 = cs[14];
  const float F10 = cs[16], F11 = cs[17], F12 = cs[18];
  const float F30 = cs[20], F31 = cs[21], F32 = cs[22];
  const float fx = cs[24], fy = cs[25], limx = cs[26], limy = cs[27];
  const float W = cs[28], H = cs[29];

  const float live = f.visible ? 1.0f : 0.0f;
  const float ga = mul(gcn[0], live);
  const float gb = mul(gcn[1], live);
  const float gc = mul(gcn[2], live);
  const float gmx = mul(gm[0], live);
  const float gmy = mul(gm[1], live);

  // conic = (c, -b, a) / det
  const float inv_det = f.inv_det, a = f.a, b = f.b, c = f.c;
  float g_c = mul(ga, inv_det);
  float g_b = mul(-gb, inv_det);
  float g_a = mul(gc, inv_det);
  const float g_det = mul(
      mul(-add(sub(mul(ga, c), mul(gb, b)), mul(gc, a)), inv_det), inv_det);
  g_a = add(g_a, mul(g_det, c));
  g_c = add(g_c, mul(g_det, a));
  g_b = sub(g_b, mul(mul(2.0f, g_det), b));

  // a = sum u^2 + d; b = sum u v; c = sum v^2 + d
  float gu[3], gv[3];
  for (int j = 0; j < 3; ++j) {
    gu[j] = add(mul(mul(2.0f, g_a), f.u[j]), mul(g_b, f.v[j]));
    gv[j] = add(mul(mul(2.0f, g_c), f.v[j]), mul(g_b, f.u[j]));
  }

  // u_j = s_j w0_j; v_j = s_j w1_j
  const float s[3] = {w.sx, w.sy, w.sz};
  float gw0[3], gw1[3];
  for (int j = 0; j < 3; ++j) {
    g_scale[j] = add(mul(gu[j], f.w0[j]), mul(gv[j], f.w1[j]));
    gw0[j] = mul(gu[j], s[j]);
    gw1[j] = mul(gv[j], s[j]);
  }

  // w0_j = sum_i m_ij c0_i; w1_j = sum_i m_ij c1_i
  float gm9[9];  // gm9[3 i + j] = d/d m_ij
  for (int ii = 0; ii < 3; ++ii) {
    for (int j = 0; j < 3; ++j) {
      gm9[3 * ii + j] = add(mul(gw0[j], f.c0[ii]), mul(gw1[j], f.c1[ii]));
    }
  }
  const float* m = f.m;
  float gc0[3], gc1[3];
  for (int ii = 0; ii < 3; ++ii) {
    gc0[ii] = dot3(gw0[0], m[3 * ii], gw0[1], m[3 * ii + 1], gw0[2],
                   m[3 * ii + 2]);
    gc1[ii] = dot3(gw1[0], m[3 * ii], gw1[1], m[3 * ii + 1], gw1[2],
                   m[3 * ii + 2]);
  }

  // the quaternion chain: m <- normalised (r, xq, yq, zq) <- raw q
  const float r = f.qn[0], xq = f.qn[1], yq = f.qn[2], zq = f.qn[3];
  const float gm00 = gm9[0], gm01 = gm9[1], gm02 = gm9[2];
  const float gm10 = gm9[3], gm11 = gm9[4], gm12 = gm9[5];
  const float gm20 = gm9[6], gm21 = gm9[7], gm22 = gm9[8];
  const float g_r = mul(2.0f, add(sub(sub(add(add(mul(-gm01, zq),
                                                  mul(gm02, yq)),
                                              mul(gm10, zq)),
                                          mul(gm12, xq)),
                                      mul(gm20, yq)),
                                  mul(gm21, xq)));
  const float g_x = sub(
      mul(2.0f, add(add(sub(add(add(mul(gm01, yq), mul(gm02, zq)),
                                mul(gm10, yq)),
                            mul(gm12, r)),
                        mul(gm20, zq)),
                    mul(gm21, r))),
      mul(mul(4.0f, xq), add(gm11, gm22)));
  const float g_y = sub(
      mul(2.0f, add(sub(add(add(add(mul(gm01, xq), mul(gm02, r)),
                                mul(gm10, xq)),
                            mul(gm12, zq)),
                        mul(gm20, r)),
                    mul(gm21, zq))),
      mul(mul(4.0f, yq), add(gm00, gm22)));
  const float g_z = sub(
      mul(2.0f, add(add(add(add(add(mul(-gm01, r), mul(gm02, xq)),
                                mul(gm10, r)),
                            mul(gm12, yq)),
                        mul(gm20, xq)),
                    mul(gm21, yq))),
      mul(mul(4.0f, zq), add(gm00, gm11)));
  // qn = q rsqrt(|q|^2): g_q = (g_qn - qn <qn, g_qn>) qnorm
  const float dot = add(add(add(mul(r, g_r), mul(xq, g_x)), mul(yq, g_y)),
                        mul(zq, g_z));
  const float qnorm = f.qnorm;
  g_rot[0] = mul(sub(g_r, mul(r, dot)), qnorm);
  g_rot[1] = mul(sub(g_x, mul(xq, dot)), qnorm);
  g_rot[2] = mul(sub(g_y, mul(yq, dot)), qnorm);
  g_rot[3] = mul(sub(g_z, mul(zq, dot)), qnorm);

  // c0_i = fx inv_z R0_i - fx tx inv_z2 R2_i (c1 with fy, ty, R1)
  const float inv_z = f.inv_z, inv_z2 = f.inv_z2, tx = f.tx, ty = f.ty;
  const float s0 = dot3(gc0[0], R00, gc0[1], R01, gc0[2], R02);
  const float s2x = dot3(gc0[0], R20, gc0[1], R21, gc0[2], R22);
  const float s1 = dot3(gc1[0], R10, gc1[1], R11, gc1[2], R12);
  const float s2y = dot3(gc1[0], R20, gc1[1], R21, gc1[2], R22);
  float g_invz = add(mul(fx, s0), mul(fy, s1));
  const float g_tx = mul(mul(-fx, inv_z2), s2x);
  const float g_ty = mul(mul(-fy, inv_z2), s2y);
  const float g_invz2 = sub(mul(mul(-fx, tx), s2x), mul(mul(fy, ty), s2y));
  g_invz = add(g_invz, mul(mul(2.0f, inv_z), g_invz2));
  float g_tzs = mul(-inv_z2, g_invz);

  // tx = clip(pcx / tzs, +-limx) tzs: the identity inside the clamp,
  // sign limx tzs outside it
  const bool clx = fabsf(f.rx) > limx;
  const bool cly = fabsf(f.ry) > limy;
  const float g_pcx = clx ? 0.0f : g_tx;
  const float g_pcy = cly ? 0.0f : g_ty;
  g_tzs = add(add(g_tzs, clx ? mul(mul(sign(f.rx), limx), g_tx) : 0.0f),
              cly ? mul(mul(sign(f.ry), limy), g_ty) : 0.0f);

  // the mean2d chain
  const float pw = f.pw;
  const float g_ndcx = mul(mul(gmx, 0.5f), W);
  const float g_ndcy = mul(mul(gmy, 0.5f), H);
  const float g_hx = mul(g_ndcx, pw);
  const float g_hy = mul(g_ndcy, pw);
  const float g_pw = add(mul(g_ndcx, f.hx), mul(g_ndcy, f.hy));
  const float g_hw = mul(mul(-pw, pw), g_pw);

  // tzs = where(in_front, tz, 1): culled rows are not visible (live 0)
  const float g_tz = f.in_front ? g_tzs : 0.0f;

  g_xyz[0] = add(add(add(dot3(R00, g_pcx, R10, g_pcy, R20, g_tz),
                         mul(F00, g_hx)), mul(F10, g_hy)),
                 mul(F30, g_hw));
  g_xyz[1] = add(add(add(dot3(R01, g_pcx, R11, g_pcy, R21, g_tz),
                         mul(F01, g_hx)), mul(F11, g_hy)),
                 mul(F31, g_hw));
  g_xyz[2] = add(add(add(dot3(R02, g_pcx, R12, g_pcy, R22, g_tz),
                         mul(F02, g_hx)), mul(F12, g_hy)),
                 mul(F32, g_hw));
}

// kViews > 0: compiled for exactly that many views (the fit's one view runs
// straight-line code, which a loop over a runtime count slowed); 0: any.
template <int kViews>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ scale,
                   const float* __restrict__ rot, bool rot_aligned,
                   const float* __restrict__ consts,
                   const float* __restrict__ g_mean2d,
                   const float* __restrict__ g_conic, int n, int views,
                   float* __restrict__ g_xyz, float* __restrict__ g_scale,
                   float* __restrict__ g_rot) {
  extern __shared__ float cs_all[];  // views x kConsts
  for (int t = threadIdx.x; t < views * kConsts; t += kThreads)
    cs_all[t] = consts[t];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Row w = load_row(xyz, scale, rot, rot_aligned, i);
  float acc_xyz[3], acc_scale[3], acc_rot[4];
  const int nv = kViews > 0 ? kViews : views;
  for (int view = 0; view < nv; ++view) {
    const size_t o = static_cast<size_t>(view) * n + i;
    const float gm[2] = {g_mean2d[2 * o], g_mean2d[2 * o + 1]};
    const float gcn[3] = {g_conic[3 * o], g_conic[3 * o + 1],
                          g_conic[3 * o + 2]};
    float gx[3], gs[3], gq[4];
    adjoint(cs_all + view * kConsts, w, gm, gcn, gx, gs, gq);
    // the views' gradients summed in view order, as the twin adds them
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      acc_xyz[j] = view == 0 ? gx[j] : add(acc_xyz[j], gx[j]);
      acc_scale[j] = view == 0 ? gs[j] : add(acc_scale[j], gs[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc_rot[j] = view == 0 ? gq[j] : add(acc_rot[j], gq[j]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_xyz[3 * i + j] = acc_xyz[j];
    g_scale[3 * i + j] = acc_scale[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) g_rot[4 * i + j] = acc_rot[j];
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Both launch on `stream` (a cudaStream_t) and do not synchronise. Every
// array is contiguous float32 (visible: bool); consts holds V x 30 floats,
// the forward's outputs and the adjoint's cotangents are (V, N, ...). The
// adjoint keeps all V views' constants in the 48 KB of shared memory a CTA
// gets without opting in, so V <= 409 (the wrapper checks). Each returns
// cudaGetLastError() as an int, 0 on success.
extern "C" int gh_project_forward(const void* xyz, const void* scale,
                                  const void* rot, const void* consts, int n,
                                  int views, void* mean2d, void* depth,
                                  void* conic, void* radius, void* visible,
                                  void* stream) {
  if (n > 0 && views > 0) {
    project_fwd_kernel<<<dim3(blocks_for(n), views), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xyz), static_cast<const float*>(scale),
        static_cast<const float*>(rot), aligned16(rot),
        static_cast<const float*>(consts), n, static_cast<float*>(mean2d),
        static_cast<float*>(depth), static_cast<float*>(conic),
        static_cast<float*>(radius), static_cast<bool*>(visible));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gh_project_backward(const void* xyz, const void* scale,
                                   const void* rot, const void* consts,
                                   const void* g_mean2d, const void* g_conic,
                                   int n, int views, void* g_xyz,
                                   void* g_scale, void* g_rot, void* stream) {
  if (n > 0 && views > 0) {
    const size_t smem = static_cast<size_t>(views) * kConsts * sizeof(float);
    auto kernel = views == 1 ? project_bwd_kernel<1> : project_bwd_kernel<0>;
    kernel<<<blocks_for(n), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xyz), static_cast<const float*>(scale),
        static_cast<const float*>(rot), aligned16(rot),
        static_cast<const float*>(consts),
        static_cast<const float*>(g_mean2d),
        static_cast<const float*>(g_conic), n, views,
        static_cast<float*>(g_xyz), static_cast<float*>(g_scale),
        static_cast<float*>(g_rot));
  }
  return static_cast<int>(cudaGetLastError());
}
