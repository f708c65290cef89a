// K1: fused linearization of a blocked plain-visual batch.
//
// Replaces the Pallas kernel _visual_kernel (JAX ops/visual_fused.py:139,
// entry _run :237). One thread per observation: gather pose/point/camera
// rows by index, p_rig = R(T) p + t(T), p_cam = R(E) p_rig + t(E), project,
// whiten, and (with_jac) the analytic Jacobians
//   J_pt = sqrt_h D R(E) R(T),  J_pose = sqrt_h D R(E) [I | -hat(p_rig)],
// where D = d uv / d p_cam comes from three forward tangents carried
// through the camera model in a small dual type (the Pallas kernel used
// jax.linearize; the library atan2 replaces its Mosaic atan2 workaround).
// The camera model mirrors ops/camera/fisheye624.py and pinhole.py exactly,
// including the optical-axis and z guards.
//
// Inputs and outputs are float32; the arithmetic in registers is float64.
// In float32, composing world-scale pose and point coordinates and
// projecting to ~1000 px loses ~1e-4 px, which at the headline's size
// exceeds the 1e-5 residual bound against the exact residual of the same
// float32 inputs. Bound: bytes (~0.24 KB per observation moved, tables
// L2-resident), so the float64 arithmetic stays off the critical path;
// outputs are written with the observation axis last, so every column store
// is coalesced.
#include "tile_reduce.cuh"

namespace {

using real = double;

constexpr real kMinZ = 1e-6;
constexpr int kMaxParams = 17;

struct Dual {
  real v, d0, d1, d2;
};

__device__ __forceinline__ Dual dvar(real v, int axis) {
  return {v, axis == 0 ? 1.0 : 0.0, axis == 1 ? 1.0 : 0.0, axis == 2 ? 1.0 : 0.0};
}
__device__ __forceinline__ Dual dconst(real v) { return {v, 0.0, 0.0, 0.0}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.d0 + b.d0, a.d1 + b.d1, a.d2 + b.d2};
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d0 * b.v + a.v * b.d0, a.d1 * b.v + a.v * b.d1, a.d2 * b.v + a.v * b.d2};
}
__device__ __forceinline__ Dual operator*(real s, Dual a) {
  return {s * a.v, s * a.d0, s * a.d1, s * a.d2};
}
__device__ __forceinline__ Dual operator+(Dual a, real s) { return {a.v + s, a.d0, a.d1, a.d2}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const real q = a.v / b.v;
  const real ib = 1.0 / b.v;
  return {q, (a.d0 - q * b.d0) * ib, (a.d1 - q * b.d1) * ib, (a.d2 - q * b.d2) * ib};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const real s = sqrt(a.v);
  const real k = 0.5 / s;
  return {s, k * a.d0, k * a.d1, k * a.d2};
}
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  const real den = 1.0 / (x.v * x.v + y.v * y.v);
  return {atan2(y.v, x.v), (x.v * y.d0 - y.v * x.d0) * den, (x.v * y.d1 - y.v * x.d1) * den,
          (x.v * y.d2 - y.v * x.d2) * den};
}
__device__ __forceinline__ Dual dsel(bool c, Dual a, Dual b) { return c ? a : b; }

// ops/camera/fisheye624.py project, on duals
__device__ __forceinline__ void proj_fisheye624(const float* K, Dual x, Dual y, Dual z, Dual& u,
                                                Dual& v) {
  const Dual r = dsqrt(x * x + y * y + 1e-30);
  const Dual theta = datan2(r, z);
  const Dual theta2 = theta * theta;
  Dual m = dconst(1.0), acc = dconst(1.0);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc = acc * theta2;
    m = m + real(K[3 + i]) * acc;
  }
  const bool near = r.v < 1e-12;
  const Dual r_safe = dsel(near, dconst(1.0), r);
  const Dual z_safe = dsel(fabs(z.v) < kMinZ, dconst(kMinZ), z);
  const Dual scale = dsel(near, dconst(1.0) / z_safe, theta * m / r_safe);
  const Dual a = x * scale, b = y * scale;
  const Dual rho2 = a * a + b * b;
  const Dual ab = a * b;
  const real p0 = K[9], p1 = K[10], s0 = K[11], s1 = K[12], s2 = K[13], s3 = K[14];
  const Dual tx = p0 * (rho2 + 2.0 * (a * a)) + 2.0 * p1 * ab;
  const Dual ty = p1 * (rho2 + 2.0 * (b * b)) + 2.0 * p0 * ab;
  const Dual tpx = s0 * rho2 + s1 * (rho2 * rho2);
  const Dual tpy = s2 * rho2 + s3 * (rho2 * rho2);
  u = real(K[0]) * (a + tx + tpx) + real(K[1]);
  v = real(K[0]) * (b + ty + tpy) + real(K[2]);
}

// ops/camera/pinhole.py project, on duals
__device__ __forceinline__ void proj_pinhole(const float* K, Dual x, Dual y, Dual z, Dual& u,
                                             Dual& v) {
  const Dual z_safe = dsel(fabs(z.v) < kMinZ, dconst(kMinZ), z);
  u = real(K[0]) * (x / z_safe) + real(K[2]);
  v = real(K[1]) * (y / z_safe) + real(K[3]);
}

// lie.quat_rotate: v + 2 (w (q x v) + q x (q x v))
__device__ __forceinline__ void qrot(const real* q, const real* v, real* out) {
  const real ux = q[2] * v[2] - q[3] * v[1];
  const real uy = q[3] * v[0] - q[1] * v[2];
  const real uz = q[1] * v[1] - q[2] * v[0];
  const real uux = q[2] * uz - q[3] * uy;
  const real uuy = q[3] * ux - q[1] * uz;
  const real uuz = q[1] * uy - q[2] * ux;
  out[0] = v[0] + 2.0 * (q[0] * ux + uux);
  out[1] = v[1] + 2.0 * (q[0] * uy + uuy);
  out[2] = v[2] + 2.0 * (q[0] * uz + uuz);
}

// R[i][j] = (R e_j)_i
__device__ __forceinline__ void rot_matrix(const real* q, real (&R)[3][3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const real e[3] = {j == 0 ? 1.0 : 0.0, j == 1 ? 1.0 : 0.0, j == 2 ? 1.0 : 0.0};
    real c[3];
    qrot(q, e, c);
    R[0][j] = c[0];
    R[1][j] = c[1];
    R[2][j] = c[2];
  }
}

__global__ void __launch_bounds__(256) visual_linearize(
    int n, int camera_kind, int with_jac, const int* __restrict__ rig,
    const int* __restrict__ point, const int* __restrict__ intr, const int* __restrict__ extr,
    const int* __restrict__ bias, const float* __restrict__ bias_on,
    const float* __restrict__ obs_uv, const float* __restrict__ sqrt_h,
    const float* __restrict__ pad, const float* __restrict__ pose_q,
    const float* __restrict__ pose_t, const float* __restrict__ rig_mask,
    const float* __restrict__ points, const float* __restrict__ pt_mask,
    const float* __restrict__ cam_intr, const float* __restrict__ extr_q,
    const float* __restrict__ extr_t, const float* __restrict__ det_bias, float* __restrict__ res,
    float* __restrict__ valid, float* __restrict__ J_pt, float* __restrict__ J_r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = rig[i], p = point[i], ce = extr[i], cb = bias[i];
  const float* K = cam_intr + (long)intr[i] * kMaxParams;

  real Tq[4], Tt[3], P[3], Eq[4], Et[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    Tq[c] = pose_q[4 * r + c];
    Eq[c] = extr_q[4 * ce + c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Tt[c] = pose_t[3 * r + c];
    Et[c] = extr_t[3 * ce + c];
    P[c] = points[3 * (long)p + c];
  }
  real pr[3], pc[3];
  qrot(Tq, P, pr);
#pragma unroll
  for (int c = 0; c < 3; ++c) pr[c] += Tt[c];
  qrot(Eq, pr, pc);
#pragma unroll
  for (int c = 0; c < 3; ++c) pc[c] += Et[c];

  Dual u, v;
  const Dual x = dvar(pc[0], 0), y = dvar(pc[1], 1), z = dvar(pc[2], 2);
  if (camera_kind == 1) {
    proj_fisheye624(K, x, y, z, u, v);
  } else {
    proj_pinhole(K, x, y, z, u, v);
  }

  const real h00 = sqrt_h[4 * (long)i], h01 = sqrt_h[4 * (long)i + 1];
  const real h10 = sqrt_h[4 * (long)i + 2], h11 = sqrt_h[4 * (long)i + 3];
  const real bon = bias_on[i];
  const real e0 = u.v - real(obs_uv[2 * (long)i]) + bon * real(det_bias[2 * cb]);
  const real e1 = v.v - real(obs_uv[2 * (long)i + 1]) + bon * real(det_bias[2 * cb + 1]);
  res[i] = float(h00 * e0 + h01 * e1);
  res[n + i] = float(h10 * e0 + h11 * e1);
  valid[i] = fmaxf(pc[2] >= kMinZ ? 1.f : 0.f, pad[i]);
  if (!with_jac) return;

  const real du[3] = {u.d0, u.d1, u.d2}, dv[3] = {v.d0, v.d1, v.d2};
  real RE[3][3], RT[3][3], A3[2][3];
  rot_matrix(Eq, RE);
  rot_matrix(Tq, RT);
  const real H[2][2] = {{h00, h01}, {h10, h11}};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    real A2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) A2[c] = H[rr][0] * du[c] + H[rr][1] * dv[c];
#pragma unroll
    for (int j = 0; j < 3; ++j) A3[rr][j] = A2[0] * RE[0][j] + A2[1] * RE[1][j] + A2[2] * RE[2][j];
  }
  float pm[3] = {1.f, 1.f, 1.f}, rm[6] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  if (pt_mask != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) pm[c] = pt_mask[3 * (long)p + c];
  }
  if (rig_mask != nullptr) {
#pragma unroll
    for (int c = 0; c < 6; ++c) rm[c] = rig_mask[12 * r + c];
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const real jp = A3[rr][0] * RT[0][j] + A3[rr][1] * RT[1][j] + A3[rr][2] * RT[2][j];
      J_pt[(rr * 3 + j) * (long)n + i] = float(jp) * pm[j];
      J_r[(rr * 12 + j) * (long)n + i] = float(A3[rr][j]) * rm[j];
      const real rot = pr[(j + 1) % 3] * A3[rr][(j + 2) % 3] - pr[(j + 2) % 3] * A3[rr][(j + 1) % 3];
      J_r[(rr * 12 + 3 + j) * (long)n + i] = float(rot) * rm[3 + j];
    }
#pragma unroll
    for (int c = 6; c < 12; ++c) J_r[(rr * 12 + c) * (long)n + i] = 0.f;
  }
}

}  // namespace

extern "C" int viba_visual_linearize(
    int n, int camera_kind, int with_jac, const int* rig, const int* point, const int* intr,
    const int* extr, const int* bias, const float* bias_on, const float* obs_uv,
    const float* sqrt_h, const float* pad, const float* pose_q, const float* pose_t,
    const float* rig_mask, const float* points, const float* pt_mask, const float* cam_intr,
    const float* extr_q, const float* extr_t, const float* det_bias, float* res, float* valid,
    float* J_pt, float* J_r, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  visual_linearize<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      n, camera_kind, with_jac, rig, point, intr, extr, bias, bias_on, obs_uv, sqrt_h, pad,
      pose_q, pose_t, rig_mask, points, pt_mask, cam_intr, extr_q, extr_t, det_bias, res, valid,
      J_pt, J_r);
  return static_cast<int>(cudaGetLastError());
}
