// Float64 camera-model and quaternion helpers shared by the visual
// linearization kernels (visual_linearize.cu, K1; rs_linearize.cu, K7;
// visual_cal_linearize.cu, K11).
// The camera models mirror ops/camera/fisheye624.py and pinhole.py exactly,
// including the optical-axis and z guards; derivatives wrt the camera-frame
// point come from three forward tangents carried in a small dual type, those
// wrt the model parameters are written out (param_jac).
#pragma once

#include <cuda_runtime.h>

namespace viba {

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

// d(u, v) / d(model params 0..14) at p_cam (primal), ops/camera models
__device__ inline void param_jac(int camera_kind, const float* K, real x, real y, real z,
                                 real (&du)[15], real (&dv)[15]) {
#pragma unroll
  for (int j = 0; j < 15; ++j) du[j] = dv[j] = 0.0;
  const real zs = fabs(z) < kMinZ ? kMinZ : z;
  if (camera_kind != 1) {  // pinhole [fx, fy, cx, cy]
    du[0] = x / zs;
    dv[1] = y / zs;
    du[2] = 1.0;
    dv[3] = 1.0;
    return;
  }
  const real r = sqrt(x * x + y * y + 1e-30);
  const real theta = atan2(r, z);
  const real th2 = theta * theta;
  real pw[6], m = 1.0, acc = 1.0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc *= th2;
    pw[i] = acc;
    m += real(K[3 + i]) * acc;
  }
  const bool near = r < 1e-12;
  const real scale = near ? 1.0 / zs : theta * m / r;
  const real a = x * scale, b = y * scale;
  const real rho2 = a * a + b * b;
  const real f = K[0], p0 = K[9], p1 = K[10], s0 = K[11], s1 = K[12], s2 = K[13], s3 = K[14];
  const real ua = f * (1.0 + 6.0 * p0 * a + 2.0 * p1 * b + 2.0 * a * (s0 + 2.0 * s1 * rho2));
  const real ub = f * (2.0 * p0 * b + 2.0 * p1 * a + 2.0 * b * (s0 + 2.0 * s1 * rho2));
  const real va = f * (2.0 * p1 * a + 2.0 * p0 * b + 2.0 * a * (s2 + 2.0 * s3 * rho2));
  const real vb = f * (1.0 + 6.0 * p1 * b + 2.0 * p0 * a + 2.0 * b * (s2 + 2.0 * s3 * rho2));
  du[0] = a + p0 * (rho2 + 2.0 * a * a) + 2.0 * p1 * a * b + s0 * rho2 + s1 * rho2 * rho2;
  dv[0] = b + p1 * (rho2 + 2.0 * b * b) + 2.0 * p0 * a * b + s2 * rho2 + s3 * rho2 * rho2;
  du[1] = 1.0;
  dv[2] = 1.0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const real ds = near ? 0.0 : theta * pw[i] / r;
    du[3 + i] = ua * x * ds + ub * y * ds;
    dv[3 + i] = va * x * ds + vb * y * ds;
  }
  du[9] = f * (rho2 + 2.0 * a * a);
  dv[9] = f * 2.0 * a * b;
  du[10] = f * 2.0 * a * b;
  dv[10] = f * (rho2 + 2.0 * b * b);
  du[11] = f * rho2;
  du[12] = f * rho2 * rho2;
  dv[13] = f * rho2;
  dv[14] = f * rho2 * rho2;
}

}  // namespace viba
