// Camera-model and quaternion helpers shared by the visual linearization
// kernels (visual_linearize.cu, K1; rs_linearize.cu, K7;
// visual_cal_linearize.cu, K11): the float64 projections and rotations of
// their primal chains, and the float32 helpers of their Jacobian chains.
// The camera models mirror ops/camera/fisheye624.py and pinhole.py exactly,
// including the optical-axis and z guards; derivatives wrt the camera-frame
// point come from three forward tangents carried in a small dual type, those
// wrt the model parameters are written out: in float64 from p_cam
// (param_jac, K7) or in float32 from the projection's own intermediates
// (ProjTerms, intr_jac_col: K11).
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

// What the intrinsics Jacobian reads of a projection, in float32.
// Fisheye624: (a, b) the radially distorted plane point, rho2 = a^2 + b^2,
// th2 = theta^2 and tr = theta / r (0 on the optical axis, r < 1e-12);
// pinhole: (a, b) = (x, y) / z_safe.
struct ProjTerms {
  float a, b, rho2, th2, tr;
};

// ops/camera/fisheye624.py project, on duals; `terms`, when given, receives
// the projection's intermediates
__device__ __forceinline__ void proj_fisheye624(const float* K, Dual x, Dual y, Dual z, Dual& u,
                                                Dual& v, ProjTerms* terms = nullptr) {
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
  if (terms != nullptr) {
    *terms = {float(a.v), float(b.v), float(rho2.v), float(theta2.v),
              near ? 0.f : float(theta.v) / float(r.v)};
  }
}

// ops/camera/pinhole.py project, on duals
__device__ __forceinline__ void proj_pinhole(const float* K, Dual x, Dual y, Dual z, Dual& u,
                                             Dual& v, ProjTerms* terms = nullptr) {
  const Dual z_safe = dsel(fabs(z.v) < kMinZ, dconst(kMinZ), z);
  u = real(K[0]) * (x / z_safe) + real(K[2]);
  v = real(K[1]) * (y / z_safe) + real(K[3]);
  if (terms != nullptr) *terms = {float(x.v / z_safe.v), float(y.v / z_safe.v), 0.f, 0.f, 0.f};
}

// d(u, v) / d(model param c), c in [0, 15), of camera model CAM (1
// Fisheye624, else pinhole [fx, fy, cx, cy]) at the camera-frame point
// (x, y, .), from the projection's intermediates, in float32: param_jac's
// columns without a second pass through the model. The guards come with the
// intermediates: tr is 0 on the optical axis, (a, b) carry z_safe.
template <int CAM>
__device__ __forceinline__ void intr_jac_col(const float* K, const ProjTerms& t, float x, float y,
                                             int c, float& du, float& dv) {
  du = dv = 0.f;
  if constexpr (CAM != 1) {
    if (c == 0) du = t.a;
    if (c == 1) dv = t.b;
    if (c == 2) du = 1.f;
    if (c == 3) dv = 1.f;
    return;
  }
  const float f = K[0], p0 = K[9], p1 = K[10], s0 = K[11], s1 = K[12], s2 = K[13], s3 = K[14];
  const float a = t.a, b = t.b, rho2 = t.rho2;
  if (c == 0) {
    du = a + p0 * (rho2 + 2.f * a * a) + 2.f * p1 * a * b + s0 * rho2 + s1 * rho2 * rho2;
    dv = b + p1 * (rho2 + 2.f * b * b) + 2.f * p0 * a * b + s2 * rho2 + s3 * rho2 * rho2;
  } else if (c == 1) {
    du = 1.f;
  } else if (c == 2) {
    dv = 1.f;
  } else if (c < 9) {  // k0..k5: d(a, b) / dk = (x, y) theta th2^(c-2) / r
    float ds = t.tr;
    for (int e = 3; e <= c; ++e) ds *= t.th2;
    const float sx = x * ds, sy = y * ds;
    const float ua = f * (1.f + 6.f * p0 * a + 2.f * p1 * b + 2.f * a * (s0 + 2.f * s1 * rho2));
    const float ub = f * (2.f * p0 * b + 2.f * p1 * a + 2.f * b * (s0 + 2.f * s1 * rho2));
    const float va = f * (2.f * p1 * a + 2.f * p0 * b + 2.f * a * (s2 + 2.f * s3 * rho2));
    const float vb = f * (1.f + 6.f * p1 * b + 2.f * p0 * a + 2.f * b * (s2 + 2.f * s3 * rho2));
    du = ua * sx + ub * sy;
    dv = va * sx + vb * sy;
  } else if (c == 9) {
    du = f * (rho2 + 2.f * a * a);
    dv = f * 2.f * a * b;
  } else if (c == 10) {
    du = f * 2.f * a * b;
    dv = f * (rho2 + 2.f * b * b);
  } else if (c == 11) {
    du = f * rho2;
  } else if (c == 12) {
    du = f * rho2 * rho2;
  } else if (c == 13) {
    dv = f * rho2;
  } else {
    dv = f * rho2 * rho2;
  }
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

// float32 helpers of the Jacobian chains below A = sqrt_h d uv / d p_cam
// (K1, K7, K11): a rotation by a quaternion, a cross product, and a float64
// quaternion or its conjugate (R^T: the rotation formula's transpose is
// exactly its conjugate's, unit or not) as float32
__device__ __forceinline__ void qrot_f(const float* q, const float* v, float* out) {
  const float ux = q[2] * v[2] - q[3] * v[1];
  const float uy = q[3] * v[0] - q[1] * v[2];
  const float uz = q[1] * v[1] - q[2] * v[0];
  const float uux = q[2] * uz - q[3] * uy;
  const float uuy = q[3] * ux - q[1] * uz;
  const float uuz = q[1] * uy - q[2] * ux;
  out[0] = v[0] + 2.f * (q[0] * ux + uux);
  out[1] = v[1] + 2.f * (q[0] * uy + uuy);
  out[2] = v[2] + 2.f * (q[0] * uz + uuz);
}

__device__ __forceinline__ void cross_f(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void quat_f(const real* q, bool conj, float* out) {
  out[0] = float(q[0]);
#pragma unroll
  for (int c = 1; c < 4; ++c) out[c] = float(conj ? -q[c] : q[c]);
}

}  // namespace viba
