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
#include "camera.cuh"

namespace {

using namespace viba;

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
