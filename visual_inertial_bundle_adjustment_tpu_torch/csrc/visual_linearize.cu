// K1: fused linearization of a blocked plain-visual batch.
//
// Replaces the Pallas kernel _visual_kernel (JAX ops/visual_fused.py:139,
// entry _run :237). One thread per observation (visual_body.cuh, shared with
// K11): gather pose/point/camera rows by index, p_rig = R(T) p + t(T),
// p_cam = R(E) p_rig + t(E), project, whiten, and (with the Jacobian)
//   J_pt = sqrt_h D R(E) R(T),  J_pose = sqrt_h D R(E) [I | -hat(p_rig)],
// where D = d uv / d p_cam comes from three forward tangents carried
// through the camera model in a small dual type (the Pallas kernel used
// jax.linearize; the library atan2 replaces its Mosaic atan2 workaround).
//
// Inputs and outputs are float32. Bound: bytes — per observation 52 B of
// inputs and 132 B of outputs with the Jacobian (res, valid, J_pt, J_r),
// 12 B residual-only, the gathered table rows L2 hits; outputs are written
// with the observation axis last, so every column store is coalesced.
//
// Design on the card (visual_linearize_mode): one instantiation per mode,
// <camera model, Jacobian>. The residual-only pass, the cost of every path,
// compiles no Jacobian chain: the projection's tangents are dead code there,
// and it reads no masks. The Jacobian pass keeps float64 for the primal chain
// and the residual, and runs the chain below A in float32 with the rotations
// applied as quaternions (visual_body.cuh). ptxas: 40 registers residual-only,
// 72 (Fisheye624) / 62 (pinhole) with the Jacobian, against the old kernel's
// 90. Device time on one H100 80GB HBM3 at 700 W (chip_smoke.py, in turns
// with the old kernel): residual-only 0.0475 ms against 0.0913 at 1.75M
// observations (bound 0.0336), with the Jacobian 0.2304 against 0.2540 at
// 3.1M (bound 0.1704).
//
// visual_linearize_v1, the kernel before that redesign (one kernel for all
// modes, the camera model and the Jacobian runtime arguments, the Jacobian
// chain in float64 through two 3x3 rotation matrices), is kept as
// chip_smoke.py's yardstick (viba_visual_linearize_v1); nothing else reaches
// it.
#include "visual_body.cuh"

namespace {

using namespace viba;

__global__ void __launch_bounds__(256) visual_linearize_v1(
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

// 128 threads a block and no minimum of blocks an SM, as K7
template <int CAM, bool JAC>
__global__ void __launch_bounds__(128) visual_linearize_mode(VisArgs a) {
  visual_body<CAM, JAC, false>(a);
}

template <int CAM, bool JAC>
cudaError_t launch_visual(const VisArgs& a, cudaStream_t st) {
  visual_linearize_mode<CAM, JAC><<<(a.n + 127) / 128, 128, 0, st>>>(a);
  return cudaGetLastError();
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
  const VisArgs a{n, rig, point, intr, extr, bias, bias_on, obs_uv, sqrt_h, pad, pose_q,
                  pose_t, points, cam_intr, extr_q, extr_t, det_bias, rig_mask, pt_mask,
                  nullptr, nullptr, res, valid, J_pt, J_r, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (camera_kind == 1) {
    err = with_jac ? launch_visual<1, true>(a, st) : launch_visual<1, false>(a, st);
  } else {
    err = with_jac ? launch_visual<0, true>(a, st) : launch_visual<0, false>(a, st);
  }
  return static_cast<int>(err);
}

extern "C" int viba_visual_linearize_v1(
    int n, int camera_kind, int with_jac, const int* rig, const int* point, const int* intr,
    const int* extr, const int* bias, const float* bias_on, const float* obs_uv,
    const float* sqrt_h, const float* pad, const float* pose_q, const float* pose_t,
    const float* rig_mask, const float* points, const float* pt_mask, const float* cam_intr,
    const float* extr_q, const float* extr_t, const float* det_bias, float* res, float* valid,
    float* J_pt, float* J_r, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  visual_linearize_v1<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      n, camera_kind, with_jac, rig, point, intr, extr, bias, bias_on, obs_uv, sqrt_h, pad,
      pose_q, pose_t, rig_mask, points, pt_mask, cam_intr, extr_q, extr_t, det_bias, res, valid,
      J_pt, J_r);
  return static_cast<int>(cudaGetLastError());
}
