// K11: fused linearization of a blocked global-shutter visual batch with the
// camera calibration estimated (point + pose + cam extr + cam intr active).
//
// Replaces the Pallas kernel _visual_cal_kernel (JAX ops/visual_fused.py:347,
// entry _run_cal :445), which took its 32-column Jacobian from an in-kernel
// jax.linearize + two linear-transpose passes over lane vectors. One thread
// per observation, K1's body with the calibration columns (visual_body.cuh):
// K7 (rs_linearize.cu) without the capture-time shift. J_r keeps the
// 12-column rig layout with columns 6-11 zero; J_cal = [extr 6 | intr 17],
// columns 21-22 (readout, time offset) zero.
//
// Inputs and outputs are float32. Bound: bytes — 52 B of per-observation
// inputs, ~100 B of gathered rows (L2 hits) and 316 B of outputs (res 2,
// valid 1, J 2 x 38 floats) per observation; outputs are written with the
// observation axis last (coalesced).
//
// Design on the card (visual_cal_linearize_mode): one instantiation per
// camera model; float64 for the primal chain and the residual only, the
// chain below A in float32 with the rotations applied as quaternions, the
// intrinsics columns from the projection's own intermediates (no second
// float64 pass through the model), each group stored as soon as it is
// computed (visual_body.cuh). ptxas: 80 registers (Fisheye624) / 70
// (pinhole) against the old kernel's 176. Device time on one H100 80GB HBM3
// at 700 W (chip_smoke.py, in turns with the old kernel): 0.2234 ms against
// 0.4141 at 1.75M observations (bound 0.1925).
//
// visual_cal_linearize_v1, the kernel before that redesign (the camera model
// a runtime argument, the chain in float64 through two 3x3 rotation
// matrices, the intrinsics from param_jac's second pass), is kept as
// chip_smoke.py's yardstick (viba_visual_cal_linearize_v1); nothing else
// reaches it.
#include "visual_body.cuh"

namespace {

using namespace viba;

__global__ void __launch_bounds__(128) visual_cal_linearize_v1(
    int n, int camera_kind, const int* __restrict__ rig, const int* __restrict__ point,
    const int* __restrict__ intr, const int* __restrict__ extr, const int* __restrict__ bias,
    const float* __restrict__ bias_on, const float* __restrict__ obs_uv,
    const float* __restrict__ sqrt_h, const float* __restrict__ pad,
    const float* __restrict__ pose_q, const float* __restrict__ pose_t,
    const float* __restrict__ points, const float* __restrict__ cam_intr,
    const float* __restrict__ extr_q, const float* __restrict__ extr_t,
    const float* __restrict__ det_bias, const float* __restrict__ rig_mask,
    const float* __restrict__ pt_mask, const float* __restrict__ intr_mask,
    const float* __restrict__ extr_mask, float* __restrict__ res, float* __restrict__ valid,
    float* __restrict__ J_pt, float* __restrict__ J_r, float* __restrict__ J_cal) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = rig[i], p = point[i], ci = intr[i], ce = extr[i], cb = bias[i];
  const float* K = cam_intr + (long)ci * kMaxParams;

  real Tq[4], Tt[3], P[3], Eq[4], Et[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    Tq[c] = pose_q[4 * (long)r + c];
    Eq[c] = extr_q[4 * (long)ce + c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Tt[c] = pose_t[3 * (long)r + c];
    Et[c] = extr_t[3 * (long)ce + c];
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
  const real h[2][2] = {{sqrt_h[4 * (long)i], sqrt_h[4 * (long)i + 1]},
                        {sqrt_h[4 * (long)i + 2], sqrt_h[4 * (long)i + 3]}};
  const real bon = bias_on[i];
  const real e0 = u.v - real(obs_uv[2 * (long)i]) + bon * real(det_bias[2 * (long)cb]);
  const real e1 = v.v - real(obs_uv[2 * (long)i + 1]) + bon * real(det_bias[2 * (long)cb + 1]);
  res[i] = float(h[0][0] * e0 + h[0][1] * e1);
  res[n + i] = float(h[1][0] * e0 + h[1][1] * e1);
  valid[i] = fmaxf(pc[2] >= kMinZ ? 1.f : 0.f, pad[i]);

  const real du[3] = {u.d0, u.d1, u.d2}, dv[3] = {v.d0, v.d1, v.d2};
  real RE[3][3], RT[3][3];
  rot_matrix(Eq, RE);
  rot_matrix(Tq, RT);
  real dup[15], dvp[15];
  param_jac(camera_kind, K, pc[0], pc[1], pc[2], dup, dvp);

  // masks: all four or none
  const bool masked = pt_mask != nullptr;
  const float* pm = masked ? pt_mask + 3 * (long)p : nullptr;
  const float* rm = masked ? rig_mask + 12 * (long)r : nullptr;
  const float* em = masked ? extr_mask + 6 * (long)ce : nullptr;
  const float* im = masked ? intr_mask + kMaxParams * (long)ci : nullptr;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    real A[3], Ar[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) A[c] = h[a][0] * du[c] + h[a][1] * dv[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) Ar[c] = A[0] * RE[0][c] + A[1] * RE[1][c] + A[2] * RE[2][c];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const real jp = Ar[0] * RT[0][c] + Ar[1] * RT[1][c] + Ar[2] * RT[2][c];
      const real jw = pr[(c + 1) % 3] * Ar[(c + 2) % 3] - pr[(c + 2) % 3] * Ar[(c + 1) % 3];
      const real je = pc[(c + 1) % 3] * A[(c + 2) % 3] - pc[(c + 2) % 3] * A[(c + 1) % 3];
      J_pt[(a * 3 + c) * (long)n + i] = float(jp * (pm ? pm[c] : 1.f));
      J_r[(a * 12 + c) * (long)n + i] = float(Ar[c] * (rm ? rm[c] : 1.f));
      J_r[(a * 12 + 3 + c) * (long)n + i] = float(jw * (rm ? rm[3 + c] : 1.f));
      J_r[(a * 12 + 6 + c) * (long)n + i] = 0.f;
      J_r[(a * 12 + 9 + c) * (long)n + i] = 0.f;
      J_cal[(a * 23 + c) * (long)n + i] = float(A[c] * (em ? em[c] : 1.f));
      J_cal[(a * 23 + 3 + c) * (long)n + i] = float(je * (em ? em[3 + c] : 1.f));
    }
#pragma unroll
    for (int c = 0; c < 15; ++c)
      J_cal[(a * 23 + 6 + c) * (long)n + i] =
          float((h[a][0] * dup[c] + h[a][1] * dvp[c]) * (im ? im[c] : 1.f));
    J_cal[(a * 23 + 21) * (long)n + i] = 0.f;
    J_cal[(a * 23 + 22) * (long)n + i] = 0.f;
  }
}

// 128 threads a block and no minimum of blocks an SM, as K7
template <int CAM>
__global__ void __launch_bounds__(128) visual_cal_linearize_mode(VisArgs a) {
  visual_body<CAM, true, true>(a);
}

}  // namespace

extern "C" int viba_visual_cal_linearize(
    int n, int camera_kind, const int* rig, const int* point, const int* intr, const int* extr,
    const int* bias, const float* bias_on, const float* obs_uv, const float* sqrt_h,
    const float* pad, const float* pose_q, const float* pose_t, const float* points,
    const float* cam_intr, const float* extr_q, const float* extr_t, const float* det_bias,
    const float* rig_mask, const float* pt_mask, const float* intr_mask, const float* extr_mask,
    float* res, float* valid, float* J_pt, float* J_r, float* J_cal, void* stream) {
  if (n <= 0) return 0;
  const VisArgs a{n, rig, point, intr, extr, bias, bias_on, obs_uv, sqrt_h, pad, pose_q,
                  pose_t, points, cam_intr, extr_q, extr_t, det_bias, rig_mask, pt_mask,
                  intr_mask, extr_mask, res, valid, J_pt, J_r, J_cal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n + 127) / 128;
  if (camera_kind == 1) {
    visual_cal_linearize_mode<1><<<grid, 128, 0, st>>>(a);
  } else {
    visual_cal_linearize_mode<0><<<grid, 128, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_visual_cal_linearize_v1(
    int n, int camera_kind, const int* rig, const int* point, const int* intr, const int* extr,
    const int* bias, const float* bias_on, const float* obs_uv, const float* sqrt_h,
    const float* pad, const float* pose_q, const float* pose_t, const float* points,
    const float* cam_intr, const float* extr_q, const float* extr_t, const float* det_bias,
    const float* rig_mask, const float* pt_mask, const float* intr_mask, const float* extr_mask,
    float* res, float* valid, float* J_pt, float* J_r, float* J_cal, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  visual_cal_linearize_v1<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n, camera_kind, rig, point, intr, extr, bias, bias_on, obs_uv, sqrt_h, pad, pose_q, pose_t,
      points, cam_intr, extr_q, extr_t, det_bias, rig_mask, pt_mask, intr_mask, extr_mask, res,
      valid, J_pt, J_r, J_cal);
  return static_cast<int>(cudaGetLastError());
}
