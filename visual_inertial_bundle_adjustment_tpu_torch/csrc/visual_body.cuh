// The per-observation body shared by K1 (visual_linearize.cu) and K11
// (visual_cal_linearize.cu), one thread per observation:
//   p_rig = R(T) p + t(T);  p_cam = R(E) p_rig + t(E)
//   res   = sqrt_h (proj(intr, p_cam) - obs + bias_on * bias)
//   valid = max(z_cam >= 1e-6, pad)
// and the chain rule written out (left boxplus on T and on E):
//   A      = sqrt_h d uv / d p_cam           three forward tangents, camera.cuh
//   A_r    = R(E)^T A
//   J_pt   = R(T)^T A_r
//   J_pose = [A_r | p_rig x A_r]             (= A_r [I | -hat(p_rig)])
//   J_extr = [A | p_cam x A]                 (= A [I | -hat(p_cam)])   K11
//   J_intr = sqrt_h d uv / d params, 15 model columns; the readout and
//            time-offset columns 15, 16 of a global-shutter camera are zero
// each column times the mask of its variable row. J_r keeps the 12-column rig
// layout with columns 6-11 zero; J_cal = [extr 6 | intr 17].
//
// Float64 where accuracy needs it and nowhere else. The pose composition
// (in the factor's order, so the float32 table quaternions' ~1e-7 departure
// from unit norm enters both alike), the projection on duals, the residual
// and valid run in float64 registers from the float32 inputs: composing
// world-scale poses and points and projecting to ~1000 px in float32 loses
// ~1e-4 px, beyond the 1e-5 residual bound (K1 in float32 measured 4.3e-5).
// The chain below A runs in float32 from float32 copies of q_E, q_T, p_rig
// and p_cam taken before the projection, so the float64 primal state dies
// there; rotations are applied as quaternions (R^T as the conjugate), and the
// intrinsics columns come from the projection's own intermediates
// (intr_jac_col) instead of a second pass through the camera model. Each
// group is stored as soon as it is computed: J_pt, J_r, J_cal's extrinsics,
// then the intrinsics column by column.
#pragma once

#include "camera.cuh"

namespace viba {

struct VisArgs {
  int n;
  const int *rig, *point, *intr, *extr, *bias;
  const float *bias_on, *obs_uv, *sqrt_h, *pad, *pose_q, *pose_t, *points, *cam_intr, *extr_q,
      *extr_t, *det_bias;
  const float *rig_mask, *pt_mask, *intr_mask, *extr_mask;  // each may be null: no masking
  float *res, *valid, *J_pt, *J_r, *J_cal;
};

__device__ __forceinline__ float mask_at(const float* m, long k) { return m ? m[k] : 1.f; }

// One mode: CAM 1 Fisheye624, else pinhole; JAC the Jacobian; CAL K11's
// calibration columns (J_cal)
template <int CAM, bool JAC, bool CAL>
__device__ __forceinline__ void visual_body(const VisArgs& a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int r = a.rig[i], p = a.point[i], ci = a.intr[i], ce = a.extr[i], cb = a.bias[i];
  const float* K = a.cam_intr + (long)ci * kMaxParams;

  real Tq[4], Tt[3], P[3], Eq[4], Et[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    Tq[c] = a.pose_q[4 * (long)r + c];
    Eq[c] = a.extr_q[4 * (long)ce + c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Tt[c] = a.pose_t[3 * (long)r + c];
    Et[c] = a.extr_t[3 * (long)ce + c];
    P[c] = a.points[3 * (long)p + c];
  }
  real pr[3], pc[3];
  qrot(Tq, P, pr);
#pragma unroll
  for (int c = 0; c < 3; ++c) pr[c] += Tt[c];
  qrot(Eq, pr, pc);
#pragma unroll
  for (int c = 0; c < 3; ++c) pc[c] += Et[c];

  // the Jacobian chain's float32 inputs
  float qE[4], qT[4], prf[3], pcf[3];
  if constexpr (JAC) {
    quat_f(Eq, true, qE);  // R(E)^T
    quat_f(Tq, true, qT);  // R(T)^T
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      prf[c] = float(pr[c]);
      pcf[c] = float(pc[c]);
    }
  }
  Dual u, v;
  ProjTerms terms;
  const Dual x = dvar(pc[0], 0), y = dvar(pc[1], 1), z = dvar(pc[2], 2);
  if constexpr (CAM == 1) {
    proj_fisheye624(K, x, y, z, u, v, CAL ? &terms : nullptr);
  } else {
    proj_pinhole(K, x, y, z, u, v, CAL ? &terms : nullptr);
  }

  const real h[2][2] = {{a.sqrt_h[4 * (long)i], a.sqrt_h[4 * (long)i + 1]},
                        {a.sqrt_h[4 * (long)i + 2], a.sqrt_h[4 * (long)i + 3]}};
  const real bon = a.bias_on[i];
  const real e0 = u.v - real(a.obs_uv[2 * (long)i]) + bon * real(a.det_bias[2 * (long)cb]);
  const real e1 =
      v.v - real(a.obs_uv[2 * (long)i + 1]) + bon * real(a.det_bias[2 * (long)cb + 1]);
  a.res[i] = float(h[0][0] * e0 + h[0][1] * e1);
  a.res[a.n + i] = float(h[1][0] * e0 + h[1][1] * e1);
  a.valid[i] = fmaxf(pc[2] >= kMinZ ? 1.f : 0.f, a.pad[i]);
  if constexpr (JAC) {
    const long n = a.n;
    float A[2][3];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      A[row][0] = float(h[row][0] * u.d0 + h[row][1] * v.d0);
      A[row][1] = float(h[row][0] * u.d1 + h[row][1] * v.d1);
      A[row][2] = float(h[row][0] * u.d2 + h[row][1] * v.d2);
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      float Ar[3], Jp[3], jw[3];
      qrot_f(qE, A[row], Ar);
      qrot_f(qT, Ar, Jp);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        a.J_pt[(row * 3 + c) * n + i] = Jp[c] * mask_at(a.pt_mask, 3L * p + c);
      cross_f(prf, Ar, jw);
      float* Jr = a.J_r + row * 12 * n + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Jr[c * n] = Ar[c] * mask_at(a.rig_mask, 12L * r + c);
        Jr[(3 + c) * n] = jw[c] * mask_at(a.rig_mask, 12L * r + 3 + c);
        Jr[(6 + c) * n] = 0.f;
        Jr[(9 + c) * n] = 0.f;
      }
      if constexpr (CAL) {
        float je[3];
        cross_f(pcf, A[row], je);
        float* Jc = a.J_cal + row * 23 * n + i;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          Jc[c * n] = A[row][c] * mask_at(a.extr_mask, 6L * ce + c);
          Jc[(3 + c) * n] = je[c] * mask_at(a.extr_mask, 6L * ce + 3 + c);
        }
      }
    }
    if constexpr (CAL) {
      const float hf[2][2] = {{float(h[0][0]), float(h[0][1])}, {float(h[1][0]), float(h[1][1])}};
      float Kf[15];  // in registers before the stores, which could alias cam_intr
#pragma unroll
      for (int c = 0; c < 15; ++c) Kf[c] = K[c];
      float* Jc = a.J_cal + 6 * n + i;
#pragma unroll
      for (int c = 0; c < 15; ++c) {
        float du, dv;
        intr_jac_col<CAM>(Kf, terms, pcf[0], pcf[1], c, du, dv);
        const float m = mask_at(a.intr_mask, kMaxParams * (long)ci + c);
        Jc[c * n] = (hf[0][0] * du + hf[0][1] * dv) * m;
        Jc[(23 + c) * n] = (hf[1][0] * du + hf[1][1] * dv) * m;
      }
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        Jc[(row * 23 + 15) * n] = 0.f;
        Jc[(row * 23 + 16) * n] = 0.f;
      }
    }
  }
}

}  // namespace viba
