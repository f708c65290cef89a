// K7: fused linearization of a blocked rolling-shutter visual batch.
//
// Replaces the Pallas kernel _rs_kernel (JAX ops/rs_fused.py:131, entry
// _run_rs :361). One thread per observation:
//   dtt   = intr[15] tpf - intr[16]        capture time rel. the frame midpoint
//   seg   = upper_bound(dt row of the rig's RS table, dtt) - 1, chosen at the
//           primal readout / time offset and constant under differentiation;
//           valid only inside the table (RollingShutterData.cpp:70-113)
//   dtl   = dtt - dt[seg];  om = ig dtl;  up = ia dtl   (constant signal)
//   q_t   = q[seg] exp(om);  dP_t = dP[seg] + dV[seg] dtl + R(q[seg]) dP_loc
//   p_mid = dP_t + R(T) vel dtt + R(T) g dtt^2 / 2
//   y     = R(T) p + t(T) - p_mid;   p_rig = R(q_t)^T y
//   p_cam = R(E) p_rig + t(E);       res = sqrt_h (proj(intr, p_cam) - obs)
// and the Jacobian over the 35 tangents, written out as the chain rule
// (the Pallas kernel took it from two in-kernel transpose passes):
//   A = sqrt_h d uv/d p_cam,  A_r = R(E)^T A,  B = R(q_t) A_r
//   J_pt = R(q_t^-1 T)^T A_r, J_pose = [B | z x B] with z = R(T) p + t(T) - (p_mid - dP_t),
//   J_vel = -dtt R(T)^T B, J_extr = [A | p_cam x A],
//   J_intr[0:15] = sqrt_h d uv/d params,
//   J_intr[15] = tpf J_dtt, J_intr[16] = -J_dtt,
//   J_dtt = A_r (-ig x p_rig - R(q_t)^T (dV[seg] + R(q[seg]) (dV_loc + idv)
//                 + R(T) vel + R(T) g dtt)).
// The derivative through readout and time offset flows only through dtt.
// Each column is masked by its variable row's mask.
//
// Inputs and outputs are float32. The residual chain is float64 in
// registers end to end (world-scale positions composed through a longer
// chain than K1's; float32 would miss the 1e-4 residual bound, as K1's
// float32 version missed its 1e-5). Bound: bytes — ~44 B of per-observation
// inputs, ~150 B of gathered rows (mostly L2 hits) and 316 B of outputs per
// observation (8 B in the residual-only mode); outputs are written with the
// observation axis last, so every column store is coalesced.
//
// Design on the card (rs_linearize_mode): one instantiation per mode,
// <camera model, Jacobian, calibration columns>, so the residual-only pass
// (the cost) compiles no Jacobian chain and gets its own, small register
// allocation, and the Jacobian pass keeps less alive at once: every rotation
// is applied as a quaternion (no 3x3 matrices), the Jacobian chain below A
// runs in float32 from float32 copies of its inputs made before the
// projection (T, p_mid, dP_t and y stay float64), and each group is stored
// as soon as it is computed (J_pt, J_r, J_cal extrinsics and J_dtt, then the
// intrinsics' param_jac last).
#include "camera.cuh"

namespace {

using namespace viba;

__device__ __forceinline__ void cross3(const real* a, const real* b, real* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void qmul(const real* a, const real* b, real* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// lie.so3_exp with its Taylor guard (theta^2 < 1e-12)
__device__ __forceinline__ void so3_exp(const real* w, real* q) {
  const real t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  real s, c;
  if (t2 < 1e-12) {
    s = 0.5 - t2 / 48.0 + t2 * t2 / 3840.0;
    c = 1.0 - t2 / 8.0 + t2 * t2 / 384.0;
  } else {
    const real t = sqrt(t2);
    s = sin(0.5 * t) / t;
    c = cos(0.5 * t);
  }
  q[0] = c;
  q[1] = s * w[0];
  q[2] = s * w[1];
  q[3] = s * w[2];
}

// motion._integration_coeffs c1..c3 with its Taylor guard (theta < 1e-3)
__device__ __forceinline__ void int_coeffs(real theta2, real& c1, real& c2, real& c3) {
  const real theta = sqrt(theta2 + 1e-30);
  const real th4 = theta2 * theta2;
  if (theta < 1e-3) {
    c1 = 1.0 / 2.0 - theta2 / 24.0 + th4 / 729.0;
    c2 = 1.0 / 6.0 - theta2 / 120.0 + th4 / 5040.0;
    c3 = 1.0 / 24.0 - theta2 / 729.0 + th4 / 40320.0;
  } else {
    const real s_over = sin(theta) / theta;
    const real mc_over = (1.0 - cos(theta)) / theta2;
    c1 = mc_over;
    c2 = (1.0 - s_over) / theta2;
    c3 = (0.5 - mc_over) / theta2;
  }
}

__device__ __forceinline__ void load3(const float* p, real* o) {
  o[0] = p[0];
  o[1] = p[1];
  o[2] = p[2];
}


struct RsArgs {
  int n, K;
  const int *rig, *rs_row, *point, *intr, *extr;
  const float *pad, *tpf, *obs_uv, *sqrt_h, *pose_q, *pose_t, *vel, *points, *cam_intr, *extr_q,
      *extr_t, *rig_mask, *pt_mask, *intr_mask, *extr_mask, *rs_dt, *rs_q, *rs_dP, *rs_dV, *rs_ig,
      *rs_ia, *rs_idv;
  const long long* rs_count;  // the tables' int64 counts, read as they are
  const float* gravity;
  float *res, *valid, *J_pt, *J_r, *J_cal;
};

// the float64 primal chain of one observation, up to p_cam, and what the
// Jacobian reads of it
struct RsPrimal {
  const float* Kp;
  bool seg_ok;
  real tp, dtt, sq[4], sdV[3], ig[3], idv[3], dVloc[3], qt[4], Tq[4], Tt[3], vmid[3], gmid[3],
      prot[3], m[3], Tq2[4], pr[3], Eq[4], pc[3];
};

__device__ __forceinline__ void rs_primal(const RsArgs& a, int i, int r, int rr, int p, int ci,
                                          int ce, RsPrimal& o) {
  o.Kp = a.cam_intr + (long)ci * kMaxParams;

  // segment lookup at the primal capture time
  o.tp = a.tpf[i];
  o.dtt = real(o.Kp[15]) * o.tp - real(o.Kp[16]);
  const real dtt = o.dtt;
  const float* dt_row = a.rs_dt + (long)rr * a.K;
  int lo = 0, hi = a.K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (real(dt_row[mid]) <= dtt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  o.seg_ok = lo > 0 && lo < a.rs_count[rr];
  const long sk = (long)rr * a.K + (lo > 0 ? lo - 1 : 0);  // lo <= K
  const real sdt = isfinite(a.rs_dt[sk]) ? real(a.rs_dt[sk]) : 0.0;
  real sdP[3], ia[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) o.sq[c] = a.rs_q[4 * sk + c];
  load3(a.rs_dV + 3 * sk, o.sdV);
  load3(a.rs_dP + 3 * sk, sdP);
  load3(a.rs_ig + 3 * sk, o.ig);
  load3(a.rs_ia + 3 * sk, ia);
  load3(a.rs_idv + 3 * sk, o.idv);

  // constant-signal integral over dtl and the capture-time pose shift
  const real dtl = dtt - sdt;
  const real om[3] = {o.ig[0] * dtl, o.ig[1] * dtl, o.ig[2] * dtl};
  const real up[3] = {ia[0] * dtl, ia[1] * dtl, ia[2] * dtl};
  real c1, c2, c3;
  int_coeffs(om[0] * om[0] + om[1] * om[1] + om[2] * om[2], c1, c2, c3);
  real oxu[3], oxoxu[3], qloc[4];
  cross3(om, up, oxu);
  cross3(om, oxu, oxoxu);
  so3_exp(om, qloc);
  qmul(o.sq, qloc, o.qt);
  real dPloc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dPloc[c] = (0.5 * up[c] + c2 * oxu[c] + c3 * oxoxu[c]) * dtl + o.idv[c] * dtl;
    o.dVloc[c] = up[c] + c1 * oxu[c] + c2 * oxoxu[c];
  }
  real rdp[3];
  qrot(o.sq, dPloc, rdp);
  real V[3], P[3], G[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) o.Tq[c] = a.pose_q[4 * (long)r + c];
  load3(a.pose_t + 3 * (long)r, o.Tt);
  load3(a.vel + 3 * (long)r, V);
  load3(a.points + 3 * (long)p, P);
  load3(a.gravity, G);
  qrot(o.Tq, V, o.vmid);
  qrot(o.Tq, G, o.gmid);
  qrot(o.Tq, P, o.prot);
  const real hdtt2 = 0.5 * dtt * dtt;
  real pmid[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.m[c] = o.vmid[c] * dtt + o.gmid[c] * hdtt2;
    pmid[c] = sdP[c] + o.sdV[c] * dtl + rdp[c] + o.m[c];
  }
  // T_bodyImuAtT_world = (q_t, p_mid)^-1 T, composed as the factor does
  // (quaternion product first: the float32 table quaternions are unit only
  // to ~1e-7, and world-scale points make the order visible in the residual)
  const real Sq[4] = {o.qt[0], -o.qt[1], -o.qt[2], -o.qt[3]};
  real rt[3], rp[3];
  qmul(Sq, o.Tq, o.Tq2);
  qrot(o.Tq2, P, o.pr);
  qrot(Sq, o.Tt, rt);
  qrot(Sq, pmid, rp);
#pragma unroll
  for (int c = 0; c < 3; ++c) o.pr[c] += rt[c] - rp[c];
  real Et[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) o.Eq[c] = a.extr_q[4 * (long)ce + c];
  load3(a.extr_t + 3 * (long)ce, Et);
  qrot(o.Eq, o.pr, o.pc);
#pragma unroll
  for (int c = 0; c < 3; ++c) o.pc[c] += Et[c];
}

// d p_rig / d dtt
__device__ __forceinline__ void rs_dpr(const RsPrimal& o, real (&dpr)[3]) {
  real igxpr[3], rsdv[3], w3[3], rw3[3];
  cross3(o.ig, o.pr, igxpr);
  const real dvi[3] = {o.dVloc[0] + o.idv[0], o.dVloc[1] + o.idv[1], o.dVloc[2] + o.idv[2]};
  qrot(o.sq, dvi, rsdv);
#pragma unroll
  for (int c = 0; c < 3; ++c) w3[c] = o.sdV[c] + rsdv[c] + o.vmid[c] + o.gmid[c] * o.dtt;
  const real Sq[4] = {o.qt[0], -o.qt[1], -o.qt[2], -o.qt[3]};
  qrot(Sq, w3, rw3);
#pragma unroll
  for (int c = 0; c < 3; ++c) dpr[c] = -igxpr[c] - rw3[c];
}

// res = sqrt_h (uv - obs) and valid; returns sqrt_h in h
__device__ __forceinline__ void rs_residual(const RsArgs& a, int i, const RsPrimal& o,
                                            const Dual& u, const Dual& v, real (&h)[2][2]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) h[c / 2][c % 2] = a.sqrt_h[4 * (long)i + c];
  const real e0 = u.v - real(a.obs_uv[2 * (long)i]);
  const real e1 = v.v - real(a.obs_uv[2 * (long)i + 1]);
  a.res[i] = float(h[0][0] * e0 + h[0][1] * e1);
  a.res[a.n + i] = float(h[1][0] * e0 + h[1][1] * e1);
  a.valid[i] = fmaxf((o.pc[2] >= kMinZ && o.seg_ok) ? 1.f : 0.f, a.pad[i]);
}

// One mode of K7: CAM 1 Fisheye624, else pinhole; JAC the Jacobian; CAL its
// calibration columns (J_cal)
template <int CAM, bool JAC, bool CAL>
__device__ __forceinline__ void rs_body(const RsArgs& a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int r = a.rig[i], p = a.point[i], ci = a.intr[i], ce = a.extr[i];
  RsPrimal o;
  rs_primal(a, i, r, a.rs_row[i], p, ci, ce, o);
  // the Jacobian chain's float32 inputs, taken before the projection so
  // that the float64 primal state dies there
  float qE[4], qt[4], q2[4], qT[4], z[3], dpr[3], pc[3];
  if constexpr (JAC) {
    quat_f(o.Eq, true, qE);    // R(E)^T
    quat_f(o.qt, false, qt);   // R(q_t)
    quat_f(o.Tq2, true, q2);   // R(q_t^-1 T)^T
    quat_f(o.Tq, true, qT);    // R(T)^T
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      z[c] = float(o.prot[c] + o.Tt[c] - o.m[c]);
      pc[c] = float(o.pc[c]);
    }
    if constexpr (CAL) {
      real d[3];
      rs_dpr(o, d);
#pragma unroll
      for (int c = 0; c < 3; ++c) dpr[c] = float(d[c]);
    }
  }
  Dual u, v;
  const Dual dx = dvar(o.pc[0], 0), dy = dvar(o.pc[1], 1), dz = dvar(o.pc[2], 2);
  if constexpr (CAM == 1) {
    proj_fisheye624(o.Kp, dx, dy, dz, u, v);
  } else {
    proj_pinhole(o.Kp, dx, dy, dz, u, v);
  }
  real h[2][2];
  rs_residual(a, i, o, u, v, h);
  if constexpr (JAC) {
    const int n = a.n;
    const bool masked = a.pt_mask != nullptr;  // all four masks or none
    const auto mask = [&](const float* m, long k) { return masked ? m[k] : 1.f; };
    const float mdtt = float(-o.dtt);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const float A[3] = {float(h[row][0] * u.d0 + h[row][1] * v.d0),
                          float(h[row][0] * u.d1 + h[row][1] * v.d1),
                          float(h[row][0] * u.d2 + h[row][1] * v.d2)};
      float Ar[3], Jp[3], B[3], jw[3], Jv[3];
      qrot_f(qE, A, Ar);
      qrot_f(q2, Ar, Jp);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        a.J_pt[(row * 3 + c) * (long)n + i] = Jp[c] * mask(a.pt_mask, 3L * p + c);
      qrot_f(qt, Ar, B);
      cross_f(z, B, jw);
      qrot_f(qT, B, Jv);
      float* Jr = a.J_r + row * 12 * (long)n + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Jr[c * (long)n] = B[c] * mask(a.rig_mask, 12L * r + c);
        Jr[(3 + c) * (long)n] = jw[c] * mask(a.rig_mask, 12L * r + 3 + c);
        Jr[(6 + c) * (long)n] = mdtt * Jv[c] * mask(a.rig_mask, 12L * r + 6 + c);
        Jr[(9 + c) * (long)n] = 0.f;
      }
      if constexpr (CAL) {
        float je[3];
        cross_f(pc, A, je);
        float* Jc = a.J_cal + row * 23 * (long)n + i;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          Jc[c * (long)n] = A[c] * mask(a.extr_mask, 6L * ce + c);
          Jc[(3 + c) * (long)n] = je[c] * mask(a.extr_mask, 6L * ce + 3 + c);
        }
        const real jdt = Ar[0] * dpr[0] + Ar[1] * dpr[1] + Ar[2] * dpr[2];
        Jc[21 * (long)n] = float(jdt * o.tp * mask(a.intr_mask, kMaxParams * (long)ci + 15));
        Jc[22 * (long)n] = float(-jdt * mask(a.intr_mask, kMaxParams * (long)ci + 16));
      }
    }
    if constexpr (CAL) {
      real dup[15], dvp[15];
      param_jac(CAM, o.Kp, o.pc[0], o.pc[1], o.pc[2], dup, dvp);
#pragma unroll
      for (int row = 0; row < 2; ++row) {
#pragma unroll
        for (int c = 0; c < 15; ++c)
          a.J_cal[(row * 23 + 6 + c) * (long)n + i] = float(
              (h[row][0] * dup[c] + h[row][1] * dvp[c]) * mask(a.intr_mask, kMaxParams * (long)ci + c));
      }
    }
  }
}

// 128 threads a block and no minimum of blocks an SM: ptxas gives the modes
// 128 (Jacobian with J_cal), 80-85 (Jacobian) and 70-72 (residual-only)
// registers. A minimum of 4, 5 or 6 blocks spilled the J_cal mode and ran
// 0.3752 / 0.3852 / 0.4919 ms against 0.3624; 8 and 10 blocks spilled the
// residual-only mode (0.1084 / 0.1450 ms against 0.1160): device times in
// turns on one H100 80GB HBM3 at 700 W.
template <int CAM, bool JAC, bool CAL>
__global__ void __launch_bounds__(128) rs_linearize_mode(RsArgs a) {
  rs_body<CAM, JAC, CAL>(a);
}

template <int CAM, bool JAC, bool CAL>
cudaError_t launch_rs(const RsArgs& a, cudaStream_t st) {
  rs_linearize_mode<CAM, JAC, CAL><<<(a.n + 127) / 128, 128, 0, st>>>(a);
  return cudaGetLastError();
}

template <int CAM>
cudaError_t launch_rs_mode(const RsArgs& a, int with_jac, int with_cal, cudaStream_t st) {
  if (!with_jac) return launch_rs<CAM, false, false>(a, st);
  if (!with_cal) return launch_rs<CAM, true, false>(a, st);
  return launch_rs<CAM, true, true>(a, st);
}

}  // namespace

extern "C" int viba_rs_linearize(
    int n, int R, int K, int camera_kind, int with_jac, int with_cal, const int* rig,
    const int* rs_row, const int* point, const int* intr, const int* extr, const float* pad,
    const float* tpf, const float* obs_uv, const float* sqrt_h, const float* pose_q,
    const float* pose_t, const float* vel, const float* points, const float* cam_intr,
    const float* extr_q, const float* extr_t, const float* rig_mask, const float* pt_mask,
    const float* intr_mask, const float* extr_mask, const float* rs_dt, const float* rs_q,
    const float* rs_dP, const float* rs_dV, const float* rs_ig, const float* rs_ia,
    const float* rs_idv, const long long* rs_count, const float* gravity, float* res,
    float* valid, float* J_pt, float* J_r, float* J_cal, void* stream) {
  (void)R;
  if (n <= 0) return 0;
  const RsArgs a{n, K, rig, rs_row, point, intr, extr, pad, tpf, obs_uv, sqrt_h, pose_q,
                 pose_t, vel, points, cam_intr, extr_q, extr_t, rig_mask, pt_mask, intr_mask,
                 extr_mask, rs_dt, rs_q, rs_dP, rs_dV, rs_ig, rs_ia, rs_idv, rs_count, gravity,
                 res, valid, J_pt, J_r, J_cal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(camera_kind == 1 ? launch_rs_mode<1>(a, with_jac, with_cal, st)
                                           : launch_rs_mode<0>(a, with_jac, with_cal, st));
}
