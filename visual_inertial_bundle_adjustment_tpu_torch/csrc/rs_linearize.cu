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
//   A = sqrt_h d uv/d p_cam,  A_r = A R(E),  B = A_r R(q_t)^T
//   J_pt = A_r R(q_t^-1 T), J_pose = [B | z x B] with z = R(T) p + t(T) - (p_mid - dP_t),
//   J_vel = -dtt B R(T), J_extr = [A | p_cam x A],
//   J_intr[0:15] = sqrt_h d uv/d params,
//   J_intr[15] = tpf J_dtt, J_intr[16] = -J_dtt,
//   J_dtt = A_r (-ig x p_rig - R(q_t)^T (dV[seg] + R(q[seg]) (dV_loc + idv)
//                 + R(T) vel + R(T) g dtt)).
// The derivative through readout and time offset flows only through dtt.
// Each column is masked by its variable row's mask.
//
// Inputs and outputs are float32; the arithmetic is float64 in registers
// (world-scale positions composed through a longer chain than K1's; float32
// would miss the 1e-4 residual bound, as K1's float32 version missed its
// 1e-5). Bound: bytes — ~44 B of per-observation inputs, ~150 B of gathered
// rows (mostly L2 hits) and 316 B of outputs per observation; outputs are
// written with the observation axis last, so every column store is coalesced.
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

__global__ void __launch_bounds__(128) rs_linearize(
    int n, int K, int camera_kind, int with_jac, int with_cal, const int* __restrict__ rig,
    const int* __restrict__ rs_row, const int* __restrict__ point, const int* __restrict__ intr,
    const int* __restrict__ extr, const float* __restrict__ pad, const float* __restrict__ tpf,
    const float* __restrict__ obs_uv, const float* __restrict__ sqrt_h,
    const float* __restrict__ pose_q, const float* __restrict__ pose_t,
    const float* __restrict__ vel, const float* __restrict__ points,
    const float* __restrict__ cam_intr, const float* __restrict__ extr_q,
    const float* __restrict__ extr_t, const float* __restrict__ rig_mask,
    const float* __restrict__ pt_mask, const float* __restrict__ intr_mask,
    const float* __restrict__ extr_mask, const float* __restrict__ rs_dt,
    const float* __restrict__ rs_q, const float* __restrict__ rs_dP,
    const float* __restrict__ rs_dV, const float* __restrict__ rs_ig,
    const float* __restrict__ rs_ia, const float* __restrict__ rs_idv,
    const int* __restrict__ rs_count, const float* __restrict__ gravity, float* __restrict__ res,
    float* __restrict__ valid, float* __restrict__ J_pt, float* __restrict__ J_r,
    float* __restrict__ J_cal) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = rig[i], rr = rs_row[i], p = point[i], ci = intr[i], ce = extr[i];
  const float* Kp = cam_intr + (long)ci * kMaxParams;

  // segment lookup at the primal capture time
  const real tp = tpf[i];
  const real dtt = real(Kp[15]) * tp - real(Kp[16]);
  const float* dt_row = rs_dt + (long)rr * K;
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (real(dt_row[mid]) <= dtt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool seg_ok = lo > 0 && lo < rs_count[rr];
  const long sk = (long)rr * K + (lo > 0 ? lo - 1 : 0);  // lo <= K
  const real sdt = isfinite(rs_dt[sk]) ? real(rs_dt[sk]) : 0.0;
  real sq[4], sdV[3], sdP[3], ig[3], ia[3], idv[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) sq[c] = rs_q[4 * sk + c];
  load3(rs_dV + 3 * sk, sdV);
  load3(rs_dP + 3 * sk, sdP);
  load3(rs_ig + 3 * sk, ig);
  load3(rs_ia + 3 * sk, ia);
  load3(rs_idv + 3 * sk, idv);

  // constant-signal integral over dtl and the capture-time pose shift
  const real dtl = dtt - sdt;
  const real om[3] = {ig[0] * dtl, ig[1] * dtl, ig[2] * dtl};
  const real up[3] = {ia[0] * dtl, ia[1] * dtl, ia[2] * dtl};
  real c1, c2, c3;
  int_coeffs(om[0] * om[0] + om[1] * om[1] + om[2] * om[2], c1, c2, c3);
  real oxu[3], oxoxu[3], qloc[4], qt[4];
  cross3(om, up, oxu);
  cross3(om, oxu, oxoxu);
  so3_exp(om, qloc);
  qmul(sq, qloc, qt);
  real dPloc[3], dVloc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dPloc[c] = (0.5 * up[c] + c2 * oxu[c] + c3 * oxoxu[c]) * dtl + idv[c] * dtl;
    dVloc[c] = up[c] + c1 * oxu[c] + c2 * oxoxu[c];
  }
  real rdp[3];
  qrot(sq, dPloc, rdp);
  real Tq[4], Tt[3], V[3], P[3], G[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) Tq[c] = pose_q[4 * (long)r + c];
  load3(pose_t + 3 * (long)r, Tt);
  load3(vel + 3 * (long)r, V);
  load3(points + 3 * (long)p, P);
  load3(gravity, G);
  real vmid[3], gmid[3], prot[3];
  qrot(Tq, V, vmid);
  qrot(Tq, G, gmid);
  qrot(Tq, P, prot);
  const real hdtt2 = 0.5 * dtt * dtt;
  real m[3], pmid[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m[c] = vmid[c] * dtt + gmid[c] * hdtt2;
    pmid[c] = sdP[c] + sdV[c] * dtl + rdp[c] + m[c];
  }
  // T_bodyImuAtT_world = (q_t, p_mid)^-1 T, composed as the factor does
  // (quaternion product first: the float32 table quaternions are unit only
  // to ~1e-7, and world-scale points make the order visible in the residual)
  const real Sq[4] = {qt[0], -qt[1], -qt[2], -qt[3]};
  real Tq2[4], pr[3], rt[3], rp[3];
  qmul(Sq, Tq, Tq2);
  qrot(Tq2, P, pr);
  qrot(Sq, Tt, rt);
  qrot(Sq, pmid, rp);
#pragma unroll
  for (int c = 0; c < 3; ++c) pr[c] += rt[c] - rp[c];
  real pc[3], Eq[4], Et[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) Eq[c] = extr_q[4 * (long)ce + c];
  load3(extr_t + 3 * (long)ce, Et);
  qrot(Eq, pr, pc);
#pragma unroll
  for (int c = 0; c < 3; ++c) pc[c] += Et[c];

  Dual u, v;
  const Dual dx = dvar(pc[0], 0), dy = dvar(pc[1], 1), dz = dvar(pc[2], 2);
  if (camera_kind == 1) {
    proj_fisheye624(Kp, dx, dy, dz, u, v);
  } else {
    proj_pinhole(Kp, dx, dy, dz, u, v);
  }
  const real h[2][2] = {{sqrt_h[4 * (long)i], sqrt_h[4 * (long)i + 1]},
                        {sqrt_h[4 * (long)i + 2], sqrt_h[4 * (long)i + 3]}};
  const real e0 = u.v - real(obs_uv[2 * (long)i]);
  const real e1 = v.v - real(obs_uv[2 * (long)i + 1]);
  res[i] = float(h[0][0] * e0 + h[0][1] * e1);
  res[n + i] = float(h[1][0] * e0 + h[1][1] * e1);
  valid[i] = fmaxf((pc[2] >= kMinZ && seg_ok) ? 1.f : 0.f, pad[i]);
  if (!with_jac) return;

  // d res / d p_cam, then back through extr, the shifted pose and the pose
  const real du[3] = {u.d0, u.d1, u.d2}, dv[3] = {v.d0, v.d1, v.d2};
  real A[2][3], Ar[2][3], B[2][3], Jp[2][3], Jv[2][3];
  real RE[3][3], RS[3][3], RT[3][3], R2[3][3];
  rot_matrix(Eq, RE);
  rot_matrix(Sq, RS);
  rot_matrix(Tq, RT);
  rot_matrix(Tq2, R2);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) A[a][c] = h[a][0] * du[c] + h[a][1] * dv[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) Ar[a][c] = A[a][0] * RE[0][c] + A[a][1] * RE[1][c] + A[a][2] * RE[2][c];
#pragma unroll
    for (int c = 0; c < 3; ++c) B[a][c] = Ar[a][0] * RS[0][c] + Ar[a][1] * RS[1][c] + Ar[a][2] * RS[2][c];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Jp[a][c] = Ar[a][0] * R2[0][c] + Ar[a][1] * R2[1][c] + Ar[a][2] * R2[2][c];
      Jv[a][c] = -dtt * (B[a][0] * RT[0][c] + B[a][1] * RT[1][c] + B[a][2] * RT[2][c]);
    }
  }
  // d p_rig / d dtt
  real igxpr[3], rsdv[3], w3[3], rw3[3], dpr[3];
  cross3(ig, pr, igxpr);
  const real dvi[3] = {dVloc[0] + idv[0], dVloc[1] + idv[1], dVloc[2] + idv[2]};
  qrot(sq, dvi, rsdv);
#pragma unroll
  for (int c = 0; c < 3; ++c) w3[c] = sdV[c] + rsdv[c] + vmid[c] + gmid[c] * dtt;
  qrot(Sq, w3, rw3);
#pragma unroll
  for (int c = 0; c < 3; ++c) dpr[c] = -igxpr[c] - rw3[c];
  const real z[3] = {prot[0] + Tt[0] - m[0], prot[1] + Tt[1] - m[1], prot[2] + Tt[2] - m[2]};

  // masks: all four or none (residual-only callers pass none)
  const bool masked = pt_mask != nullptr;
  real pm[3] = {1, 1, 1}, rm[9] = {1, 1, 1, 1, 1, 1, 1, 1, 1};
  if (masked) {
#pragma unroll
    for (int c = 0; c < 3; ++c) pm[c] = pt_mask[3 * (long)p + c];
#pragma unroll
    for (int c = 0; c < 9; ++c) rm[c] = rig_mask[12 * (long)r + c];
  }
  real dup[15], dvp[15];
  if (with_cal) param_jac(camera_kind, Kp, pc[0], pc[1], pc[2], dup, dvp);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    real jw[3], je[3];
    cross3(z, B[a], jw);
    cross3(pc, A[a], je);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J_pt[(a * 3 + c) * (long)n + i] = float(Jp[a][c] * pm[c]);
      J_r[(a * 12 + c) * (long)n + i] = float(B[a][c] * rm[c]);
      J_r[(a * 12 + 3 + c) * (long)n + i] = float(jw[c] * rm[3 + c]);
      J_r[(a * 12 + 6 + c) * (long)n + i] = float(Jv[a][c] * rm[6 + c]);
      J_r[(a * 12 + 9 + c) * (long)n + i] = 0.f;
    }
    if (!with_cal) continue;
    const float* em = masked ? extr_mask + 6 * (long)ce : nullptr;
    const float* im = masked ? intr_mask + kMaxParams * (long)ci : nullptr;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J_cal[(a * 23 + c) * (long)n + i] = float(A[a][c] * (em ? em[c] : 1.f));
      J_cal[(a * 23 + 3 + c) * (long)n + i] = float(je[c] * (em ? em[3 + c] : 1.f));
    }
#pragma unroll
    for (int c = 0; c < 15; ++c)
      J_cal[(a * 23 + 6 + c) * (long)n + i] =
          float((h[a][0] * dup[c] + h[a][1] * dvp[c]) * (im ? im[c] : 1.f));
    const real jdt = Ar[a][0] * dpr[0] + Ar[a][1] * dpr[1] + Ar[a][2] * dpr[2];
    J_cal[(a * 23 + 21) * (long)n + i] = float(jdt * tp * (im ? im[15] : 1.f));
    J_cal[(a * 23 + 22) * (long)n + i] = float(-jdt * (im ? im[16] : 1.f));
  }
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
    const float* rs_idv, const int* rs_count, const float* gravity, float* res, float* valid,
    float* J_pt, float* J_r, float* J_cal, void* stream) {
  (void)R;
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  rs_linearize<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, K, camera_kind, with_jac, with_cal, rig, rs_row, point, intr, extr, pad, tpf, obs_uv,
      sqrt_h, pose_q, pose_t, vel, points, cam_intr, extr_q, extr_t, rig_mask, pt_mask,
      intr_mask, extr_mask, rs_dt, rs_q, rs_dP, rs_dV, rs_ig, rs_ia, rs_idv, rs_count, gravity,
      res, valid, J_pt, J_r, J_cal);
  return static_cast<int>(cudaGetLastError());
}
