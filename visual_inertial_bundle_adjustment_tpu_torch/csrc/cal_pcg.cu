// K9 and K10 on one right-hand side: the PCG matvec, the Schur right-hand
// side and the back-substitution of a calibration-coupled visual batch
// (the units and what they share: cal_segments.cuh). Replaces the Pallas
// kernels _down_light_cal_kernel (JAX ops/segments.py:1468) +
// _up_du_cal_kernel (:1519) (K9, entry viba_schur_pcg_cal below) and
// _schur_down_cal_kernel (:1005) and _schur_up_cal_kernel (:1146) (K10).
//
// K9, y = H x - W H_ll^-1 W^T x over rig and window columns, is one entry of
// four launches built around each slot's point-sorted position (pt_pos):
//   down     one thread per slot: wu = w (J_r x_r[rig] + J_c x_c[win]) and
//            p = J_p^T wu, stored at p[pt_pos[s]] (16 B, slot-major); wu is
//            not stored. Coalesced: every slot array is read in slot order.
//   points   a 16-thread group per landmark: t = the sum of p over the
//            landmark's contiguous range, z = H_ll^-1[l] t in registers
//            (pt_segments.cuh, shared with K4).
//   up       a warp per rig row, over the rig's (rig, window row) pairs
//            (ops/segments.py pair_plan_arrays): wu recomputed from J_r, J_c
//            and x (this pass reads them anyway), du = wu - w J_p z[point],
//            y_r = sum J_r^T du, and one partial row of sum J_c^T du per pair.
//   window   each window row's pair partials summed in rig order.
// The landmark solve is a global barrier between the passes, so J_r, J_c
// and J_p are read twice (coalesced): ~600 B per slot at k 9, kc 23, no
// staged wu and no window chunk lists.
//
// K10 (viba_schur_down_cal, viba_schur_up_cal), the Schur right-hand
// side, back-substitution and two-pass PCG matvec of a batch that the
// fused K9 does not take, reads each slot's J once a call, on the plans K9
// uses (pt_pos; the (rig, window row) pairs), and stores nothing per slot
// but the landmark side's 16 B:
//   down, t only (want_y false: rcs.w_transpose_x)   K9's pcg_cal_down (p =
//            J_p^T wu at p[pt_pos[s]]), then point_range_sum without the
//            3x3 solve: 2 launches;
//   down with y   cal_pair_pass<kDown>: a 128-thread group per rig row over
//            its pairs, x_r and the pair's x_c in registers; per slot wu =
//            w (J_r x_r + J_c x_c) from one read of J_r, J_c, J_p and w, p
//            stored at p[pt_pos[s]], y_r = sum J_r^T wu in registers, one
//            partial row of J_c^T wu a pair; then cal_down_sums, one launch
//            of the landmarks' sums of p (t) and the window rows' sums of
//            their pair partials (y_c): 2 launches;
//   up       cal_pair_pass<!kDown>: the same walk with wu = w J_p z[point]
//            in registers, then sum_partials over the pairs: 2 launches.
// A warp per rig row, pcg_cal_up's walk, left each lane ~9 slots of a rig
// one after another: the pass took 0.2818 / 0.2456 ms up / down with y at
// full against 0.2030 / 0.2034 for the group (chip_smoke on one H100,
// PERF.md).
// Bound: bytes — J_r, J_c, J_p and w of each real slot, the indices, x or
// z read once, the outputs written once; the down pass's p (16 B a slot)
// written and read back is its only staging.
#include "cal_segments.cuh"

namespace {

// K9 down: p[pt_pos[s]] = J_p^T w (J_r x_r[rig] + J_c x_c[win]) per real slot
template <int K, int KC, class TJ>
__global__ void __launch_bounds__(256) pcg_cal_down(
    int n, const int* __restrict__ rig, const int* __restrict__ win,
    const int* __restrict__ pt_pos, const TJ* __restrict__ J_r, const TJ* __restrict__ J_c,
    const TJ* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ x_r,
    const float* __restrict__ x_c, float4* __restrict__ p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int pos = pt_pos[s];
  if (pos < 0) return;
  const float* xr = x_r + K * (long)rig[s];
  const float* xc = x_c + KC * (long)win[s];
  float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float xv = xr[c];
    u0 += viba::jf(J_r[c * (long)n + s]) * xv;
    u1 += viba::jf(J_r[(K + c) * (long)n + s]) * xv;
  }
  // eight columns of J_c in flight: fully unrolled at kc 23, ptxas kept 32
  // registers and spilled
#pragma unroll 8
  for (int c = 0; c < KC; ++c) {
    const float xv = xc[c];
    v0 += viba::jf(J_c[c * (long)n + s]) * xv;
    v1 += viba::jf(J_c[(KC + c) * (long)n + s]) * xv;
  }
  const float ws = w[s];
  const float wu0 = (u0 + v0) * ws, wu1 = (u1 + v1) * ws;
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = viba::jf(J_p[c * (long)n + s]) * wu0 + viba::jf(J_p[(3 + c) * (long)n + s]) * wu1;
  p[pos] = make_float4(q[0], q[1], q[2], 0.f);
}

template <int D>
__device__ __forceinline__ void warp_sum(float (&acc)[D]) {
  viba::group_sum<32, D>(acc, nullptr);
}

// K9 up: per rig row, du = w (J_r x_r + J_c x_c[win]) - w J_p z[point] per slot,
// y_r = sum J_r^T du, and per (rig, window row) pair one partial sum J_c^T du
template <int K, int KC, class TJ>
__global__ void __launch_bounds__(viba::kBlock) pcg_cal_up(
    int R, int n, const int* __restrict__ rig_pair, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_obs, const int* __restrict__ pair_part,
    const int* __restrict__ win, const int* __restrict__ point, const TJ* __restrict__ J_r,
    const TJ* __restrict__ J_c, const TJ* __restrict__ J_p, const float* __restrict__ w,
    const float* __restrict__ x_r, const float* __restrict__ x_c, const float* __restrict__ z,
    float* __restrict__ part, float* __restrict__ y_r) {
  const int r = blockIdx.x * (viba::kBlock / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;  // the whole warp
  float xr[K], acc_r[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    xr[c] = x_r[K * (long)r + c];
    acc_r[c] = 0.f;
  }
  for (int q = rig_pair[r]; q < rig_pair[r + 1]; ++q) {
    const int beg = pair_ptr[q], end = pair_ptr[q + 1];
    const float* xcp = x_c + KC * (long)win[pair_obs[beg]];
    float xc[KC], acc_c[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      xc[c] = xcp[c];
      acc_c[c] = 0.f;
    }
    for (int j = beg + lane; j < end; j += 32) {
      const int s = pair_obs[j];
      float jr0[K], jr1[K], jc0[KC], jc1[KC];
      float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        jr0[c] = viba::jf(J_r[c * (long)n + s]);
        jr1[c] = viba::jf(J_r[(K + c) * (long)n + s]);
        u0 += jr0[c] * xr[c];
        u1 += jr1[c] * xr[c];
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        jc0[c] = viba::jf(J_c[c * (long)n + s]);
        jc1[c] = viba::jf(J_c[(KC + c) * (long)n + s]);
        v0 += jc0[c] * xc[c];
        v1 += jc1[c] * xc[c];
      }
      const float ws = w[s];
      const float* zp = z + 3 * (long)point[s];
      const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
      const float a0 = viba::jf(J_p[s]) * z0 + viba::jf(J_p[(long)n + s]) * z1 +
                       viba::jf(J_p[2 * (long)n + s]) * z2;
      const float a1 = viba::jf(J_p[3 * (long)n + s]) * z0 +
                       viba::jf(J_p[4 * (long)n + s]) * z1 + viba::jf(J_p[5 * (long)n + s]) * z2;
      const float d0 = (u0 + v0) * ws - a0 * ws;
      const float d1 = (u1 + v1) * ws - a1 * ws;
#pragma unroll
      for (int c = 0; c < K; ++c) acc_r[c] += jr0[c] * d0 + jr1[c] * d1;
#pragma unroll
      for (int c = 0; c < KC; ++c) acc_c[c] += jc0[c] * d0 + jc1[c] * d1;
    }
    warp_sum<KC>(acc_c);
    float* dst = part + KC * (long)pair_part[q];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (lane == c) dst[c] = acc_c[c];
    }
  }
  warp_sum<K>(acc_r);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (lane == c) y_r[K * (long)r + c] = acc_r[c];
  }
}

// K10 down with y (kDown) and up: a 128-thread group per rig row over the
// row's (rig, window row) pairs (pcg_cal_up's walk).
// A slot's wu: down, w (J_r x_r + J_c x_c[win]) with x_r and the pair's
// x_c in registers, and p[pt_pos[s]] = J_p^T wu stored for the landmark
// sums (idx = pt_pos); up, w J_p z[point] (idx = point). Thread l sums
// J_r^T wu over the slots l, l + 128, ... of each of the rig's pairs in
// pair order (y_r after the group's sum: the butterfly, then the warps in
// order) and J_c^T wu over those of one pair (the pair's partial row after
// the group's sum).
template <int K, int KC, bool kDown, class TJ>
__global__ void __launch_bounds__(viba::kBlock) cal_pair_pass(
    int n, const int* __restrict__ rig_pair, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_obs, const int* __restrict__ pair_part,
    const int* __restrict__ win, const int* __restrict__ idx, const TJ* __restrict__ J_r,
    const TJ* __restrict__ J_c, const TJ* __restrict__ J_p, const float* __restrict__ w,
    const float* __restrict__ x_r, const float* __restrict__ x_c, const float* __restrict__ z,
    float4* __restrict__ p, float* __restrict__ part, float* __restrict__ y_r) {
  constexpr int G = viba::kBlock;  // one rig row a block
  __shared__ float smem[(G / 32) * (K > KC ? K : KC)];
  const int r = blockIdx.x, lane = threadIdx.x;
  float xr[kDown ? K : 1], acc_r[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if constexpr (kDown) xr[c] = x_r[K * (long)r + c];
    acc_r[c] = 0.f;
  }
  for (int q = rig_pair[r]; q < rig_pair[r + 1]; ++q) {
    const int beg = pair_ptr[q], end = pair_ptr[q + 1];
    float xc[kDown ? KC : 1], acc_c[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) acc_c[c] = 0.f;
    if constexpr (kDown) {
      const float* xcp = x_c + KC * (long)win[pair_obs[beg]];
#pragma unroll
      for (int c = 0; c < KC; ++c) xc[c] = xcp[c];
    }
    for (int j = beg + lane; j < end; j += G) {
      const int s = pair_obs[j];
      const float ws = w[s];
      if constexpr (kDown) {
        float jr0[K], jr1[K], jc0[KC], jc1[KC];
        float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          jr0[c] = viba::jf(J_r[c * (long)n + s]);
          jr1[c] = viba::jf(J_r[(K + c) * (long)n + s]);
          u0 += jr0[c] * xr[c];
          u1 += jr1[c] * xr[c];
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          jc0[c] = viba::jf(J_c[c * (long)n + s]);
          jc1[c] = viba::jf(J_c[(KC + c) * (long)n + s]);
          v0 += jc0[c] * xc[c];
          v1 += jc1[c] * xc[c];
        }
        const float wu0 = (u0 + v0) * ws, wu1 = (u1 + v1) * ws;
        float q3[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          q3[c] = viba::jf(J_p[c * (long)n + s]) * wu0 + viba::jf(J_p[(3 + c) * (long)n + s]) * wu1;
        p[idx[s]] = make_float4(q3[0], q3[1], q3[2], 0.f);
#pragma unroll
        for (int c = 0; c < K; ++c) acc_r[c] += jr0[c] * wu0 + jr1[c] * wu1;
#pragma unroll
        for (int c = 0; c < KC; ++c) acc_c[c] += jc0[c] * wu0 + jc1[c] * wu1;
      } else {
        const float* zp = z + 3 * (long)idx[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float a0 = viba::jf(J_p[s]) * z0 + viba::jf(J_p[(long)n + s]) * z1 +
                         viba::jf(J_p[2 * (long)n + s]) * z2;
        const float a1 = viba::jf(J_p[3 * (long)n + s]) * z0 +
                         viba::jf(J_p[4 * (long)n + s]) * z1 + viba::jf(J_p[5 * (long)n + s]) * z2;
        const float d0 = a0 * ws, d1 = a1 * ws;
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc_r[c] += viba::jf(J_r[c * (long)n + s]) * d0 + viba::jf(J_r[(K + c) * (long)n + s]) * d1;
#pragma unroll
        for (int c = 0; c < KC; ++c)
          acc_c[c] += viba::jf(J_c[c * (long)n + s]) * d0 + viba::jf(J_c[(KC + c) * (long)n + s]) * d1;
      }
    }
    viba::group_sum<G, KC>(acc_c, smem);
    if (lane == 0) {
      float* dst = part + KC * (long)pair_part[q];
#pragma unroll
      for (int c = 0; c < KC; ++c) dst[c] = acc_c[c];
    }
    __syncthreads();  // smem is read before the next sum
  }
  viba::group_sum<G, K>(acc_r, smem);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) y_r[K * (long)r + c] = acc_r[c];
  }
}

// K10 down with y, second launch: blocks [0, n_sum) the window rows' sums
// of their pair partials in rig order (y_c, a thread an entry), blocks
// [n_sum, ...) each landmark's contiguous range of p (t, a 16-lane group)
__global__ void __launch_bounds__(viba::kBlock) cal_down_sums(
    int n_c, int kc, int n_sum, const int* __restrict__ win_pair, const float* __restrict__ part,
    float* __restrict__ y_c, int L, const int* __restrict__ pt_ptr, const float4* __restrict__ p,
    float* __restrict__ t) {
  constexpr int G = viba::kPointGroup;
  if (static_cast<int>(blockIdx.x) < n_sum) {  // the whole block
    viba::sum_partials_entry(blockIdx.x * (long)viba::kBlock + threadIdx.x, n_c, kc, win_pair,
                             part, y_c);
    return;
  }
  viba::point_range_row<G, false>((blockIdx.x - n_sum) * (viba::kBlock / G) + threadIdx.x / G,
                                  threadIdx.x % G, L, pt_ptr, p, nullptr, t);
}

template <int K, int KC, class TJ>
cudaError_t down_cal(int R, int L, int n, int n_real, int n_c, int want_y, const int* rig,
                     const int* win, const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                     const int* pair_ptr, const int* pair_obs, const int* pair_part,
                     const int* win_pair, const TJ* J_r, const TJ* J_c, const TJ* J_p,
                     const float* w, const float* x_r, const float* x_c, float4* p, float* part,
                     float* y_r, float* y_c, float* t, cudaStream_t st) {
  if (!want_y) {
    if (n_real > 0) {
      pcg_cal_down<K, KC, TJ><<<(n + 255) / 256, 256, 0, st>>>(n, rig, win, pt_pos, J_r, J_c,
                                                               J_p, w, x_r, x_c, p);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return viba::launch_point_sums(L, pt_ptr, p, t, st);
  }
  if (R > 0) {
    cal_pair_pass<K, KC, true, TJ><<<R, viba::kBlock, 0, st>>>(
        n, rig_pair, pair_ptr, pair_obs, pair_part, win, pt_pos, J_r, J_c, J_p, w, x_r, x_c,
        nullptr, p, part, y_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_sum = static_cast<int>(((long)n_c * KC + viba::kBlock - 1) / viba::kBlock);
  const int grid = n_sum + (L > 0 ? viba::segment_blocks<viba::kPointGroup>(L) : 0);
  if (grid > 0) {
    cal_down_sums<<<grid, viba::kBlock, 0, st>>>(n_c, KC, n_sum, win_pair, part, y_c, L, pt_ptr,
                                                 p, t);
  }
  return cudaGetLastError();
}

template <int K, int KC, class TJ>
cudaError_t up_cal(int R, int n, int n_c, const int* rig_pair, const int* pair_ptr,
                   const int* pair_obs, const int* pair_part, const int* win_pair,
                   const int* point, const TJ* J_r, const TJ* J_c, const TJ* J_p,
                   const float* w, const float* z, float* part, float* y_r, float* y_c,
                   cudaStream_t st) {
  if (R > 0) {
    cal_pair_pass<K, KC, false, TJ><<<R, viba::kBlock, 0, st>>>(
        n, rig_pair, pair_ptr, pair_obs, pair_part, nullptr, point, J_r, J_c, J_p, w, nullptr,
        nullptr, z, nullptr, part, y_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_c, KC, win_pair, part, y_c, st);
}

template <int K, int KC, class TJ>
cudaError_t pcg_cal(int R, int L, int n, int n_real, int n_c, const int* rig, const int* win,
                    const int* point, const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                    const int* pair_ptr, const int* pair_obs, const int* pair_part,
                    const int* win_pair, const TJ* J_r, const TJ* J_c, const TJ* J_p,
                    const float* w, const float* x_r, const float* x_c, const float* hinv,
                    float4* p, float* z, float* part, float* y_r, float* y_c, cudaStream_t st) {
  if (n_real > 0) {
    pcg_cal_down<K, KC, TJ><<<(n + 255) / 256, 256, 0, st>>>(n, rig, win, pt_pos, J_r, J_c, J_p,
                                                             w, x_r, x_c, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  {
    const cudaError_t err = viba::launch_point_range_sum(L, pt_ptr, p, hinv, z, st);
    if (err != cudaSuccess) return err;
  }
  if (R > 0) {
    pcg_cal_up<K, KC, TJ><<<viba::segment_blocks<32>(R), viba::kBlock, 0, st>>>(
        R, n, rig_pair, pair_ptr, pair_obs, pair_part, win, point, J_r, J_c, J_p, w, x_r, x_c, z,
        part, y_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_c, KC, win_pair, part, y_c, st);
}

}  // namespace

// The K9 / K10 entries for J of element type TJ (J_r, J_c and J_p alike),
// dispatched on rig_k and kc
template <class TJ>
int down_cal_typed(int R, int L, int n, int n_real, int k, int kc, int n_c, int want_y,
                   const int* rig, const int* win, const int* pt_pos, const int* pt_ptr,
                   const int* rig_pair, const int* pair_ptr, const int* pair_obs,
                   const int* pair_part, const int* win_pair, const void* J_r_,
                   const void* J_c_, const void* J_p_, const float* w, const float* x_r,
                   const float* x_c, float* p, float* part, float* y_r, float* y_c, float* t,
                   cudaStream_t st) {
  const TJ *J_r = static_cast<const TJ*>(J_r_), *J_c = static_cast<const TJ*>(J_c_),
           *J_p = static_cast<const TJ*>(J_p_);
  float4* p4 = reinterpret_cast<float4*>(p);
#define VIBA_DOWN(K, KC)                                                                        \
  static_cast<int>(down_cal<K, KC, TJ>(R, L, n, n_real, n_c, want_y, rig, win, pt_pos, pt_ptr, \
                                       rig_pair, pair_ptr, pair_obs, pair_part, win_pair, J_r,  \
                                       J_c, J_p, w, x_r, x_c, p4, part, y_r, y_c, t, st))
  if (k == 6) return VIBA_DISPATCH_KC(kc, VIBA_DOWN(6, 6), VIBA_DOWN(6, 17), VIBA_DOWN(6, 23));
  if (k == 9) return VIBA_DISPATCH_KC(kc, VIBA_DOWN(9, 6), VIBA_DOWN(9, 17), VIBA_DOWN(9, 23));
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_DOWN
}

template <class TJ>
int up_cal_typed(int R, int n, int k, int kc, int n_c, const int* rig_pair, const int* pair_ptr,
                 const int* pair_obs, const int* pair_part, const int* win_pair,
                 const int* point, const void* J_r_, const void* J_c_, const void* J_p_,
                 const float* w, const float* z, float* part, float* y_r, float* y_c,
                 cudaStream_t st) {
  const TJ *J_r = static_cast<const TJ*>(J_r_), *J_c = static_cast<const TJ*>(J_c_),
           *J_p = static_cast<const TJ*>(J_p_);
#define VIBA_UP(K, KC)                                                                      \
  static_cast<int>(up_cal<K, KC, TJ>(R, n, n_c, rig_pair, pair_ptr, pair_obs, pair_part,    \
                                     win_pair, point, J_r, J_c, J_p, w, z, part, y_r, y_c, st))
  if (k == 6) return VIBA_DISPATCH_KC(kc, VIBA_UP(6, 6), VIBA_UP(6, 17), VIBA_UP(6, 23));
  if (k == 9) return VIBA_DISPATCH_KC(kc, VIBA_UP(9, 6), VIBA_UP(9, 17), VIBA_UP(9, 23));
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_UP
}

template <class TJ>
int pcg_cal_typed(int R, int L, int n, int n_real, int k, int kc, int n_c, const int* rig,
                  const int* win, const int* point, const int* pt_pos, const int* pt_ptr,
                  const int* rig_pair, const int* pair_ptr, const int* pair_obs,
                  const int* pair_part, const int* win_pair, const void* J_r_,
                  const void* J_c_, const void* J_p_, const float* w, const float* x_r,
                  const float* x_c, const float* hinv, float* p, float* z, float* part,
                  float* y_r, float* y_c, cudaStream_t st) {
  const TJ *J_r = static_cast<const TJ*>(J_r_), *J_c = static_cast<const TJ*>(J_c_),
           *J_p = static_cast<const TJ*>(J_p_);
  float4* p4 = reinterpret_cast<float4*>(p);
#define VIBA_PCG(K, KC)                                                                         \
  static_cast<int>(pcg_cal<K, KC, TJ>(R, L, n, n_real, n_c, rig, win, point, pt_pos, pt_ptr,   \
                                      rig_pair, pair_ptr, pair_obs, pair_part, win_pair, J_r,  \
                                      J_c, J_p, w, x_r, x_c, hinv, p4, z, part, y_r, y_c, st))
  if (k == 6) return VIBA_DISPATCH_KC(kc, VIBA_PCG(6, 6), VIBA_PCG(6, 17), VIBA_PCG(6, 23));
  if (k == 9) return VIBA_DISPATCH_KC(kc, VIBA_PCG(9, 6), VIBA_PCG(9, 17), VIBA_PCG(9, 23));
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_PCG
}

// jt: the J type code of the K9 / K10 entries (VIBA_BY_JTYPE)
extern "C" int viba_schur_down_cal(int R, int L, int n, int n_real, int k, int kc, int n_c,
                                   int jt, int want_y, const int* rig, const int* win,
                                   const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                                   const int* pair_ptr, const int* pair_obs,
                                   const int* pair_part, const int* win_pair, const void* J_r,
                                   const void* J_c, const void* J_p, const float* w,
                                   const float* x_r, const float* x_c, float* p, float* part,
                                   float* y_r, float* y_c, float* t, void* stream) {
  return VIBA_BY_JTYPE(jt, down_cal_typed, R, L, n, n_real, k, kc, n_c, want_y, rig, win, pt_pos,
                       pt_ptr, rig_pair, pair_ptr, pair_obs, pair_part, win_pair, J_r, J_c, J_p,
                       w, x_r, x_c, p, part, y_r, y_c, t, static_cast<cudaStream_t>(stream));
}

extern "C" int viba_schur_up_cal(int R, int n, int k, int kc, int n_c, int jt,
                                 const int* rig_pair, const int* pair_ptr, const int* pair_obs,
                                 const int* pair_part, const int* win_pair, const int* point,
                                 const void* J_r, const void* J_c, const void* J_p,
                                 const float* w, const float* z, float* part, float* y_r,
                                 float* y_c, void* stream) {
  return VIBA_BY_JTYPE(jt, up_cal_typed, R, n, k, kc, n_c, rig_pair, pair_ptr, pair_obs,
                       pair_part, win_pair, point, J_r, J_c, J_p, w, z, part, y_r, y_c,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int viba_schur_pcg_cal(int R, int L, int n, int n_real, int k, int kc, int n_c,
                                  int jt, const int* rig, const int* win, const int* point,
                                  const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                                  const int* pair_ptr, const int* pair_obs, const int* pair_part,
                                  const int* win_pair, const void* J_r, const void* J_c,
                                  const void* J_p, const float* w, const float* x_r,
                                  const float* x_c, const float* hinv, float* p, float* z,
                                  float* part, float* y_r, float* y_c, void* stream) {
  return VIBA_BY_JTYPE(jt, pcg_cal_typed, R, L, n, n_real, k, kc, n_c, rig, win, point, pt_pos,
                       pt_ptr, rig_pair, pair_ptr, pair_obs, pair_part, win_pair, J_r, J_c, J_p,
                       w, x_r, x_c, hinv, p, z, part, y_r, y_c,
                       static_cast<cudaStream_t>(stream));
}
