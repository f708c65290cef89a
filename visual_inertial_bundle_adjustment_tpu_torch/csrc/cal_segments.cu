// K8 / K9 / K10: segment kernels of a calibration-coupled visual batch.
//
// The batch couples, besides rigs (J_r, K = rig_k columns) and landmarks
// (J_p, 3 columns), the calibration-window variables of each observation's
// window row (J_c, kc columns in the batch's cal_groups order: cam extr 6 |
// cam intr 17, or one of the two alone, kc = 23, 6 or 17 — a template
// parameter of the window kernels, dispatched on the runtime kc). Replaces the
// Pallas kernels _assemble_cal_kernel (JAX ops/segments.py:1674, entry
// seg_assemble_cal :1741), _schur_down_cal_kernel (:1005) and
// _schur_up_cal_kernel (:1146) (K10), and _down_light_cal_kernel (:1468) +
// _up_du_cal_kernel (:1519) (K9, the PCG matvec, entry viba_schur_pcg_cal
// below).
//
// Rig rows (~300 observations) and landmark rows (~30) keep K2-K6's
// group-per-row scheme (tile_reduce.cuh). Window rows are few and long (120
// rows of ~15k observations at the full-sensor size): one group per row would
// leave most of the card idle, and K8's outputs per row (197 at kc = 23, 170
// at kc = 17, 27 at kc = 6) do not fit one
// thread's registers. So each row's slot list is cut into chunks of at most
// CHUNK slots (ops/segments.py); a 128-thread group per chunk writes one
// partial row (K8: launches of 32 outputs each, seven at kc = 23, J_c re-read
// from L2),
// and a second pass (tile_reduce.cuh sum_partials) sums each row's partials in
// chunk order. Deterministic, no atomics. Bound: bytes — J_r, J_c, J_p read
// once per pass (2 x (K + 3 + kc) floats per observation), the window pass
// re-reads J_c.
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
// staged wu and no window chunk lists. K10's passes below stay separate
// (down_cal_rig stages wu, schur_down_points gathers it through the landmark
// lists, the window rows reduce through chunks).
#include <utility>

#include "pt_segments.cuh"
#include "tile_reduce.cuh"

extern "C" int viba_assemble_rig(int R, int L, int n, int k, const int* rig_ptr,
                                 const int* rig_obs, const int* pt_ptr, const int* pt_obs,
                                 const float* J_r, const float* J_p, const float* w,
                                 const float* res, float* g_r, float* diag_r, float* g_l,
                                 float* tri, void* stream);
extern "C" int viba_schur_down_points(int L, int n, const int* pt_ptr, const int* pt_obs,
                                      const float* J_p, const float* wu, float* t, void* stream);

namespace {

using viba::kRowGroup;

constexpr int kPer = 32;  // K8 window outputs per launch

// the window columns of a batch: cam extr (KE = 6 or 0) then cam intr
// (KI = 17 or 0), as the batch's cal_groups fold them (kc = 6, 17 or 23)
__host__ __device__ constexpr int tri_row(int t, int dim) {
  int a = 0;
  while (t >= dim - a) {
    t -= dim - a;
    ++a;
  }
  return a;
}
__host__ __device__ constexpr int tri_col(int t, int dim) {
  int a = 0;
  while (t >= dim - a) {
    t -= dim - a;
    ++a;
  }
  return a + t;
}

template <int KE, int KI>
struct Cal {
  static constexpr int kc = KE + KI;
  static constexpr int tri0 = kc, tri1 = kc + KE * (KE + 1) / 2;
  // K8 window outputs in order: g_c[0..kc), then the row-major upper
  // triangle of each split's self block
  static constexpr int out = tri1 + KI * (KI + 1) / 2;
  static constexpr int parts = (out + kPer - 1) / kPer;
  __host__ __device__ static constexpr int ent_a(int e) {
    return e < tri0 ? e : e < tri1 ? tri_row(e - tri0, KE) : KE + tri_row(e - tri1, KI);
  }
  __host__ __device__ static constexpr int ent_b(int e) {
    return e < tri0 ? -1 : e < tri1 ? tri_col(e - tri0, KE) : KE + tri_col(e - tri1, KI);
  }
};

template <class C, int E>
__device__ __forceinline__ void accum_one(const float (&j0)[C::kc], const float (&j1)[C::kc],
                                          float ws, float r0, float r1, float& acc) {
  if constexpr (E < C::out) {
    constexpr int a = C::ent_a(E);
    constexpr int b = C::ent_b(E);
    if constexpr (b < 0) {
      acc += j0[a] * r0 + j1[a] * r1;
    } else {
      acc += (j0[a] * ws) * j0[b] + (j1[a] * ws) * j1[b];
    }
  }
}

template <class C, int P, int... I>
__device__ __forceinline__ void accum_part(std::integer_sequence<int, I...>,
                                           const float (&j0)[C::kc], const float (&j1)[C::kc],
                                           float ws, float r0, float r1, float (&acc)[kPer]) {
  (accum_one<C, P * kPer + I>(j0, j1, ws, r0, r1, acc[I]), ...);
}

// K8 window pass: chunk partials of outputs [P*kPer, P*kPer + kPer)
template <class C, int P>
__global__ void __launch_bounds__(viba::kBlock) assemble_cal_part(
    int n_chunks, int n, const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_obs,
    const float* __restrict__ J_c, const float* __restrict__ w, const float* __restrict__ res,
    float* __restrict__ part) {
  constexpr int kc = C::kc;
  viba::reduce_segments<kRowGroup, kPer>(
      blockIdx.x, n_chunks, chunk_ptr, chunk_obs,
      [&](int s, float(&acc)[kPer]) {
        float j0[kc], j1[kc];
#pragma unroll
        for (int c = 0; c < kc; ++c) {
          j0[c] = J_c[c * (long)n + s];
          j1[c] = J_c[(kc + c) * (long)n + s];
        }
        const float ws = w[s];
        accum_part<C, P>(std::make_integer_sequence<int, kPer>{}, j0, j1, ws, res[s] * ws,
                         res[n + s] * ws, acc);
      },
      [&](int ch, float(&acc)[kPer]) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (P * kPer + i < C::out) part[C::out * (long)ch + P * kPer + i] = acc[i];
        }
      });
}

template <class C, int P>
cudaError_t launch_parts(int n_chunks, int n, const int* chunk_ptr, const int* chunk_obs,
                         const float* J_c, const float* w, const float* res, float* part,
                         cudaStream_t st) {
  if constexpr (P < C::parts) {
    assemble_cal_part<C, P><<<n_chunks, viba::kBlock, 0, st>>>(n_chunks, n, chunk_ptr,
                                                              chunk_obs, J_c, w, res, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_parts<C, P + 1>(n_chunks, n, chunk_ptr, chunk_obs, J_c, w, res, part, st);
  }
  return cudaSuccess;
}

// K9/K10 window pass: chunk partials of J_c^T u for a staged 2-row u
template <int KC>
__global__ void __launch_bounds__(viba::kBlock) cal_partials(
    int n_chunks, int n, const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_obs,
    const float* __restrict__ J_c, const float* __restrict__ u, float* __restrict__ part) {
  viba::reduce_segments<kRowGroup, KC>(
      blockIdx.x, n_chunks, chunk_ptr, chunk_obs,
      [&](int s, float(&acc)[KC]) {
        const float u0 = u[s], u1 = u[n + s];
#pragma unroll
        for (int c = 0; c < KC; ++c)
          acc[c] += J_c[c * (long)n + s] * u0 + J_c[(KC + c) * (long)n + s] * u1;
      },
      [&](int ch, float(&acc)[KC]) {
#pragma unroll
        for (int c = 0; c < KC; ++c) part[KC * (long)ch + c] = acc[c];
      });
}

template <int KC>
cudaError_t launch_rows(int n_rows, int n_chunks, int n, const int* chunk_ptr,
                        const int* chunk_obs, const int* row_chunk, const float* J_c,
                        const float* u, float* part, float* out, cudaStream_t st) {
  if (n_chunks > 0) {
    cal_partials<KC><<<n_chunks, viba::kBlock, 0, st>>>(n_chunks, n, chunk_ptr, chunk_obs, J_c,
                                                        u, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_rows, KC, row_chunk, part, out, st);
}

// K10 down, rig pass: wu = w (J_r x_r[rig] + J_c x_c[win]) for every
// real slot and, if want_y, y_r = sum J_r^T wu
template <int K, int KC>
__global__ void __launch_bounds__(viba::kBlock) down_cal_rig(
    int R, int n, int want_y, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ win, const float* __restrict__ J_r, const float* __restrict__ J_c,
    const float* __restrict__ w, const float* __restrict__ x_r, const float* __restrict__ x_c,
    float* __restrict__ y_r, float* __restrict__ wu) {
  const int row = blockIdx.x;
  float xr[K];
#pragma unroll
  for (int c = 0; c < K; ++c) xr[c] = row < R ? x_r[K * (long)row + c] : 0.f;
  viba::reduce_segments<kRowGroup, K>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[K]) {
        float j0[K], j1[K], u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          j0[c] = J_r[c * (long)n + s];
          j1[c] = J_r[(K + c) * (long)n + s];
          u0 += j0[c] * xr[c];
          u1 += j1[c] * xr[c];
        }
        const float* xc = x_c + KC * (long)win[s];
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const float xv = xc[c];
          v0 += J_c[c * (long)n + s] * xv;
          v1 += J_c[(KC + c) * (long)n + s] * xv;
        }
        const float ws = w[s];
        const float wu0 = (u0 + v0) * ws, wu1 = (u1 + v1) * ws;
        wu[s] = wu0;
        wu[n + s] = wu1;
        if (want_y) {
#pragma unroll
          for (int c = 0; c < K; ++c) acc[c] += j0[c] * wu0 + j1[c] * wu1;
        }
      },
      [&](int r, float(&acc)[K]) {
        if (want_y) {
#pragma unroll
          for (int c = 0; c < K; ++c) y_r[K * (long)r + c] = acc[c];
        }
      });
}

// K10 up, rig pass: du = w J_p z[pt], stored for the window pass, and
// y_r = sum J_r^T du
template <int K>
__global__ void __launch_bounds__(viba::kBlock) up_cal_rig(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ z,
    float* __restrict__ du, float* __restrict__ y_r) {
  viba::reduce_segments<kRowGroup, K>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[K]) {
        const float* zp = z + 3 * (long)point[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float u0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
        const float u1 =
            J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
        const float ws = w[s];
        const float d0 = u0 * ws, d1 = u1 * ws;
        du[s] = d0;
        du[n + s] = d1;
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] += J_r[c * (long)n + s] * d0 + J_r[(K + c) * (long)n + s] * d1;
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y_r[K * (long)r + c] = acc[c];
      });
}

// K9 down: p[pt_pos[s]] = J_p^T w (J_r x_r[rig] + J_c x_c[win]) per real slot
template <int K, int KC>
__global__ void __launch_bounds__(256) pcg_cal_down(
    int n, const int* __restrict__ rig, const int* __restrict__ win,
    const int* __restrict__ pt_pos, const float* __restrict__ J_r, const float* __restrict__ J_c,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ x_r,
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
    u0 += J_r[c * (long)n + s] * xv;
    u1 += J_r[(K + c) * (long)n + s] * xv;
  }
  // eight columns of J_c in flight: fully unrolled at kc 23, ptxas kept 32
  // registers and spilled
#pragma unroll 8
  for (int c = 0; c < KC; ++c) {
    const float xv = xc[c];
    v0 += J_c[c * (long)n + s] * xv;
    v1 += J_c[(KC + c) * (long)n + s] * xv;
  }
  const float ws = w[s];
  const float wu0 = (u0 + v0) * ws, wu1 = (u1 + v1) * ws;
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
  p[pos] = make_float4(q[0], q[1], q[2], 0.f);
}

template <int D>
__device__ __forceinline__ void warp_sum(float (&acc)[D]) {
  viba::group_sum<32, D>(acc, nullptr);
}

// K9 up: per rig row, du = w (J_r x_r + J_c x_c[win]) - w J_p z[point] per slot,
// y_r = sum J_r^T du, and per (rig, window row) pair one partial sum J_c^T du
template <int K, int KC>
__global__ void __launch_bounds__(viba::kBlock) pcg_cal_up(
    int R, int n, const int* __restrict__ rig_pair, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_obs, const int* __restrict__ pair_part,
    const int* __restrict__ win, const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_c, const float* __restrict__ J_p, const float* __restrict__ w,
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
        jr0[c] = J_r[c * (long)n + s];
        jr1[c] = J_r[(K + c) * (long)n + s];
        u0 += jr0[c] * xr[c];
        u1 += jr1[c] * xr[c];
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        jc0[c] = J_c[c * (long)n + s];
        jc1[c] = J_c[(KC + c) * (long)n + s];
        v0 += jc0[c] * xc[c];
        v1 += jc1[c] * xc[c];
      }
      const float ws = w[s];
      const float* zp = z + 3 * (long)point[s];
      const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
      const float a0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
      const float a1 =
          J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
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

template <int K, int KC>
cudaError_t pcg_cal(int R, int L, int n, int n_real, int n_c, const int* rig, const int* win,
                    const int* point, const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                    const int* pair_ptr, const int* pair_obs, const int* pair_part,
                    const int* win_pair, const float* J_r, const float* J_c, const float* J_p,
                    const float* w, const float* x_r, const float* x_c, const float* hinv,
                    float4* p, float* z, float* part, float* y_r, float* y_c, cudaStream_t st) {
  if (n_real > 0) {
    pcg_cal_down<K, KC><<<(n + 255) / 256, 256, 0, st>>>(n, rig, win, pt_pos, J_r, J_c, J_p, w,
                                                         x_r, x_c, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  {
    const cudaError_t err = viba::launch_point_range_sum(L, pt_ptr, p, hinv, z, st);
    if (err != cudaSuccess) return err;
  }
  if (R > 0) {
    pcg_cal_up<K, KC><<<viba::segment_blocks<32>(R), viba::kBlock, 0, st>>>(
        R, n, rig_pair, pair_ptr, pair_obs, pair_part, win, point, J_r, J_c, J_p, w, x_r, x_c, z,
        part, y_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_c, KC, win_pair, part, y_c, st);
}

template <class C>
int assemble_cal(int n_c, int n_chunks, int n, const int* chunk_ptr, const int* chunk_obs,
                 const int* row_chunk, const float* J_c, const float* w, const float* res,
                 float* part, float* out_c, cudaStream_t st) {
  if (n_chunks > 0) {
    const cudaError_t err =
        launch_parts<C, 0>(n_chunks, n, chunk_ptr, chunk_obs, J_c, w, res, part, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(viba::launch_sum_partials(n_c, C::out, row_chunk, part, out_c, st));
}

template <int KC>
int down_cal(int R, int L, int n, int k, int n_c, int n_chunks, int want_y, const int* rig_ptr,
             const int* rig_obs, const int* pt_ptr, const int* pt_obs, const int* win,
             const int* chunk_ptr, const int* chunk_obs, const int* row_chunk, const float* J_r,
             const float* J_p, const float* w, const float* J_c, const float* x_r,
             const float* x_c, float* y_r, float* y_c, float* part, float* t, float* wu,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const int grid = viba::segment_blocks<kRowGroup>(R);
    if (k == 6) {
      down_cal_rig<6, KC><<<grid, viba::kBlock, 0, st>>>(R, n, want_y, rig_ptr, rig_obs, win,
                                                         J_r, J_c, w, x_r, x_c, y_r, wu);
    } else if (k == 9) {
      down_cal_rig<9, KC><<<grid, viba::kBlock, 0, st>>>(R, n, want_y, rig_ptr, rig_obs, win,
                                                         J_r, J_c, w, x_r, x_c, y_r, wu);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rc = viba_schur_down_points(L, n, pt_ptr, pt_obs, J_p, wu, t, stream);
  if (rc != 0 || !want_y) return rc;
  return static_cast<int>(launch_rows<KC>(n_c, n_chunks, n, chunk_ptr, chunk_obs, row_chunk,
                                          J_c, wu, part, y_c, st));
}

}  // namespace

// dispatch on the window column count kc: cam extr (6), cam intr (17) or both (23)
#define VIBA_DISPATCH_KC(kc, CALL6, CALL17, CALL23) \
  ((kc) == 6 ? (CALL6) : (kc) == 17 ? (CALL17) : (kc) == 23 ? (CALL23) \
                                                         : static_cast<int>(cudaErrorInvalidValue))

extern "C" int viba_assemble_cal(int R, int L, int n, int k, int kc, int n_c, int n_chunks,
                                 const int* rig_ptr, const int* rig_obs, const int* pt_ptr,
                                 const int* pt_obs, const int* chunk_ptr, const int* chunk_obs,
                                 const int* row_chunk, const float* J_r, const float* J_p,
                                 const float* w, const float* J_c, const float* res, float* g_r,
                                 float* diag_r, float* g_l, float* tri, float* part, float* out_c,
                                 void* stream) {
  const int rc = viba_assemble_rig(R, L, n, k, rig_ptr, rig_obs, pt_ptr, pt_obs, J_r, J_p, w,
                                   res, g_r, diag_r, g_l, tri, stream);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VIBA_ASM(KE, KI)                                                                   \
  assemble_cal<Cal<KE, KI>>(n_c, n_chunks, n, chunk_ptr, chunk_obs, row_chunk, J_c, w, res, \
                            part, out_c, st)
  return VIBA_DISPATCH_KC(kc, VIBA_ASM(6, 0), VIBA_ASM(0, 17), VIBA_ASM(6, 17));
#undef VIBA_ASM
}

extern "C" int viba_schur_down_cal(int R, int L, int n, int k, int kc, int n_c, int n_chunks,
                                   int want_y, const int* rig_ptr, const int* rig_obs,
                                   const int* pt_ptr, const int* pt_obs, const int* win,
                                   const int* chunk_ptr, const int* chunk_obs,
                                   const int* row_chunk, const float* J_r, const float* J_p,
                                   const float* w, const float* J_c, const float* x_r,
                                   const float* x_c, float* y_r, float* y_c, float* part,
                                   float* t, float* wu, void* stream) {
#define VIBA_DOWN(KC)                                                                       \
  down_cal<KC>(R, L, n, k, n_c, n_chunks, want_y, rig_ptr, rig_obs, pt_ptr, pt_obs, win,     \
               chunk_ptr, chunk_obs, row_chunk, J_r, J_p, w, J_c, x_r, x_c, y_r, y_c, part, t, \
               wu, stream)
  return VIBA_DISPATCH_KC(kc, VIBA_DOWN(6), VIBA_DOWN(17), VIBA_DOWN(23));
#undef VIBA_DOWN
}

extern "C" int viba_schur_up_cal(int R, int n, int k, int kc, int n_c, int n_chunks,
                                 const int* rig_ptr, const int* rig_obs, const int* point,
                                 const int* chunk_ptr, const int* chunk_obs, const int* row_chunk,
                                 const float* J_r, const float* J_p, const float* w,
                                 const float* J_c, const float* z, float* du, float* part,
                                 float* y_r, float* y_c, void* stream) {
  if (kc != 6 && kc != 17 && kc != 23) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const int grid = viba::segment_blocks<kRowGroup>(R);
    if (k == 6) {
      up_cal_rig<6><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w,
                                                   z, du, y_r);
    } else if (k == 9) {
      up_cal_rig<9><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w,
                                                   z, du, y_r);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#define VIBA_UP(KC)                                                                       \
  static_cast<int>(launch_rows<KC>(n_c, n_chunks, n, chunk_ptr, chunk_obs, row_chunk, J_c, du, \
                                   part, y_c, st))
  return VIBA_DISPATCH_KC(kc, VIBA_UP(6), VIBA_UP(17), VIBA_UP(23));
#undef VIBA_UP
}

extern "C" int viba_schur_pcg_cal(int R, int L, int n, int n_real, int k, int kc, int n_c,
                                  const int* rig, const int* win, const int* point,
                                  const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                                  const int* pair_ptr, const int* pair_obs, const int* pair_part,
                                  const int* win_pair, const float* J_r, const float* J_c,
                                  const float* J_p, const float* w, const float* x_r,
                                  const float* x_c, const float* hinv, float* p, float* z,
                                  float* part, float* y_r, float* y_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(p);
#define VIBA_PCG(K, KC)                                                                        \
  static_cast<int>(pcg_cal<K, KC>(R, L, n, n_real, n_c, rig, win, point, pt_pos, pt_ptr,       \
                                  rig_pair, pair_ptr, pair_obs, pair_part, win_pair, J_r, J_c, \
                                  J_p, w, x_r, x_c, hinv, p4, z, part, y_r, y_c, st))
  if (k == 6) return VIBA_DISPATCH_KC(kc, VIBA_PCG(6, 6), VIBA_PCG(6, 17), VIBA_PCG(6, 23));
  if (k == 9) return VIBA_DISPATCH_KC(kc, VIBA_PCG(9, 6), VIBA_PCG(9, 17), VIBA_PCG(9, 23));
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_PCG
}
