// K6 / K5 / K4: the Schur-complement matvec passes of a rig-only batch.
//
// schur_down replaces _schur_down_kernel (JAX ops/segments.py:586);
// schur_up replaces _schur_up_kernel (:725). K4, the PCG matvec
// y = J_r^T w J_r x - W H_ll^-1 W^T x (entry seg_schur_pcg :1387, Pallas
// bodies _down_light_kernel :1318 and _up_du_kernel :1347), is
// viba_schur_pcg below.
//
// schur_down (K6) runs in two launches (tile_reduce.cuh groups):
//   rig pass,      a 128-thread group per rig row: wu = w J_r x[rig] (stored
//                  for every real slot) and, if want_y, y = sum J_r^T wu;
//   landmark pass, a 16-thread group per landmark: t = sum J_p^T wu (= W^T x)
//                  (also the landmark pass of K10, cal_segments.cu).
// schur_up (K5), a 128-thread group per rig row:
//   y = sum J_r^T w J_p z[pt]  (= W z).
// K = rig_k (6 or 9) is a template parameter. Bound: bytes — J_r (8K B) +
// J_p (24 B) + w and wu per observation per pass.
//
// K4 is one entry of three launches around each slot's point-sorted
// position (pt_segments.cuh), the design of K9 (cal_segments.cu) without
// the window columns:
//   down     one thread per slot: wu = w J_r x[rig[s]] in registers and
//            p = J_p^T wu, stored as one float4 at p[pt_pos[s]]; wu is not
//            stored. Every slot array is read in slot order (coalesced).
//   points   a 16-thread group per landmark: t = the sum of p over the
//            landmark's contiguous range, z = H_ll^-1[l] t.
//   up       a 128-thread group per rig row (its slots a contiguous run):
//            wu recomputed from J_r and the row's x in registers,
//            du = wu - w J_p z[point], y = sum J_r^T du. (A warp per rig row
//            took 0.029 ms against 0.014 on the H100 at the bias headline's
//            1,200 rows: too few warps to fill the card.)
// The landmark solve is a global barrier between the passes, so J_r and J_p
// are read twice (coalesced): no memset, no staged wu, no host work between
// the passes. Bound: bytes — ~2 x (8K + 24 + 12) B per real slot plus the
// 16 B of p written and read back.
#include "pt_segments.cuh"
#include "tile_reduce.cuh"

namespace {

using viba::kPointGroup;
using viba::kRowGroup;

template <int K>
__global__ void __launch_bounds__(viba::kBlock) schur_down_rig(
    int R, int n, int want_y, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const float* __restrict__ J_r, const float* __restrict__ w, const float* __restrict__ x,
    float* __restrict__ y, float* __restrict__ wu) {
  const int row = blockIdx.x;  // one rig row per block (kRowGroup == kBlock)
  float xr[K];
#pragma unroll
  for (int c = 0; c < K; ++c) xr[c] = row < R ? x[K * (long)row + c] : 0.f;
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
        const float ws = w[s];
        const float wu0 = u0 * ws, wu1 = u1 * ws;
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
          for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
        }
      });
}

__global__ void __launch_bounds__(viba::kBlock) schur_down_points(
    int L, int n, const int* __restrict__ pt_ptr, const int* __restrict__ pt_obs,
    const float* __restrict__ J_p, const float* __restrict__ wu, float* __restrict__ t) {
  viba::reduce_segments<kPointGroup, 3>(
      blockIdx.x, L, pt_ptr, pt_obs,
      [&](int s, float(&acc)[3]) {
        const float wu0 = wu[s], wu1 = wu[n + s];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[c] += J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
      },
      [&](int p, float(&acc)[3]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) t[3 * (long)p + c] = acc[c];
      });
}

template <int K>
__global__ void __launch_bounds__(viba::kBlock) schur_up(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ z,
    float* __restrict__ y) {
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
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] += J_r[c * (long)n + s] * d0 + J_r[(K + c) * (long)n + s] * d1;
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
      });
}

// K4 down: p[pt_pos[s]] = J_p^T w J_r x[rig[s]] per real slot
template <int K>
__global__ void __launch_bounds__(256) pcg_down(int n, const int* __restrict__ rig,
                                                const int* __restrict__ pt_pos,
                                                const float* __restrict__ J_r,
                                                const float* __restrict__ J_p,
                                                const float* __restrict__ w,
                                                const float* __restrict__ x,
                                                float4* __restrict__ p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int pos = pt_pos[s];
  if (pos < 0) return;
  const float* xr = x + K * (long)rig[s];
  float u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float xv = xr[c];
    u0 += J_r[c * (long)n + s] * xv;
    u1 += J_r[(K + c) * (long)n + s] * xv;
  }
  const float ws = w[s];
  const float wu0 = u0 * ws, wu1 = u1 * ws;
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
  p[pos] = make_float4(q[0], q[1], q[2], 0.f);
}

// K4 up: per rig row, du = w J_r x_r - w J_p z[point] per slot (wu
// recomputed), y = sum J_r^T du
template <int K>
__global__ void __launch_bounds__(viba::kBlock) pcg_up(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r, const float* __restrict__ J_p,
    const float* __restrict__ w, const float* __restrict__ x, const float* __restrict__ z,
    float* __restrict__ y) {
  const int row = blockIdx.x;  // one rig row per block (kRowGroup == kBlock)
  float xr[K];
#pragma unroll
  for (int c = 0; c < K; ++c) xr[c] = row < R ? x[K * (long)row + c] : 0.f;
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
        const float* zp = z + 3 * (long)point[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float a0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
        const float a1 =
            J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
        const float ws = w[s];
        const float d0 = u0 * ws - a0 * ws, d1 = u1 * ws - a1 * ws;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += j0[c] * d0 + j1[c] * d1;
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
      });
}

template <int K>
cudaError_t schur_pcg(int R, int L, int n, int n_real, const int* rig, const int* point,
                      const int* pt_pos, const int* pt_ptr, const int* rig_ptr,
                      const int* rig_obs, const float* J_r, const float* J_p, const float* w,
                      const float* x, const float* hinv, float4* p, float* z, float* y,
                      cudaStream_t st) {
  if (n_real > 0) {
    pcg_down<K><<<(n + 255) / 256, 256, 0, st>>>(n, rig, pt_pos, J_r, J_p, w, x, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = viba::launch_point_range_sum(L, pt_ptr, p, hinv, z, st);
  if (err != cudaSuccess || R <= 0) return err;
  pcg_up<K><<<viba::segment_blocks<kRowGroup>(R), viba::kBlock, 0, st>>>(
      R, n, rig_ptr, rig_obs, point, J_r, J_p, w, x, z, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" int viba_schur_down_points(int L, int n, const int* pt_ptr, const int* pt_obs,
                                      const float* J_p, const float* wu, float* t,
                                      void* stream) {
  if (L <= 0) return 0;
  schur_down_points<<<viba::segment_blocks<kPointGroup>(L), viba::kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(L, n, pt_ptr, pt_obs, J_p, wu, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_schur_down(int R, int L, int n, int k, int want_y, const int* rig_ptr,
                               const int* rig_obs, const int* pt_ptr, const int* pt_obs,
                               const float* J_r, const float* J_p, const float* w,
                               const float* x, float* y, float* t, float* wu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const int grid = viba::segment_blocks<kRowGroup>(R);
    if (k == 6) {
      schur_down_rig<6><<<grid, viba::kBlock, 0, st>>>(R, n, want_y, rig_ptr, rig_obs, J_r, w,
                                                       x, y, wu);
    } else if (k == 9) {
      schur_down_rig<9><<<grid, viba::kBlock, 0, st>>>(R, n, want_y, rig_ptr, rig_obs, J_r, w,
                                                       x, y, wu);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return viba_schur_down_points(L, n, pt_ptr, pt_obs, J_p, wu, t, stream);
}

extern "C" int viba_schur_up(int R, int n, int k, const int* rig_ptr, const int* rig_obs,
                             const int* point, const float* J_r, const float* J_p,
                             const float* w, const float* z, float* y, void* stream) {
  if (R <= 0) return 0;
  const int grid = viba::segment_blocks<kRowGroup>(R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 6) {
    schur_up<6><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w, z,
                                               y);
  } else if (k == 9) {
    schur_up<9><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w, z,
                                               y);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_schur_pcg(int R, int L, int n, int n_real, int k, const int* rig,
                              const int* point, const int* pt_pos, const int* pt_ptr,
                              const int* rig_ptr, const int* rig_obs,
                              const float* J_r, const float* J_p, const float* w,
                              const float* x, const float* hinv, float* p, float* z, float* y,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(p);
  if (k == 6) {
    return static_cast<int>(schur_pcg<6>(R, L, n, n_real, rig, point, pt_pos, pt_ptr,
                                         rig_ptr, rig_obs, J_r, J_p, w, x, hinv, p4, z, y, st));
  }
  if (k == 9) {
    return static_cast<int>(schur_pcg<9>(R, L, n, n_real, rig, point, pt_pos, pt_ptr,
                                         rig_ptr, rig_obs, J_r, J_p, w, x, hinv, p4, z, y, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* viba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
