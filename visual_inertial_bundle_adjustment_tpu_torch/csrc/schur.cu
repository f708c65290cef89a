// K6 / K5 / K4: the Schur-complement matvec passes of a rig-only batch.
//
// schur_down replaces _schur_down_kernel (JAX ops/segments.py:586) and
// _down_light_kernel (:1318); schur_up replaces _schur_up_kernel (:725) and
// _up_du_kernel (:1347). K4, the PCG matvec y = J_r^T w J_r x - W H_ll^-1 W^T x
// (entry seg_schur_pcg :1387), is schur_down -> the 3x3 landmark solve in
// torch -> schur_up with the staged wu, as the JAX package composes it.
//
// schur_down runs in two launches (tile_reduce.cuh groups):
//   rig pass,      a 128-thread group per rig row: wu = w J_r x[rig] (stored
//                  for every real slot) and, if want_y, y = sum J_r^T wu;
//   landmark pass, a 16-thread group per landmark: t = sum J_p^T wu (= W^T x)
//                  (also the landmark pass of K9/K10, cal_segments.cu).
// schur_up, a 128-thread group per rig row:
//   y = sum J_r^T (wu - w J_p z[pt])   with the staged wu (K4), or
//   y = sum J_r^T w J_p z[pt]          without it (K5, = W z).
// K = rig_k (6 or 9) is a template parameter. Bound: bytes — J_r (8K B) +
// J_p (24 B) + w and wu per observation per pass; K4 reads J twice per PCG
// iteration.
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
    const float* __restrict__ wu, float* __restrict__ y) {
  viba::reduce_segments<kRowGroup, K>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[K]) {
        const float* zp = z + 3 * (long)point[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float u0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
        const float u1 =
            J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
        const float ws = w[s];
        float d0 = u0 * ws, d1 = u1 * ws;
        if (wu != nullptr) {
          d0 = wu[s] - d0;
          d1 = wu[n + s] - d1;
        }
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] += J_r[c * (long)n + s] * d0 + J_r[(K + c) * (long)n + s] * d1;
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
      });
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
                             const float* w, const float* z, const float* wu, float* y,
                             void* stream) {
  if (R <= 0) return 0;
  const int grid = viba::segment_blocks<kRowGroup>(R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 6) {
    schur_up<6><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w, z,
                                               wu, y);
  } else if (k == 9) {
    schur_up<9><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w, z,
                                               wu, y);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* viba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
