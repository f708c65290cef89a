// K6 / K5 and the two halves of K4: the Schur-complement matvec passes.
//
// schur_down replaces _schur_down_kernel (JAX ops/segments.py:586) and
// _down_light_kernel (:1318); schur_up replaces _schur_up_kernel (:725) and
// _up_du_kernel (:1347). K4, the PCG matvec y = J_r^T w J_r x - W H_ll^-1 W^T x
// (entry seg_schur_pcg :1387), is schur_down -> the 3x3 landmark solve in
// torch -> schur_up with the staged wu, as the JAX package composes it.
//
// schur_down runs in two launches of one kernel (tile_reduce.cuh groups):
//   phase 0, a 128-thread group per rig row: wu = w J_r x[rig] (stored for
//            every real slot) and, if want_y, y = sum J_r^T wu;
//   phase 1, a 16-thread group per landmark: t = sum J_p^T wu (= W^T x).
// schur_up, a 128-thread group per rig row:
//   y = sum J_r^T (wu - w J_p z[pt])   with the staged wu (K4), or
//   y = sum J_r^T w J_p z[pt]          without it (K5, = W z).
// Bound: bytes — J_r (48 B) + J_p (24 B) + w and wu per observation per pass;
// K4 reads J twice per PCG iteration.
#include "tile_reduce.cuh"

namespace {

using viba::kPointGroup;
using viba::kRowGroup;

__global__ void __launch_bounds__(viba::kBlock) schur_down(
    int phase, int R, int L, int n, int want_y, const int* __restrict__ rig_ptr,
    const int* __restrict__ rig_obs, const int* __restrict__ pt_ptr,
    const int* __restrict__ pt_obs, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ x,
    float* __restrict__ y, float* __restrict__ t, float* __restrict__ wu) {
  if (phase == 0) {
    const int row = blockIdx.x;  // one rig row per block (kRowGroup == kBlock)
    float xr[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) xr[c] = row < R ? x[6 * row + c] : 0.f;
    viba::reduce_segments<kRowGroup, 6>(
        blockIdx.x, R, rig_ptr, rig_obs,
        [&](int s, float(&acc)[6]) {
          float j0[6], j1[6], u0 = 0.f, u1 = 0.f;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            j0[c] = J_r[c * (long)n + s];
            j1[c] = J_r[(6 + c) * (long)n + s];
            u0 += j0[c] * xr[c];
            u1 += j1[c] * xr[c];
          }
          const float ws = w[s];
          const float wu0 = u0 * ws, wu1 = u1 * ws;
          wu[s] = wu0;
          wu[n + s] = wu1;
          if (want_y) {
#pragma unroll
            for (int c = 0; c < 6; ++c) acc[c] += j0[c] * wu0 + j1[c] * wu1;
          }
        },
        [&](int r, float(&acc)[6]) {
          if (want_y) {
#pragma unroll
            for (int c = 0; c < 6; ++c) y[6 * r + c] = acc[c];
          }
        });
  } else {
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
          for (int c = 0; c < 3; ++c) t[3 * p + c] = acc[c];
        });
  }
}

__global__ void __launch_bounds__(viba::kBlock) schur_up(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ z,
    const float* __restrict__ wu, float* __restrict__ y) {
  viba::reduce_segments<kRowGroup, 6>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[6]) {
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
        for (int c = 0; c < 6; ++c)
          acc[c] += J_r[c * (long)n + s] * d0 + J_r[(6 + c) * (long)n + s] * d1;
      },
      [&](int r, float(&acc)[6]) {
#pragma unroll
        for (int c = 0; c < 6; ++c) y[6 * r + c] = acc[c];
      });
}

}  // namespace

extern "C" int viba_schur_down(int R, int L, int n, int want_y, const int* rig_ptr,
                               const int* rig_obs, const int* pt_ptr, const int* pt_obs,
                               const float* J_r, const float* J_p, const float* w,
                               const float* x, float* y, float* t, float* wu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    schur_down<<<viba::segment_blocks<kRowGroup>(R), viba::kBlock, 0, st>>>(
        0, R, L, n, want_y, rig_ptr, rig_obs, pt_ptr, pt_obs, J_r, J_p, w, x, y, t, wu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (L > 0) {
    schur_down<<<viba::segment_blocks<kPointGroup>(L), viba::kBlock, 0, st>>>(
        1, R, L, n, want_y, rig_ptr, rig_obs, pt_ptr, pt_obs, J_r, J_p, w, x, y, t, wu);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_schur_up(int R, int n, const int* rig_ptr, const int* rig_obs,
                             const int* point, const float* J_r, const float* J_p,
                             const float* w, const float* z, const float* wu, float* y,
                             void* stream) {
  if (R <= 0) return 0;
  schur_up<<<viba::segment_blocks<kRowGroup>(R), viba::kBlock, 0,
             static_cast<cudaStream_t>(stream)>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w, z,
                                                  wu, y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* viba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
