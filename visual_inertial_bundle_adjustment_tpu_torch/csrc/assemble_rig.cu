// K2: lambda-independent assembly of a rig-only visual batch.
//
// Replaces the Pallas kernel _assemble_rig_kernel (JAX ops/segments.py:840,
// entry seg_assemble_rig :892). One launch, two segment families packed in
// one grid (tile_reduce.cuh):
//   blocks [0, R):       one 128-thread group per rig row
//                        g_r = sum J_r^T w res,  diag_r = sum diag(J_r^T w J_r)
//   blocks [R, ...):     one 16-thread group per landmark
//                        g_l = sum J_p^T w res,  H_ll0 = sum J_p^T w J_p (upper 6)
// Layouts: J_r (2, 6, N), J_p (2, 3, N), res (2, N), w (N) — observation axis
// last. Bound: bytes, J read once (rig side coalesced, landmark side gathered).
#include "tile_reduce.cuh"

namespace {

using viba::kPointGroup;
using viba::kRowGroup;

__global__ void __launch_bounds__(viba::kBlock) assemble_rig(
    int R, int L, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ pt_ptr, const int* __restrict__ pt_obs,
    const float* __restrict__ J_r, const float* __restrict__ J_p, const float* __restrict__ w,
    const float* __restrict__ res, float* __restrict__ g_r, float* __restrict__ diag_r,
    float* __restrict__ g_l, float* __restrict__ tri) {
  if (static_cast<int>(blockIdx.x) < R) {
    viba::reduce_segments<kRowGroup, 12>(
        blockIdx.x, R, rig_ptr, rig_obs,
        [&](int s, float(&acc)[12]) {
          const float ws = w[s];
          const float r0 = res[s] * ws, r1 = res[n + s] * ws;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            const float j0 = J_r[c * (long)n + s], j1 = J_r[(6 + c) * (long)n + s];
            acc[c] += j0 * r0 + j1 * r1;
            acc[6 + c] += (j0 * j0 + j1 * j1) * ws;
          }
        },
        [&](int row, float(&acc)[12]) {
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            g_r[6 * row + c] = acc[c];
            diag_r[6 * row + c] = acc[6 + c];
          }
        });
  } else {
    viba::reduce_segments<kPointGroup, 9>(
        blockIdx.x - R, L, pt_ptr, pt_obs,
        [&](int s, float(&acc)[9]) {
          const float ws = w[s];
          const float r0 = res[s] * ws, r1 = res[n + s] * ws;
          float a[3], b[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            a[c] = J_p[c * (long)n + s];
            b[c] = J_p[(3 + c) * (long)n + s];
            acc[c] += a[c] * r0 + b[c] * r1;
          }
          int m = 3;
#pragma unroll
          for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int q = p; q < 3; ++q) acc[m++] += (a[p] * ws) * a[q] + (b[p] * ws) * b[q];
          }
        },
        [&](int row, float(&acc)[9]) {
#pragma unroll
          for (int c = 0; c < 3; ++c) g_l[3 * row + c] = acc[c];
#pragma unroll
          for (int c = 0; c < 6; ++c) tri[6 * row + c] = acc[3 + c];
        });
  }
}

}  // namespace

extern "C" int viba_assemble_rig(int R, int L, int n, const int* rig_ptr, const int* rig_obs,
                                 const int* pt_ptr, const int* pt_obs, const float* J_r,
                                 const float* J_p, const float* w, const float* res, float* g_r,
                                 float* diag_r, float* g_l, float* tri, void* stream) {
  const int grid = viba::segment_blocks<kRowGroup>(R) + viba::segment_blocks<kPointGroup>(L);
  if (grid == 0) return 0;
  assemble_rig<<<grid, viba::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      R, L, n, rig_ptr, rig_obs, pt_ptr, pt_obs, J_r, J_p, w, res, g_r, diag_r, g_l, tri);
  return static_cast<int>(cudaGetLastError());
}
