// K3: Schur-corrected block-Jacobi rig blocks (per lambda).
//
// Replaces the Pallas kernel _precond_rig_kernel (JAX ops/segments.py:1861,
// entry seg_precond_rig :1911). One 128-thread group per rig row
// (tile_reduce.cuh) accumulates, over the rig's observations,
//   E = w J_r J_r^T - A H_ll^-1[pt] A^T,   A = J_r^T w J_p   (6x6, full)
// with H_ll^-1 gathered per observation from an f32 (L, 3, 3) table (the bf16
// table of the TPU version is not carried over). The wrapper symmetrizes.
// Bound: bytes of J and the gathered 36 B H_ll^-1 row per observation; the
// 36-float accumulator stays in registers.
#include "tile_reduce.cuh"

namespace {

using viba::kRowGroup;

__global__ void __launch_bounds__(viba::kBlock) precond_rig(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ hinv,
    float* __restrict__ out) {
  viba::reduce_segments<kRowGroup, 36>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[36]) {
        const float ws = w[s];
        const float* H = hinv + 9 * (long)point[s];
        float Jr[2][6], Jw[2][6], Jp[2][3];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            Jr[d][a] = J_r[(6 * d + a) * (long)n + s];
            Jw[d][a] = Jr[d][a] * ws;
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) Jp[d][c] = J_p[(3 * d + c) * (long)n + s];
        }
        float A[6][3], C[6][3];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int c = 0; c < 3; ++c) A[a][c] = Jw[0][a] * Jp[0][c] + Jw[1][a] * Jp[1][c];
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            C[a][c] = A[a][0] * H[c] + A[a][1] * H[3 + c] + A[a][2] * H[6 + c];
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            const float corr = C[a][0] * A[b][0] + C[a][1] * A[b][1] + C[a][2] * A[b][2];
            acc[6 * a + b] += (Jw[0][a] * Jr[0][b] + Jw[1][a] * Jr[1][b]) - corr;
          }
        }
      },
      [&](int row, float(&acc)[36]) {
#pragma unroll
        for (int c = 0; c < 36; ++c) out[36 * (long)row + c] = acc[c];
      });
}

}  // namespace

extern "C" int viba_precond_rig(int R, int n, const int* rig_ptr, const int* rig_obs,
                                const int* point, const float* J_r, const float* J_p,
                                const float* w, const float* hinv, float* out, void* stream) {
  if (R <= 0) return 0;
  precond_rig<<<viba::segment_blocks<kRowGroup>(R), viba::kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w,
                                                     hinv, out);
  return static_cast<int>(cudaGetLastError());
}
