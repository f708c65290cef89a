// K3: Schur-corrected block-Jacobi rig blocks (per lambda).
//
// Replaces the Pallas kernel _precond_rig_kernel (JAX ops/segments.py:1861,
// entry seg_precond_rig :1911). One 128-thread group per rig row
// (tile_reduce.cuh) accumulates, over the rig's observations, the upper
// triangle of
//   E = w J_r J_r^T - A H_ll^-1[pt] A^T,   A = J_r^T w J_p   (K x K, K = rig_k)
// with H_ll^-1 gathered per observation from an f32 (L, 3, 3) table (the bf16
// table of the TPU version is not carried over); the triangle is written
// mirrored, as the full symmetric K x K block. K is a template parameter (6 for
// global-shutter batches, 9 for rolling-shutter ones, where the velocity
// couples): the K(K+1)/2-float accumulator (21 or 45) and the per-slot K x 3
// products stay in registers. Bound: bytes of J and the gathered 36 B
// H_ll^-1 row per observation.
#include "tile_reduce.cuh"

namespace {

using viba::kRowGroup;

template <int K>
__global__ void __launch_bounds__(viba::kBlock) precond_rig(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ hinv,
    float* __restrict__ out) {
  constexpr int T = K * (K + 1) / 2;
  viba::reduce_segments<kRowGroup, T>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[T]) {
        const float ws = w[s];
        const float* H = hinv + 9 * (long)point[s];
        float Jr[2][K], Jp[2][3];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
#pragma unroll
          for (int a = 0; a < K; ++a) Jr[d][a] = J_r[(K * d + a) * (long)n + s];
#pragma unroll
          for (int c = 0; c < 3; ++c) Jp[d][c] = J_p[(3 * d + c) * (long)n + s];
        }
        float A[K][3], C[K][3];
#pragma unroll
        for (int a = 0; a < K; ++a) {
#pragma unroll
          for (int c = 0; c < 3; ++c) A[a][c] = (Jr[0][a] * ws) * Jp[0][c] + (Jr[1][a] * ws) * Jp[1][c];
        }
#pragma unroll
        for (int a = 0; a < K; ++a) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            C[a][c] = A[a][0] * H[c] + A[a][1] * H[3 + c] + A[a][2] * H[6 + c];
        }
        int m = 0;
#pragma unroll
        for (int a = 0; a < K; ++a) {
#pragma unroll
          for (int b = a; b < K; ++b) {
            const float corr = C[a][0] * A[b][0] + C[a][1] * A[b][1] + C[a][2] * A[b][2];
            acc[m++] += ((Jr[0][a] * ws) * Jr[0][b] + (Jr[1][a] * ws) * Jr[1][b]) - corr;
          }
        }
      },
      [&](int row, float(&acc)[T]) {
        float* blk = out + K * K * (long)row;
        int m = 0;
#pragma unroll
        for (int a = 0; a < K; ++a) {
#pragma unroll
          for (int b = a; b < K; ++b) {
            blk[K * a + b] = acc[m];
            blk[K * b + a] = acc[m++];
          }
        }
      });
}

}  // namespace

extern "C" int viba_precond_rig(int R, int n, int k, const int* rig_ptr, const int* rig_obs,
                                const int* point, const float* J_r, const float* J_p,
                                const float* w, const float* hinv, float* out, void* stream) {
  if (R <= 0) return 0;
  const int grid = viba::segment_blocks<kRowGroup>(R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 6) {
    precond_rig<6><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w,
                                                  hinv, out);
  } else if (k == 9) {
    precond_rig<9><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w,
                                                  hinv, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
