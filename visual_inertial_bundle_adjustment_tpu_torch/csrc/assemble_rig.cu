// K2: lambda-independent assembly of a blocked visual batch, rig and
// landmark side (K8, cal_segments.cu, runs the same two passes around its
// window pass).
//
// Replaces the Pallas kernel _assemble_rig_kernel (JAX ops/segments.py:840,
// entry seg_assemble_rig :892). Layouts: J_r (2, K, N) with K = rig_k in
// {6, 9}, J_p (2, 3, N), res (2, N), w (N) — observation axis last.
//
// Bound: bytes. Two launches (assemble_rig.cuh): a 128-thread group per rig
// row (g_r, diag_r) beside one thread per slot storing sqrt(w) J_p and
// sqrt(w) res as one 32-byte sector at the slot's point-sorted position;
// then a 16-lane group per landmark summing its contiguous range of
// sectors. Per real slot: 8K + 56 B read and 32 B stored, then the 32 B
// read back in landmark order. On one H100 80GB HBM3 at 700 W (chip_smoke.py,
// in turns), two designs measured and dropped:
//   - each slot's 9 landmark values (g_l's 3, the upper triangle of
//     J_p^T w J_p) written at the slot of a slot-major table by the rig-row
//     groups, then a group per landmark gathering its slots' rows through
//     its list: 0.0382 ms at the bias headline and 0.1438 at the
//     full-sensor batch, against 0.0343 and 0.1418 for this design; the
//     gathers of 9 floats at 36 B strides are one or two sectors each;
//   - this design with the rig rows moved from the first launch to the
//     second (256-thread blocks, beside the landmark sums): 0.0351 / 0.1705.
// The old design, one launch that walks the landmark lists, took 0.0275 /
// 0.1484 in the same calls: at the bias headline J_p, w and res (14 MB)
// stay in the L2 and its scattered sectors are L2 hits, so a second launch
// does not pay.
#include "assemble_rig.cuh"
#include "tile_reduce.cuh"

namespace {

using viba::kBlock;
using viba::kPointGroup;
using viba::kRowGroup;

// launch 1 (assemble_rig.cuh): block b is rig row b (b < R), else the slots
// of block b - R
template <int K>
__global__ void __launch_bounds__(kBlock) assemble_rows_slots(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ pt_pos, const float* __restrict__ J_r, const float* __restrict__ J_p,
    const float* __restrict__ w, const float* __restrict__ res, float* __restrict__ g_r,
    float* __restrict__ diag_r, float4* __restrict__ q) {
  static_assert(kRowGroup == kBlock, "one rig row per block");
  const int b = blockIdx.x;
  if (b >= R) {  // slot s: its sector at its point-sorted position (pads: -1)
    const long s = (long)(b - R) * kBlock + threadIdx.x;
    const int pos = s < n ? pt_pos[s] : -1;
    if (pos < 0) return;
    const float sw = sqrtf(w[s]);
    q[2 * (long)pos] = make_float4(sw * J_p[s], sw * J_p[n + s], sw * J_p[2 * (long)n + s],
                                   sw * res[s]);
    q[2 * (long)pos + 1] = make_float4(sw * J_p[3 * (long)n + s], sw * J_p[4 * (long)n + s],
                                       sw * J_p[5 * (long)n + s], sw * res[n + s]);
    return;
  }
  viba::reduce_segments<kRowGroup, 2 * K>(
      b, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[2 * K]) {
        const float ws = w[s];
        const float r0 = res[s] * ws, r1 = res[n + s] * ws;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float j0 = J_r[c * (long)n + s], j1 = J_r[(K + c) * (long)n + s];
          acc[c] += j0 * r0 + j1 * r1;
          acc[K + c] += (j0 * j0 + j1 * j1) * ws;
        }
      },
      [&](int row, float(&acc)[2 * K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          g_r[K * (long)row + c] = acc[c];
          diag_r[K * (long)row + c] = acc[K + c];
        }
      });
}

__global__ void __launch_bounds__(kBlock) assemble_points(int L, const int* __restrict__ pt_ptr,
                                                          const float4* __restrict__ q,
                                                          float* __restrict__ g_l,
                                                          float* __restrict__ H) {
  viba::assemble_point_row(blockIdx.x * (kBlock / kPointGroup) + threadIdx.x / kPointGroup, L,
                           pt_ptr, q, g_l, H);
}

}  // namespace

// K2's first launch alone (K8's first launch): g_r, diag_r and the
// point-sorted sectors q
extern "C" int viba_assemble_rows_slots(int R, int n, int k, const int* rig_ptr,
                                        const int* rig_obs, const int* pt_pos, const float* J_r,
                                        const float* J_p, const float* w, const float* res,
                                        float* g_r, float* diag_r, float* q, void* stream) {
  const int grid = R + (n + kBlock - 1) / kBlock;  // rig rows, then slots
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* q4 = reinterpret_cast<float4*>(q);
  if (k == 6) {
    assemble_rows_slots<6><<<grid, kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, pt_pos, J_r, J_p, w,
                                                    res, g_r, diag_r, q4);
  } else if (k == 9) {
    assemble_rows_slots<9><<<grid, kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, pt_pos, J_r, J_p, w,
                                                    res, g_r, diag_r, q4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_assemble_rig(int R, int L, int n, int k, const int* rig_ptr,
                                 const int* rig_obs, const int* pt_ptr, const int* pt_pos,
                                 const float* J_r, const float* J_p, const float* w,
                                 const float* res, float* g_r, float* diag_r, float* g_l,
                                 float* H, float* q, void* stream) {
  if (k != 6 && k != 9) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = viba_assemble_rows_slots(R, n, k, rig_ptr, rig_obs, pt_pos, J_r, J_p, w, res,
                                          g_r, diag_r, q, stream);
  if (rc != 0 || L <= 0) return rc;
  assemble_points<<<viba::segment_blocks<kPointGroup>(L), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(L, pt_ptr,
                                                         reinterpret_cast<const float4*>(q), g_l,
                                                         H);
  return static_cast<int>(cudaGetLastError());
}
