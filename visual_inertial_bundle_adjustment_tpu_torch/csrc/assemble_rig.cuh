// K2's two launches (assemble_rig.cu; K8, cal_assemble.cu, runs the first as
// its first and the second inside its sum pass's launch).
//
// K2 reduces, for a blocked visual batch,
//   g_r = sum J_r^T w res,  diag_r = sum diag(J_r^T w J_r)   per rig row
//   g_l = sum J_p^T w res,  H_ll0 = sum J_p^T w J_p           per landmark
// (H_ll0 written as the full symmetric 3x3 block). Walking a landmark's
// list reads J_p, w and res at 9 scattered floats a slot, one 32-byte
// sector each; here the landmark side goes through each slot's point-sorted
// position pt_pos[s] (ops/segments.py SegPlan.pt_pos), in two launches:
//   1  blocks [0, R): a 128-thread group per rig row over its contiguous
//      run of slots, g_r and diag_r (tile_reduce.cuh reduce_segments);
//      blocks [R, ...): one thread per slot in slot order (every read
//      coalesced) storing q[pt_pos[s]] = sqrt(w) (J_p row 0, res 0 | J_p
//      row 1, res 1), two float4, one aligned 32-byte sector a slot, so that
//      each landmark's sectors are one contiguous range of q. The weights
//      are robust-loss weights, w >= 0. Pads (pt_pos -1) are not written.
//   2  a 16-lane group per landmark summing its range of q: g_l = sum a e,
//      H_ll0 = sum a a^T with a = sqrt(w) J_p, e = sqrt(w) res
//      (assemble_point_row below, shared by K2 and K8).
// Every output row has one owner and a fixed summation order (lanes
// strided over the row, a fixed butterfly): no atomics.
#pragma once

#include "tile_reduce.cuh"

namespace viba {

// landmark l (l >= L: an empty group that still takes part in the
// butterfly), for a group of kPointGroup lanes: g_l (3) and the full
// symmetric H_ll0 (3x3) from its contiguous range of q
__device__ __forceinline__ void assemble_point_row(int l, int L, const int* __restrict__ pt_ptr,
                                                   const float4* __restrict__ q,
                                                   float* __restrict__ g_l,
                                                   float* __restrict__ H) {
  const int lane = threadIdx.x % kPointGroup;
  const bool live = l < L;
  const int beg = live ? pt_ptr[l] : 0, end = live ? pt_ptr[l + 1] : 0;
  float acc[9];  // g_l, then the upper triangle 00 01 02 11 12 22 of H_ll0
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.f;
  for (int j = beg + lane; j < end; j += kPointGroup) {
    const float4 a = q[2 * (long)j], b = q[2 * (long)j + 1];
    acc[0] += a.x * a.w + b.x * b.w;
    acc[1] += a.y * a.w + b.y * b.w;
    acc[2] += a.z * a.w + b.z * b.w;
    acc[3] += a.x * a.x + b.x * b.x;
    acc[4] += a.x * a.y + b.x * b.y;
    acc[5] += a.x * a.z + b.x * b.z;
    acc[6] += a.y * a.y + b.y * b.y;
    acc[7] += a.y * a.z + b.y * b.z;
    acc[8] += a.z * a.z + b.z * b.z;
  }
  group_sum<kPointGroup, 9>(acc, nullptr);
  if (live && lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g_l[3 * (long)l + c] = acc[c];
    constexpr int kTri[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};  // the upper triangle mirrored
#pragma unroll
    for (int c = 0; c < 9; ++c) H[9 * (long)l + c] = acc[3 + kTri[c]];
  }
}

}  // namespace viba
