// The landmark pass of the point-sorted routes: K4 and K6 (schur.cu), K9
// (cal_segments.cu).
//
// Walking a landmark's CSR list reads the rig-ordered slot arrays at
// scattered slots, one 32-byte sector per float. The point-sorted routes
// instead run a pass over the slots in slot order (every slot array read
// coalesced) that stores each real slot's three landmark-side values as one
// float4 (16 B) at the slot's point-sorted position pt_pos[s]
// (ops/segments.py SegPlan.pt_pos: pt_pos[pt_obs[j]] = j, -1 on the pads),
// so that each landmark's values form one contiguous range
// [pt_ptr[l], pt_ptr[l + 1]) of that table. This pass sums each range: a
// 16-thread group per landmark, lanes strided, a fixed butterfly at the end
// (deterministic, no atomics), then z = H_ll^-1[l] t with the landmark's
// 3x3 inverse (K4, K9) or z = t (K6: kSolve false). A landmark without
// slots gets z = 0. Bound: bytes — 16 B read per real slot, 36 B of hinv
// and 12 B of z per landmark. (K2's landmark pass, assemble_rig.cuh, sums
// 32-byte sectors at the same positions.)
#pragma once

#include "tile_reduce.cuh"

namespace viba {

template <int G, bool kSolve>
__global__ void __launch_bounds__(kBlock) point_range_sum(int L, const int* __restrict__ pt_ptr,
                                                          const float4* __restrict__ p,
                                                          const float* __restrict__ hinv,
                                                          float* __restrict__ z) {
  const int l = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const bool live = l < L;
  const int beg = live ? pt_ptr[l] : 0, end = live ? pt_ptr[l + 1] : 0;
  float t[3] = {0.f, 0.f, 0.f};
  for (int j = beg + lane; j < end; j += G) {
    const float4 q = p[j];
    t[0] += q.x;
    t[1] += q.y;
    t[2] += q.z;
  }
  group_sum<G, 3>(t, nullptr);
  if (live && lane == 0) {
    if constexpr (kSolve) {
      const float* h = hinv + 9 * (long)l;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        z[3 * (long)l + i] = h[3 * i] * t[0] + h[3 * i + 1] * t[1] + h[3 * i + 2] * t[2];
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) z[3 * (long)l + i] = t[i];
    }
  }
}

// z (L, 3) = H_ll^-1 (L, 3, 3) times the landmark sums of the point-sorted p
inline cudaError_t launch_point_range_sum(int L, const int* pt_ptr, const float4* p,
                                          const float* hinv, float* z, cudaStream_t st) {
  if (L > 0) {
    point_range_sum<kPointGroup, true>
        <<<segment_blocks<kPointGroup>(L), kBlock, 0, st>>>(L, pt_ptr, p, hinv, z);
  }
  return cudaGetLastError();
}

// t (L, 3) = the landmark sums of the point-sorted p
inline cudaError_t launch_point_sums(int L, const int* pt_ptr, const float4* p, float* t,
                                     cudaStream_t st) {
  if (L > 0) {
    point_range_sum<kPointGroup, false>
        <<<segment_blocks<kPointGroup>(L), kBlock, 0, st>>>(L, pt_ptr, p, nullptr, t);
  }
  return cudaGetLastError();
}

}  // namespace viba
