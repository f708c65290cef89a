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
//
// point_range_sum_cols is the same pass for a tile of up to CT right-hand
// sides (the column-batched K4 and K9): each real slot holds CT float4s,
// one per column, at p[pt_pos[s] * CT + c]; every column's sum runs in the
// single-column order (lanes strided, the same butterfly), and z is written
// as (L, CT, 3).
#pragma once

#include "tile_reduce.cuh"

namespace viba {

// right-hand sides a pass of the column-batched K4 and K9 (ops/segments.py
// COL_TILE): the staged p is n_real x kColTile float4s
constexpr int kColTile = 8;

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

template <int G, int CT>
__global__ void __launch_bounds__(kBlock) point_range_sum_cols(int L, int ncol,
                                                               const int* __restrict__ pt_ptr,
                                                               const float4* __restrict__ p,
                                                               const float* __restrict__ hinv,
                                                               float* __restrict__ z) {
  const int l = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const bool live = l < L;
  const int beg = live ? pt_ptr[l] : 0, end = live ? pt_ptr[l + 1] : 0;
  float t[3 * CT];
#pragma unroll
  for (int i = 0; i < 3 * CT; ++i) t[i] = 0.f;
  for (int j = beg + lane; j < end; j += G) {
    const float4* q = p + (long)j * CT;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < ncol) {
        const float4 v = q[c];
        t[3 * c] += v.x;
        t[3 * c + 1] += v.y;
        t[3 * c + 2] += v.z;
      }
    }
  }
  group_sum<G, 3 * CT>(t, nullptr);
  if (live && lane == 0) {
    const float* h = hinv + 9 * (long)l;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < ncol) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          z[3 * ((long)l * CT + c) + i] =
              h[3 * i] * t[3 * c] + h[3 * i + 1] * t[3 * c + 1] + h[3 * i + 2] * t[3 * c + 2];
      }
    }
  }
}

// z (L, CT, 3) = H_ll^-1 times the landmark sums of the point-sorted p, for
// the first ncol of a tile of CT columns
template <int CT>
inline cudaError_t launch_point_range_sum_cols(int L, int ncol, const int* pt_ptr,
                                               const float4* p, const float* hinv, float* z,
                                               cudaStream_t st) {
  if (L > 0) {
    point_range_sum_cols<kPointGroup, CT>
        <<<segment_blocks<kPointGroup>(L), kBlock, 0, st>>>(L, ncol, pt_ptr, p, hinv, z);
  }
  return cudaGetLastError();
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
