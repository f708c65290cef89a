// Group-per-segment reduction skeleton shared by the segment kernels
// (assemble_rig.cu, schur.cu, cal_pcg.cu, cal_pcg_cols.cuh, table_segments.cu).
//
// The blocked solver lays a visual batch out in rig-sorted ragged tiles
// (rcs.finalize_blocks). Every segment kernel reduces small per-observation
// products into rig rows or landmark rows. On the TPU the grid ran tiles in
// order and accumulated into VMEM-resident tables; on Hopper blocks run in
// parallel, so here each OUTPUT row is owned by one group of G threads:
//
//   for j in [ptr[row], ptr[row+1]) strided by G:  body(obs[j], acc)
//   acc <- fixed-order butterfly (and, for G > 32, a fixed-order sum over
//          the block's warps);  write(row, acc) once
//
// `obs` is a CSR list of real observation slots per row: for rigs the slots
// in slot order (contiguous runs — tiles are rig-sorted), for landmarks the
// point-sorted order. The sum order is fixed, so results are deterministic,
// and no partials, second pass or atomics are needed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace viba {

constexpr int kBlock = 128;       // threads per block, all segment kernels
constexpr int kRowGroup = 128;    // threads per rig row (~640 obs per rig)
constexpr int kPointGroup = 16;   // threads per landmark row (~40 obs per point)

// A Jacobian element as float. The kernels of the PCG loop (K3-K6, K9,
// K10) read J stored as float or, under rcs.MATVEC_BF16, as a bf16 copy
// (their template parameter TJ): each element is upcast once where it is
// loaded (exactly: a bf16 value is a float with its low 16 mantissa bits
// zero) and every product and sum stays float, so a bf16 call gives the
// float instantiation's bits on the upcast values.
__device__ __forceinline__ float jf(float v) { return v; }
__device__ __forceinline__ float jf(__nv_bfloat16 v) { return __bfloat162float(v); }

// A C entry's dispatch on its J type code (ops/segments.py J_TYPES): 0
// float, 1 bf16; fn is a host template over TJ returning an error code.
#define VIBA_BY_JTYPE(jt, fn, ...)                                     \
  ((jt) == 0   ? static_cast<int>(fn<float>(__VA_ARGS__))              \
   : (jt) == 1 ? static_cast<int>(fn<__nv_bfloat16>(__VA_ARGS__))      \
               : static_cast<int>(cudaErrorInvalidValue))

// Sum acc over the G threads of a group in a fixed order. G <= 32: every
// lane of the group ends with the same total (xor butterfly; float addition
// is commutative, so partner lanes agree bit for bit). G > 32 requires
// G == blockDim.x: thread 0 ends with the total.
template <int G, int D>
__device__ __forceinline__ void group_sum(float (&acc)[D], float* smem) {
#pragma unroll
  for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if constexpr (G > 32) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int i = 0; i < D; ++i) smem[warp * D + i] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < D; ++i) {
        float s = smem[i];
        for (int w = 1; w < G / 32; ++w) s += smem[w * D + i];
        acc[i] = s;
      }
    }
  }
}

// One group of G threads per segment (row) of a CSR list. `block` is the
// block's index within this segment family (callers may pack two families
// into one grid). body(slot, acc) accumulates one observation; write(row,
// acc) stores the row's total once. Groups past n_seg still take part in
// the warp shuffles (with an empty range) and write nothing.
template <int G, int D, class Body, class Write>
__device__ __forceinline__ void reduce_segments(int block, int n_seg, const int* __restrict__ ptr,
                                                const int* __restrict__ obs, Body body,
                                                Write write) {
  __shared__ float smem[(G > 32 ? G / 32 : 1) * D];
  const int seg = block * (kBlock / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const bool live = seg < n_seg;
  const int beg = live ? ptr[seg] : 0;
  const int end = live ? ptr[seg + 1] : 0;
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;
  for (int j = beg + lane; j < end; j += G) body(obs[j], acc);
  group_sum<G, D>(acc, smem);
  if (live && lane == 0) write(seg, acc);
}

// Second pass of a chunked reduction (rows too long for one group are cut
// into chunks, one segment each): out[row, e] = the sum of the row's chunk
// partials part[chunk, e], in chunk order. One thread per output entry idx.
__device__ __forceinline__ void sum_partials_entry(long idx, int n_rows, int D,
                                                   const int* __restrict__ row_chunk,
                                                   const float* __restrict__ part,
                                                   float* __restrict__ out) {
  if (idx >= (long)n_rows * D) return;
  const int row = static_cast<int>(idx / D), e = static_cast<int>(idx % D);
  float s = 0.f;
  for (int ch = row_chunk[row]; ch < row_chunk[row + 1]; ++ch) s += part[(long)D * ch + e];
  out[idx] = s;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads) sum_partials(int n_rows, int D,
                                                         const int* __restrict__ row_chunk,
                                                         const float* __restrict__ part,
                                                         float* __restrict__ out) {
  sum_partials_entry(blockIdx.x * (long)blockDim.x + threadIdx.x, n_rows, D, row_chunk, part,
                     out);
}

inline cudaError_t launch_sum_partials(int n_rows, int D, const int* row_chunk,
                                       const float* part, float* out, cudaStream_t st) {
  if (n_rows > 0 && D > 0) {
    sum_partials<256><<<static_cast<int>(((long)n_rows * D + 255) / 256), 256, 0, st>>>(
        n_rows, D, row_chunk, part, out);
  }
  return cudaGetLastError();
}

// Blocks needed for n_seg segments at G threads per segment.
template <int G>
inline int segment_blocks(int n_seg) {
  constexpr int per_block = kBlock / G;
  return (n_seg + per_block - 1) / per_block;
}

}  // namespace viba
