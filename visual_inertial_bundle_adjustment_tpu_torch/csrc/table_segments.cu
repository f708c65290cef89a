// K12 / K13: the table segment kernels of the general (two-grid) solver path.
//
// A blocked visual batch that is not single-pass (per-tile landmark windows
// wider than the cap: landmarks re-observed over the whole session) or that
// couples other groups than rig (+ the shared calibration-window row) is
// solved by composing four primitives over an index family (rig rows, landmark
// rows, or the rows of another variable group):
//   mv_fused    wu = w (J x[row]) per slot and y[row] = sum J^T wu, J read once
//               replaces _mv_fused_tbl_kernel   (JAX ops/segments.py:304)  K12
//   mv_scatter  y[row] = sum J^T u
//               replaces _mv_scatter_tbl_kernel (:366)                     K13a
//   mv_gather   u = J x[row] per slot
//               replaces _mv_gather_tbl_kernel  (:406)                     K13b
//   reduce      y[row] = sum contrib[:, slot]
//               replaces _reduce_tbl_kernel     (:441)                     K13c
// The TPU kernels walked the tiles of a grid in order and accumulated one-hot
// products into a VMEM-resident table; the landmark grid was a second,
// point-sorted copy of J_p reached through permutations. Here every output
// row is owned by one thread group that walks the row's slots through a CSR
// list (tile_reduce.cuh) in a fixed order: deterministic, no atomics, and the
// landmark family is just another list over the rig-ordered J_p, so no
// second copy and no permutes exist. A family with few long rows (a camera's
// intrinsics row touched by every observation) is cut into chunks, one
// segment each, whose partials a second pass sums in chunk order.
//
// Threads per segment: G = 128 (one segment per block) for long rows, G = 16
// for short ones; the wrapper picks by the mean segment length. K (Jacobian
// columns) is a template parameter in {3, 6, 9}; reduce handles any width D
// in column tiles of DT. Bound: bytes — mv_fused and mv_scatter read J (8K B)
// and a 2-row payload per slot, mv_gather the same plus a gathered table row,
// reduce 4D B per slot.
//
// reduce on a scattered family (the landmark rows: a landmark's slots lie
// far apart in the rig-ordered arrays). The walk reads contrib (D, N) at D
// scattered addresses per slot: D 32-byte sectors for 4D useful bytes, so it
// runs at the L2's sector rate (~0.23 ms at D 9 on a 3.1M-slot batch, as
// long as index_add_). This route runs in two launches instead:
//   to_slot_major  128 slots a block: their D values read as whole rows of
//                  contrib (coalesced), staged in shared memory, written
//                  slot-major as 128 x D contiguous floats (coalesced);
//   reduce_gather  one warp per row: each lane sums a fixed stride of the
//                  row's slots, a slot's D values one or two sectors of the
//                  slot-major copy, a fixed butterfly at the end; a row
//                  without slots is written as 0.
// About 8D bytes per slot streamed plus one or two gathered sectors, against
// the walk's D sectors. (Writing each slot's values at its point-sorted
// position instead, so that the sum reads one contiguous range, measured
// 2.5x slower than the walk on the H100: scattered partial-sector stores.)
// Families that are not scattered (rig rows, chunked rows) keep the walk.
//
// mv_scatter on a scattered family (K13a on the landmark rows: y = J_pt^T u
// per landmark, W^T x of every general-path matvec) would walk the same
// lists: 8 scattered floats per slot (0.22 ms on the H100 at 3.1M slots).
// It runs in two launches instead, the read side of K13c's route:
//   jtu_slot_major  one thread per slot, in slot order (coalesced): q = J^T u
//                   (6 + 2 floats read), stored as one float4 at q[s];
//   reduce_gather4  one warp per row: each lane sums a fixed stride of the
//                   row's slots, one aligned 16-byte load of q each, a fixed
//                   butterfly at the end; a row without slots is written 0.
// About 32 B read and 16 B written coalesced per slot, then one gathered
// sector. (Storing q at each slot's point-sorted position instead, so that
// a 16-thread group sums each landmark's contiguous range, measured 0.161
// ms against this route's 0.087 on the H100: 16-byte stores scattered over
// a table as large as the L2.)
#include "tile_reduce.cuh"

namespace {

using viba::kBlock;

template <int G, int K>
__global__ void __launch_bounds__(kBlock) mv_fused(
    int n_seg, int n, const int* __restrict__ ptr, const int* __restrict__ obs,
    const int* __restrict__ row, const float* __restrict__ J, const float* __restrict__ w,
    const float* __restrict__ x, float* __restrict__ wu, float* __restrict__ out) {
  // the segment's table row, loaded once (every slot of a segment has one row)
  const int seg = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  const bool has = seg < n_seg && ptr[seg] < ptr[seg + 1];
  const long r = has ? row[obs[ptr[seg]]] : 0;
  float xr[K];
#pragma unroll
  for (int c = 0; c < K; ++c) xr[c] = has ? x[K * r + c] : 0.f;
  viba::reduce_segments<G, K>(
      blockIdx.x, n_seg, ptr, obs,
      [&](int s, float(&acc)[K]) {
        float j0[K], j1[K], u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          j0[c] = J[c * (long)n + s];
          j1[c] = J[(K + c) * (long)n + s];
          u0 += j0[c] * xr[c];
          u1 += j1[c] * xr[c];
        }
        const float ws = w[s];
        const float wu0 = u0 * ws, wu1 = u1 * ws;
        wu[s] = wu0;
        wu[n + s] = wu1;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += j0[c] * wu0 + j1[c] * wu1;
      },
      [&](int sg, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) out[K * (long)sg + c] = acc[c];
      });
}

template <int G, int K>
__global__ void __launch_bounds__(kBlock) mv_scatter(
    int n_seg, int n, const int* __restrict__ ptr, const int* __restrict__ obs,
    const float* __restrict__ J, const float* __restrict__ u, float* __restrict__ out) {
  viba::reduce_segments<G, K>(
      blockIdx.x, n_seg, ptr, obs,
      [&](int s, float(&acc)[K]) {
        const float u0 = u[s], u1 = u[n + s];
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] += J[c * (long)n + s] * u0 + J[(K + c) * (long)n + s] * u1;
      },
      [&](int sg, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) out[K * (long)sg + c] = acc[c];
      });
}

template <int K>
__global__ void __launch_bounds__(256) mv_gather(int n, const int* __restrict__ row,
                                                 const float* __restrict__ J,
                                                 const float* __restrict__ x,
                                                 float* __restrict__ u) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const float* xr = x + K * (long)row[s];
  float u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float xv = xr[c];
    u0 += J[c * (long)n + s] * xv;
    u1 += J[(K + c) * (long)n + s] * xv;
  }
  u[s] = u0;
  u[n + s] = u1;
}

// columns [blockIdx.y * DT, blockIdx.y * DT + DT) of the D-wide rows
template <int G, int DT>
__global__ void __launch_bounds__(kBlock) reduce_cols(
    int n_seg, int n, int D, const int* __restrict__ ptr, const int* __restrict__ obs,
    const float* __restrict__ contrib, float* __restrict__ out) {
  const int col0 = blockIdx.y * DT;
  viba::reduce_segments<G, DT>(
      blockIdx.x, n_seg, ptr, obs,
      [&](int s, float(&acc)[DT]) {
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          if (col0 + i < D) acc[i] += contrib[(col0 + i) * (long)n + s];
        }
      },
      [&](int sg, float(&acc)[DT]) {
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          if (col0 + i < D) out[D * (long)sg + col0 + i] = acc[i];
        }
      });
}

// the D values of each of the block's 128 slots, read as whole rows of
// contrib, staged in shared memory and written slot-major: 128 x D
// contiguous floats
__global__ void __launch_bounds__(kBlock) to_slot_major(int n, int D,
                                                        const float* __restrict__ contrib,
                                                        float* __restrict__ sm) {
  extern __shared__ float tile[];  // kBlock x D
  const long s0 = (long)blockIdx.x * kBlock;
  const int cnt = static_cast<int>(n - s0 < kBlock ? n - s0 : kBlock);
  if (threadIdx.x < cnt) {
    for (int c = 0; c < D; ++c)
      tile[threadIdx.x * D + c] = contrib[c * (long)n + s0 + threadIdx.x];
  }
  __syncthreads();
  float* dst = sm + s0 * D;
  for (int e = threadIdx.x; e < cnt * D; e += kBlock) dst[e] = tile[e];
}

// one warp per row: the sum of the slot-major rows of the row's slots,
// columns [blockIdx.y * DT, blockIdx.y * DT + DT)
template <int DT>
__global__ void __launch_bounds__(kBlock) reduce_gather(int n_rows, int D,
                                                        const int* __restrict__ ptr,
                                                        const int* __restrict__ obs,
                                                        const float* __restrict__ sm,
                                                        float* __restrict__ out) {
  const int r = blockIdx.x * (kBlock / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.y * DT;
  const bool live = r < n_rows;
  const int beg = live ? ptr[r] : 0, end = live ? ptr[r + 1] : 0;
  float acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i] = 0.f;
  for (int j = beg + lane; j < end; j += 32) {
    const float* src = sm + (long)D * obs[j] + col0;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      if (col0 + i < D) acc[i] += src[i];
    }
  }
  viba::group_sum<32, DT>(acc, nullptr);
  if (live && lane == 0) {
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      if (col0 + i < D) out[D * (long)r + col0 + i] = acc[i];
    }
  }
}

template <int DT>
cudaError_t launch_slot_major(int n_rows, int n, int D, const int* ptr, const int* obs,
                              const float* contrib, float* sm, float* y, cudaStream_t st) {
  if (n > 0) {
    to_slot_major<<<(n + kBlock - 1) / kBlock, kBlock, kBlock * D * sizeof(float), st>>>(
        n, D, contrib, sm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(viba::segment_blocks<32>(n_rows), (D + DT - 1) / DT);
  reduce_gather<DT><<<grid, kBlock, 0, st>>>(n_rows, D, ptr, obs, sm, y);
  return cudaGetLastError();
}

// column tile: 3 for landmark gradients, 9 for the 3x3, 6x6 and 9x9 block
// widths (9, 36, 81) and 9-column rows, 8 otherwise
inline int column_tile(int D) { return D == 3 ? 3 : D % 9 == 0 ? 9 : 8; }

// a chunked family reduces into `part` and is finished by sum_partials
inline float* first_pass_out(const int* row_chunk, float* part, float* out) {
  return row_chunk != nullptr ? part : out;
}

inline int finish(cudaError_t err, int n_rows, int D, const int* row_chunk, const float* part,
                  float* out, cudaStream_t st) {
  if (err != cudaSuccess || row_chunk == nullptr) return static_cast<int>(err);
  return static_cast<int>(viba::launch_sum_partials(n_rows, D, row_chunk, part, out, st));
}

template <int G, int K>
cudaError_t launch_fused(int n_seg, int n, const int* ptr, const int* obs, const int* row,
                         const float* J, const float* w, const float* x, float* wu, float* y,
                         cudaStream_t st) {
  mv_fused<G, K><<<viba::segment_blocks<G>(n_seg), kBlock, 0, st>>>(n_seg, n, ptr, obs, row, J, w,
                                                                   x, wu, y);
  return cudaGetLastError();
}

template <int G, int K>
cudaError_t launch_scatter(int n_seg, int n, const int* ptr, const int* obs, const float* J,
                           const float* u, float* y, cudaStream_t st) {
  mv_scatter<G, K><<<viba::segment_blocks<G>(n_seg), kBlock, 0, st>>>(n_seg, n, ptr, obs, J, u,
                                                                     y);
  return cudaGetLastError();
}

template <int G, int DT>
cudaError_t launch_reduce(int n_seg, int n, int D, const int* ptr, const int* obs,
                          const float* contrib, float* y, cudaStream_t st) {
  const dim3 grid(viba::segment_blocks<G>(n_seg), (D + DT - 1) / DT);
  reduce_cols<G, DT><<<grid, kBlock, 0, st>>>(n_seg, n, D, ptr, obs, contrib, y);
  return cudaGetLastError();
}

// K13a down: q[s] = J^T u per slot (3 columns), slot-major float4 rows
__global__ void __launch_bounds__(256) jtu_slot_major(int n, const float* __restrict__ J,
                                                      const float* __restrict__ u,
                                                      float4* __restrict__ q) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const float u0 = u[s], u1 = u[n + s];
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = J[c * (long)n + s] * u0 + J[(3 + c) * (long)n + s] * u1;
  q[s] = make_float4(v[0], v[1], v[2], 0.f);
}

// K13a sum: one warp per row, the sum of the float4 rows of the row's slots
__global__ void __launch_bounds__(kBlock) reduce_gather4(int n_rows, const int* __restrict__ ptr,
                                                         const int* __restrict__ obs,
                                                         const float4* __restrict__ q,
                                                         float* __restrict__ y) {
  const int r = blockIdx.x * (kBlock / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool live = r < n_rows;
  const int beg = live ? ptr[r] : 0, end = live ? ptr[r + 1] : 0;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int j = beg + lane; j < end; j += 32) {
    const float4 v = q[obs[j]];
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
  }
  viba::group_sum<32, 3>(acc, nullptr);
  if (live && lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) y[3 * (long)r + i] = acc[i];
  }
}

}  // namespace

// dispatch on the threads per segment (16 or 128) and a compile-time width
#define VIBA_DISPATCH_GK(CALL, G, K, ARGS)                        \
  ((G) == 128 ? ((K) == 3   ? CALL<128, 3> ARGS                   \
                 : (K) == 6 ? CALL<128, 6> ARGS                   \
                 : (K) == 9 ? CALL<128, 9> ARGS                   \
                            : cudaErrorInvalidValue)              \
   : (G) == 16 ? ((K) == 3   ? CALL<16, 3> ARGS                   \
                  : (K) == 6 ? CALL<16, 6> ARGS                   \
                  : (K) == 9 ? CALL<16, 9> ARGS                   \
                             : cudaErrorInvalidValue)             \
               : cudaErrorInvalidValue)

extern "C" int viba_seg_mv_fused(int n_seg, int n_rows, int n, int k, int G, const int* ptr,
                                 const int* obs, const int* row, const int* row_chunk,
                                 const float* J, const float* w, const float* x, float* wu,
                                 float* part, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg <= 0) return 0;
  float* dst = first_pass_out(row_chunk, part, y);
  const cudaError_t err =
      VIBA_DISPATCH_GK(launch_fused, G, k, (n_seg, n, ptr, obs, row, J, w, x, wu, dst, st));
  return finish(err, n_rows, k, row_chunk, part, y, st);
}

extern "C" int viba_seg_mv_scatter(int n_seg, int n_rows, int n, int k, int G, const int* ptr,
                                   const int* obs, const int* row_chunk, const float* J,
                                   const float* u, float* part, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg <= 0) return 0;
  float* dst = first_pass_out(row_chunk, part, y);
  const cudaError_t err =
      VIBA_DISPATCH_GK(launch_scatter, G, k, (n_seg, n, ptr, obs, J, u, dst, st));
  return finish(err, n_rows, k, row_chunk, part, y, st);
}

extern "C" int viba_seg_mv_gather(int n, int k, const int* row, const float* J, const float* x,
                                  float* u, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int grid = (n + 255) / 256;
  if (k == 3) {
    mv_gather<3><<<grid, 256, 0, st>>>(n, row, J, x, u);
  } else if (k == 6) {
    mv_gather<6><<<grid, 256, 0, st>>>(n, row, J, x, u);
  } else if (k == 9) {
    mv_gather<9><<<grid, 256, 0, st>>>(n, row, J, x, u);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_seg_reduce(int n_seg, int n_rows, int n, int D, int G, const int* ptr,
                               const int* obs, const int* row_chunk, const float* contrib,
                               float* part, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg <= 0 || D <= 0) return 0;
  float* dst = first_pass_out(row_chunk, part, y);
  const int DT = column_tile(D);
  cudaError_t err = cudaErrorInvalidValue;
  if (G == 128) {
    err = DT == 3   ? launch_reduce<128, 3>(n_seg, n, D, ptr, obs, contrib, dst, st)
          : DT == 9 ? launch_reduce<128, 9>(n_seg, n, D, ptr, obs, contrib, dst, st)
                    : launch_reduce<128, 8>(n_seg, n, D, ptr, obs, contrib, dst, st);
  } else if (G == 16) {
    err = DT == 3   ? launch_reduce<16, 3>(n_seg, n, D, ptr, obs, contrib, dst, st)
          : DT == 9 ? launch_reduce<16, 9>(n_seg, n, D, ptr, obs, contrib, dst, st)
                    : launch_reduce<16, 8>(n_seg, n, D, ptr, obs, contrib, dst, st);
  }
  return finish(err, n_rows, D, row_chunk, part, y, st);
}

extern "C" int viba_seg_reduce_slot_major(int n_rows, int n, int D, const int* ptr,
                                          const int* obs, const float* contrib, float* sm,
                                          float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || D <= 0) return 0;
  const int DT = column_tile(D);
  const cudaError_t err =
      DT == 3   ? launch_slot_major<3>(n_rows, n, D, ptr, obs, contrib, sm, y, st)
      : DT == 9 ? launch_slot_major<9>(n_rows, n, D, ptr, obs, contrib, sm, y, st)
                : launch_slot_major<8>(n_rows, n, D, ptr, obs, contrib, sm, y, st);
  return static_cast<int>(err);
}

extern "C" int viba_seg_mv_scatter_slot_major(int n_rows, int n, const int* ptr,
                                              const int* obs, const float* J, const float* u,
                                              float* q, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  float4* q4 = reinterpret_cast<float4*>(q);
  if (n > 0) {
    jtu_slot_major<<<(n + 255) / 256, 256, 0, st>>>(n, J, u, q4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reduce_gather4<<<viba::segment_blocks<32>(n_rows), kBlock, 0, st>>>(n_rows, ptr, obs, q4, y);
  return static_cast<int>(cudaGetLastError());
}
