// K14a-e: tile-partials kernels over one grid of ragged tiles (the rig-sorted
// grid or the point-sorted second grid of a blocked visual batch).
//
// A grid has nt tiles of ts slots; slot s of tile t addresses row local[s]
// (0 <= local < rb) of the tile's rb-row window. Replaces the Pallas kernels
// of JAX ops/segments.py:
//   tile_reduce      partials (nt, rb, D) of contrib (D, N)  _seg_reduce_kernel :97   K14a
//   tile_gather      per-slot rows (N, D) of xt (nt, rb, D)  _seg_gather_kernel :135  K14b
//   tile_mv_fused    wu = w (J x_g); partials of J^T wu      _mv_fused_kernel   :170  K14c
//   tile_mv_gather   u = J x_g                               _mv_gather_kernel  :221  K14d
//   tile_mv_scatter  partials of J^T u                       _mv_scatter_kernel :249  K14e
// On the TPU each grid step built a (rb, ts) one-hot tile in VMEM and ran the
// selection as bf16-split MXU dots. Here a selection is an indexed load.
//
// Reduce side (K14a, K14c, K14e): one CTA per tile (column tile for K14a's
// wider rows); its warps own the tile's rows (warp w: rows w, w + 8, ...).
// A row's slots come from the grid's run list (ops/segments.tile_plan: the
// maximal runs of consecutive slots of each (tile, row), in slot order, built
// once on the device): the warp walks the runs in order, each lane summing
// the run slots j = lane, lane + 32, ... (consecutive lanes read consecutive
// slots, coalesced), then a fixed xor butterfly. The sum order is fixed, so
// the partials are the same bits on every call; each partial row is written
// once (zeros for a row no slot addresses), no atomics. Pad slots are slots
// like any other: they sum into their local row with whatever they carry.
// K14c loads the row's x once per row and writes wu for every slot of a run.
//
// Gather side (K14b, K14d): one CTA per tile stages the tile's (rb, D) rows
// of xt in shared memory (at most 48 KB: rb * D <= 12,288 floats), then its
// threads walk the tile's slots in order: out[s] = xt[t, local[s]] (0 for a local outside
// [0, rb)), or u = J x.
//
// Bound: bytes. K14c reads J (2k floats), w and writes wu (2) per slot; K14e
// reads J and u; K14d reads J, local and writes u; K14a reads D floats; K14b
// writes D floats per slot. The run lists add 12 bytes per run.
#include "tile_reduce.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

enum Mode { kReduce, kScatter, kFused };

// One CTA per tile. MODE kReduce: partials of contrib columns [col0, col0 +
// W) (W = DT, D columns in all); kScatter: partials of J^T u; kFused: wu =
// w (J x_row) per slot and partials of J^T wu.
template <int MODE, int K, int W>
__global__ void __launch_bounds__(kTileThreads) tile_reduce_rows(
    int rb, int n, int D, const int* __restrict__ run_ptr, const int* __restrict__ run_start,
    const int* __restrict__ run_len, const float* __restrict__ contrib,
    const float* __restrict__ J, const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ xt, float* __restrict__ wu, float* __restrict__ part) {
  const int t = blockIdx.x;
  const int col0 = blockIdx.y * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int width = MODE == kReduce ? D : K;
  for (int r = warp; r < rb; r += kTileWarps) {
    const long row = (long)t * rb + r;
    float acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.f;
    float xr[K];
    if constexpr (MODE == kFused) {
#pragma unroll
      for (int c = 0; c < K; ++c) xr[c] = xt[K * row + c];
    }
    const int q_end = run_ptr[row + 1];
    for (int q = run_ptr[row]; q < q_end; ++q) {
      const int s0 = run_start[q], len = run_len[q];
      for (int j = lane; j < len; j += 32) {
        const int s = s0 + j;
        if constexpr (MODE == kReduce) {
#pragma unroll
          for (int i = 0; i < W; ++i) {
            if (col0 + i < D) acc[i] += contrib[(col0 + i) * (long)n + s];
          }
        } else {
          float j0[K], j1[K];
#pragma unroll
          for (int c = 0; c < K; ++c) {
            j0[c] = J[c * (long)n + s];
            j1[c] = J[(K + c) * (long)n + s];
          }
          float u0, u1;
          if constexpr (MODE == kFused) {
            u0 = 0.f;
            u1 = 0.f;
#pragma unroll
            for (int c = 0; c < K; ++c) {
              u0 += j0[c] * xr[c];
              u1 += j1[c] * xr[c];
            }
            const float ws = w[s];
            u0 *= ws;
            u1 *= ws;
            wu[s] = u0;
            wu[n + s] = u1;
          } else {
            u0 = u[s];
            u1 = u[n + s];
          }
#pragma unroll
          for (int c = 0; c < K; ++c) acc[c] += j0[c] * u0 + j1[c] * u1;
        }
      }
    }
    viba::group_sum<32, W>(acc, nullptr);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (col0 + i < width) part[width * row + col0 + i] = acc[i];
      }
    }
  }
}

// One CTA per tile: stage xt[t] (rb, D) in shared memory, then per slot
// out (N, D) rows (K == 0) or u (2, N) = J x (K = 3, 6, 9).
template <int K>
__global__ void __launch_bounds__(kTileThreads) tile_gather_rows(
    int ts, int rb, int n, int D, const int* __restrict__ local, const float* __restrict__ J,
    const float* __restrict__ xt, float* __restrict__ out) {
  extern __shared__ float tile[];
  const int t = blockIdx.x;
  const float* src = xt + (long)t * rb * D;
  for (int i = threadIdx.x; i < rb * D; i += kTileThreads) tile[i] = src[i];
  __syncthreads();
  for (int j = threadIdx.x; j < ts; j += kTileThreads) {
    const long s = (long)t * ts + j;
    const int l = local[s];
    const bool ok = l >= 0 && l < rb;
    if constexpr (K == 0) {
      for (int d = 0; d < D; ++d) out[D * s + d] = ok ? tile[l * D + d] : 0.f;
    } else {
      float u0 = 0.f, u1 = 0.f;
      if (ok) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float xv = tile[l * K + c];
          u0 += J[c * (long)n + s] * xv;
          u1 += J[(K + c) * (long)n + s] * xv;
        }
      }
      out[s] = u0;
      out[n + s] = u1;
    }
  }
}

template <int MODE, int K, int W>
cudaError_t launch_reduce(int nt, int rb, int n, int D, const int* run_ptr, const int* run_start,
                          const int* run_len, const float* contrib, const float* J,
                          const float* w, const float* u, const float* xt, float* wu,
                          float* part, cudaStream_t st) {
  const dim3 grid(nt, MODE == kReduce ? (D + W - 1) / W : 1);
  tile_reduce_rows<MODE, K, W><<<grid, kTileThreads, 0, st>>>(
      rb, n, D, run_ptr, run_start, run_len, contrib, J, w, u, xt, wu, part);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_gather(int nt, int ts, int rb, int D, const int* local, const float* J,
                          const float* xt, float* out, cudaStream_t st) {
  const size_t smem = sizeof(float) * rb * D;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  tile_gather_rows<K><<<nt, kTileThreads, smem, st>>>(ts, rb, nt * ts, D, local, J, xt, out);
  return cudaGetLastError();
}

// dispatch on a compile-time Jacobian width
#define VIBA_DISPATCH_K(CALL, k, ARGS)              \
  ((k) == 3   ? CALL<3> ARGS                        \
   : (k) == 6 ? CALL<6> ARGS                        \
   : (k) == 9 ? CALL<9> ARGS                        \
              : cudaErrorInvalidValue)

template <int K>
cudaError_t launch_scatter_k(int nt, int rb, int n, const int* run_ptr, const int* run_start,
                             const int* run_len, const float* J, const float* u, float* part,
                             cudaStream_t st) {
  return launch_reduce<kScatter, K, K>(nt, rb, n, K, run_ptr, run_start, run_len, nullptr, J,
                                       nullptr, u, nullptr, nullptr, part, st);
}

template <int K>
cudaError_t launch_fused_k(int nt, int rb, int n, const int* run_ptr, const int* run_start,
                           const int* run_len, const float* J, const float* w, const float* xt,
                           float* wu, float* part, cudaStream_t st) {
  return launch_reduce<kFused, K, K>(nt, rb, n, K, run_ptr, run_start, run_len, nullptr, J, w,
                                     nullptr, xt, wu, part, st);
}

}  // namespace

extern "C" int viba_tile_reduce(int nt, int rb, int n, int D, const int* run_ptr,
                                const int* run_start, const int* run_len, const float* contrib,
                                float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0 || D <= 0) return 0;
  // column tile: 3 for narrow rows, 9 (the 3x3 landmark blocks) otherwise
  const cudaError_t err =
      D <= 3 ? launch_reduce<kReduce, 1, 3>(nt, rb, n, D, run_ptr, run_start, run_len, contrib,
                                            nullptr, nullptr, nullptr, nullptr, nullptr, part, st)
             : launch_reduce<kReduce, 1, 9>(nt, rb, n, D, run_ptr, run_start, run_len, contrib,
                                            nullptr, nullptr, nullptr, nullptr, nullptr, part, st);
  return static_cast<int>(err);
}

extern "C" int viba_tile_mv_scatter(int nt, int rb, int n, int k, const int* run_ptr,
                                    const int* run_start, const int* run_len, const float* J,
                                    const float* u, float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  return static_cast<int>(VIBA_DISPATCH_K(
      launch_scatter_k, k, (nt, rb, n, run_ptr, run_start, run_len, J, u, part, st)));
}

extern "C" int viba_tile_mv_fused(int nt, int rb, int n, int k, const int* run_ptr,
                                  const int* run_start, const int* run_len, const float* J,
                                  const float* w, const float* xt, float* wu, float* part,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  return static_cast<int>(VIBA_DISPATCH_K(
      launch_fused_k, k, (nt, rb, n, run_ptr, run_start, run_len, J, w, xt, wu, part, st)));
}

extern "C" int viba_tile_gather(int nt, int ts, int rb, int D, const int* local, const float* xt,
                                float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0 || D <= 0) return 0;
  return static_cast<int>(launch_gather<0>(nt, ts, rb, D, local, nullptr, xt, out, st));
}

extern "C" int viba_tile_mv_gather(int nt, int ts, int rb, int k, const int* local,
                                   const float* J, const float* xt, float* u, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  return static_cast<int>(
      VIBA_DISPATCH_K(launch_gather, k, (nt, ts, rb, k, local, J, xt, u, st)));
}
