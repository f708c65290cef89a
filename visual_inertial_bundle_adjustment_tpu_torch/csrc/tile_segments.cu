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
// Reduce side (K14a, K14c): one CTA per tile (column tile for K14a's wider
// rows); its warps own the tile's rows (warp w: rows w, w + 8, ...). A row's
// slots come from the grid's run list (ops/segments.tile_plan: the maximal
// runs of consecutive slots of each (tile, row), in slot order, built once on
// the device): the warp walks the runs in order, each lane summing the run
// slots j = lane, lane + 32, ... (consecutive lanes read consecutive slots,
// coalesced), then a fixed xor butterfly. The sum order is fixed, so the
// partials are the same bits on every call; each partial row is written once
// (zeros for a row no slot addresses), no atomics. Pad slots are slots like
// any other: they sum into their local row with whatever they carry. K14c
// loads the row's x once per row and writes wu for every slot of a run.
//
// K14e (tile_scatter_staged): one CTA per tile, parallel over slots, not
// rows. A grid's busy rows are few and long (the point-sorted grid: ~9 of a
// tile's 128 rows hold its 4,096 slots; the rig grid: 1-3), so a warp per
// row left most warps idle behind chains of dependent loads. Here the CTA
// loads the tile's run list once (coalesced, into shared memory), then per
// chunk of the tile's slots all 256 threads stream J and u (coalesced) and
// stage c_s = J_s^T u_s in shared memory. Each row's slots, its runs
// concatenated in slot order, are cut into pieces of kPiece at fixed
// offsets from the row's start; piece i of row r goes to warp (r + i) % 8,
// so every warp sums a similar number of slots. A warp's lanes sum its
// pieces of a row (within a run, lane j takes the run's slots j, j + 32,
// ...), a butterfly gives the warp's total, which is added to the warp's
// partial of that row (chunk by chunk, in order); the row's partial is the
// sum of the 8 warps' partials in warp order, stored once (zeros for a row
// no slot addresses). Fixed order, no atomics: the same bits every call.
// Each choice measured against its undoing (tile_variants.py, one H100 80GB
// HBM3 at 700 W, device ms in turns, point grid k 3 / rig grid k 6; kept
// 0.0434 / 0.0781): chunks of 48 KB, not 24 or 12 KB (0.0435 / 0.0871,
// 0.0477 / 0.1178: a CTA's loads stop while it sums its chunk); a minimum of
// three CTAs an SM asked of ptxas (80 registers; without it ptxas chose 64
// and spilled, 0.0481 / 0.0817, or with fewer slots in flight did not,
// 0.0445 / 0.0803); pieces of 512 slots, not 256 or 128 (0.0446 / 0.0795,
// 0.0471 / 0.0806); a run cache of 128, not 256 (0.0436 / 0.0815: at k 6
// three CTAs then fit an SM's shared memory).
//
// Gather side: K14b (tile_gather_flat) writes out (N, D) as one flat stream
// of float4 stores over its N*D floats, with no tile structure: each thread
// derives the slot (f / D), column and tile (slot / ts) of each of its
// floats, reads local through the read-only path and xt (1.2 MB at the
// profile's size) straight from the L2, on a grid sized to the card's
// resident blocks; one float4 a thread per step (30 registers: loops that
// loaded 2, 4 or 8 float4 before storing them were slower in trials on the
// same card). K14d: one CTA per tile stages the tile's (rb, k) rows
// of xt in shared memory, then its threads walk the tile's slots: u = J x (0
// for a local outside [0, rb)).
//
// Bound: bytes. K14c reads J (2k floats), w and writes wu (2) per slot; K14e
// reads J and u; K14d reads J, local and writes u; K14a reads D floats; K14b
// reads local and writes D floats per slot. The run lists add 12 bytes per
// run.
//
// The designs K14b and K14e replaced, kept as chip_smoke.py's yardsticks and
// reached by nothing else: viba_tile_gather_v1 (tile_gather_rows<0>: a CTA
// per tile staging xt in shared memory, a thread walking 16 slots, D scalar
// stores a slot) and viba_tile_mv_scatter_v1 (tile_reduce_rows<kScatter>: a
// warp per row walking its runs).
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

// ---------------------------------------------------------------------------
// K14b: the flat gather
// ---------------------------------------------------------------------------

// out[f] of the flat (N, D) output: row local[slot] of the slot's tile, 0
// for a local outside [0, rb). Indices are 32-bit (N D < 2^31, checked by
// the entry) so that the divisions are.
__device__ __forceinline__ float gather_one(unsigned f, unsigned D, unsigned ts, int rb,
                                            const int* __restrict__ local,
                                            const float* __restrict__ xt) {
  const unsigned slot = f / D, col = f - slot * D;
  const int l = __ldg(local + slot);
  const long row = (long)(slot / ts) * rb + l;
  return static_cast<unsigned>(l) < static_cast<unsigned>(rb) ? __ldg(xt + row * D + col) : 0.f;
}

// DT: a compile-time width (3), or 0 for the width d_rt given at run time.
// Thread i writes float4 i, i + T, i + 2T, ... of the flat output (T threads
// in the grid); the last nf % 4 floats are written one by one.
template <int DT>
__global__ void __launch_bounds__(kTileThreads) tile_gather_flat(
    unsigned nf, unsigned ts, int rb, unsigned d_rt, const int* __restrict__ local,
    const float* __restrict__ xt, float* __restrict__ out) {
  const unsigned D = DT > 0 ? DT : d_rt;
  const unsigned nv = nf / 4;
  const unsigned T = gridDim.x * kTileThreads;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (unsigned v = blockIdx.x * kTileThreads + threadIdx.x; v < nv; v += T) {
    const unsigned f = 4 * v;
    float e[4];
    if (D >= 3) {  // the 4 floats span at most two slots, a and a + 1
      const unsigned sa = f / D, ca = f - sa * D;
      const int la = __ldg(local + sa), lb = ca + 3 >= D ? __ldg(local + sa + 1) : la;
      const float* ra = xt + ((long)(sa / ts) * rb + la) * D;
      const float* rb1 = xt + ((long)((sa + 1) / ts) * rb + lb) * D;
      const bool oka = static_cast<unsigned>(la) < static_cast<unsigned>(rb);
      const bool okb = static_cast<unsigned>(lb) < static_cast<unsigned>(rb);
#pragma unroll
      for (unsigned i = 0; i < 4; ++i) {
        const unsigned c = ca + i;
        e[i] = c < D ? (oka ? __ldg(ra + c) : 0.f) : (okb ? __ldg(rb1 + c - D) : 0.f);
      }
    } else {
#pragma unroll
      for (unsigned i = 0; i < 4; ++i) e[i] = gather_one(f + i, D, ts, rb, local, xt);
    }
    out4[v] = make_float4(e[0], e[1], e[2], e[3]);
  }
  if (blockIdx.x == 0 && threadIdx.x < nf - 4 * nv) {
    out[4 * nv + threadIdx.x] = gather_one(4 * nv + threadIdx.x, D, ts, rb, local, xt);
  }
}

// ---------------------------------------------------------------------------
// K14e: J^T u staged a chunk at a time, rows cut into pieces across warps
// ---------------------------------------------------------------------------

constexpr int kPiece = 512;          // slots of a row one warp sums at a time
constexpr int kRunCache = 128;       // runs of a tile kept in shared memory
constexpr int kStageFloats = 12288;  // staged J^T u per chunk: 48 KB
constexpr int kScatterBlocks = 3;    // CTAs an SM holds at k 3 and 6 (shared memory)

// Slots of the tile staged at a time: kStageFloats / K, a multiple of 32,
// at most ts.
inline int scatter_chunk(int K, int ts) {
  const int c = kStageFloats / K / 32 * 32;
  return c < ts ? c : ts;
}

// shared bytes: staged chunk (K, chunk), warp partials (8, rb, K), row run
// offsets (rb + 1), row sizes (rb), the cached runs' starts and lengths
inline size_t scatter_smem(int K, int chunk, int rb) {
  return sizeof(float) * ((size_t)K * chunk + (size_t)kTileWarps * rb * K) +
         sizeof(int) * (2 * (size_t)rb + 1 + 2 * kRunCache);
}

template <int K>
__global__ void __launch_bounds__(kTileThreads, kScatterBlocks) tile_scatter_staged(
    int rb, int ts, int chunk, long n, const int* __restrict__ run_ptr,
    const int* __restrict__ run_start, const int* __restrict__ run_len,
    const float* __restrict__ J, const float* __restrict__ u, float* __restrict__ part) {
  constexpr int kUnroll = K <= 3 ? 4 : (K <= 6 ? 2 : 1);  // slots staged in flight a thread
  extern __shared__ float smem[];
  float* cs = smem;                            // (K, chunk) c_s of the chunk's slots
  float* pp = cs + K * chunk;                  // (8, rb, K) each warp's partial of each row
  int* s_ptr = reinterpret_cast<int*>(pp + kTileWarps * rb * K);  // (rb + 1) run offsets
  int* s_n = s_ptr + rb + 1;                   // (rb) slots of each row
  int* s_rs = s_n + rb;                        // (kRunCache) tile-local run starts
  int* s_rl = s_rs + kRunCache;                // (kRunCache) run lengths
  const int t = blockIdx.x;
  const long slot0 = (long)t * ts;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* ptr = run_ptr + (long)t * rb;
  const int q0 = ptr[0];
  const int n_runs = ptr[rb] - q0;
  for (int i = threadIdx.x; i <= rb; i += kTileThreads) s_ptr[i] = ptr[i] - q0;
  for (int i = threadIdx.x; i < n_runs && i < kRunCache; i += kTileThreads) {
    s_rs[i] = static_cast<int>(run_start[q0 + i] - slot0);
    s_rl[i] = run_len[q0 + i];
  }
  for (int i = threadIdx.x; i < kTileWarps * rb * K; i += kTileThreads) pp[i] = 0.f;
  __syncthreads();
  // run q of the tile (0-based): from shared memory, past the cache from L2
  auto run_at = [&](int q, int& start, int& len) {
    if (q < kRunCache) {
      start = s_rs[q];
      len = s_rl[q];
    } else {
      start = static_cast<int>(__ldg(run_start + q0 + q) - slot0);
      len = __ldg(run_len + q0 + q);
    }
  };
  for (int r = threadIdx.x; r < rb; r += kTileThreads) {
    int total = 0;
    for (int q = s_ptr[r]; q < s_ptr[r + 1]; ++q) {
      int st, len;
      run_at(q, st, len);
      total += len;
    }
    s_n[r] = total;  // read after the first chunk's barrier
  }
  for (int c0 = 0; c0 < ts; c0 += chunk) {
    const int cn = min(chunk, ts - c0);
    // stage c_s = J_s^T u_s of slots c0 .. c0 + cn: coalesced loads, kUnroll
    // slots loaded before any is stored
    for (int j0 = threadIdx.x; j0 < cn; j0 += kTileThreads * kUnroll) {
      float jv[kUnroll][2 * K], uv[kUnroll][2];
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int j = j0 + m * kTileThreads;
        if (j < cn) {
          const long s = slot0 + c0 + j;
          uv[m][0] = u[s];
          uv[m][1] = u[n + s];
#pragma unroll
          for (int c = 0; c < 2 * K; ++c) jv[m][c] = J[c * n + s];
        }
      }
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int j = j0 + m * kTileThreads;
        if (j < cn) {
#pragma unroll
          for (int c = 0; c < K; ++c) {
            cs[c * chunk + j] = jv[m][c] * uv[m][0] + jv[m][K + c] * uv[m][1];
          }
        }
      }
    }
    __syncthreads();
    // the rows with slots, 32 at a time; piece i of row r belongs to warp
    // (r + i) % 8
    for (int r0 = 0; r0 < rb; r0 += 32) {
      const int nr = r0 + lane < rb ? s_n[r0 + lane] : 0;
      unsigned todo = __ballot_sync(0xffffffffu, nr > 0);
      while (todo) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        const int row = r0 + b, n_row = __shfl_sync(0xffffffffu, nr, b);
        int i = ((warp - row) % kTileWarps + kTileWarps) % kTileWarps;
        if (i * kPiece >= n_row) continue;
        float acc[K];
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = 0.f;
        // walk the row's runs: run q holds row positions [a, a + len), its
        // slots st .. st + len (tile-local)
        int q = s_ptr[row], a = 0, st, len;
        run_at(q, st, len);
        for (; i * kPiece < n_row; i += kTileWarps) {
          const int lo = i * kPiece, hi = min(lo + kPiece, n_row);
          while (a + len <= lo) {
            a += len;
            run_at(++q, st, len);
          }
          int qq = q, aa = a, ss = st, ll = len;
          for (;;) {  // the runs overlapping [lo, hi), clipped to the chunk
            const int x_lo = max(max(lo, aa), aa + c0 - ss);
            const int x_hi = min(min(hi, aa + ll), aa + c0 + cn - ss);
            for (int x = x_lo + lane; x < x_hi; x += 32) {
              const int sl = ss + x - aa - c0;
#pragma unroll
              for (int c = 0; c < K; ++c) acc[c] += cs[c * chunk + sl];
            }
            if (aa + ll >= hi) break;
            aa += ll;
            run_at(++qq, ss, ll);
          }
        }
        viba::group_sum<32, K>(acc, nullptr);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < K; ++c) pp[(warp * rb + row) * K + c] += acc[c];
        }
      }
    }
    __syncthreads();
  }
  // each row's partial: the warps' partials in warp order, one coalesced store
  float* out = part + (long)t * rb * K;
  for (int e = threadIdx.x; e < rb * K; e += kTileThreads) {
    float v = pp[e];
#pragma unroll
    for (int w = 1; w < kTileWarps; ++w) v += pp[w * rb * K + e];
    out[e] = v;
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

template <int K>
cudaError_t launch_scatter_staged(int nt, int rb, int n, const int* run_ptr, const int* run_start,
                                  const int* run_len, const float* J, const float* u, float* part,
                                  cudaStream_t st) {
  const int ts = n / nt, chunk = scatter_chunk(K, ts);
  const size_t smem = scatter_smem(K, chunk, rb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_scatter_staged<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  tile_scatter_staged<K><<<nt, kTileThreads, smem, st>>>(rb, ts, chunk, n, run_ptr, run_start,
                                                          run_len, J, u, part);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_gather_flat(long nf, int ts, int rb, int D, const int* local, const float* xt,
                               float* out, cudaStream_t st) {
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_gather_flat<DT>,
                                                          kTileThreads, 0);
    }
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const long need = (nf / 4 + kTileThreads - 1) / kTileThreads;
  const int grid = static_cast<int>(need < 1 ? 1 : (need < resident ? need : resident));
  tile_gather_flat<DT><<<grid, kTileThreads, 0, st>>>(static_cast<unsigned>(nf), ts, rb, D, local,
                                                      xt, out);
  return cudaGetLastError();
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
  if (n % nt != 0 || scatter_smem(k, scatter_chunk(k, n / nt), rb) > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(VIBA_DISPATCH_K(
      launch_scatter_staged, k, (nt, rb, n, run_ptr, run_start, run_len, J, u, part, st)));
}

// K14e's design before (a warp per row walking its runs): chip_smoke.py's
// yardstick
extern "C" int viba_tile_mv_scatter_v1(int nt, int rb, int n, int k, const int* run_ptr,
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
  const long nf = (long)nt * ts * D;
  if (nf >= (1L << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // the profile's width (its landmark step) at compile time, any other at run time
  return static_cast<int>(D == 3 ? launch_gather_flat<3>(nf, ts, rb, D, local, xt, out, st)
                                 : launch_gather_flat<0>(nf, ts, rb, D, local, xt, out, st));
}

// K14b's design before (a CTA per tile staging xt in shared memory):
// chip_smoke.py's yardstick
extern "C" int viba_tile_gather_v1(int nt, int ts, int rb, int D, const int* local,
                                   const float* xt, float* out, void* stream) {
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
