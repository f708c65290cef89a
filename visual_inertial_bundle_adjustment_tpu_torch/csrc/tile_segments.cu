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
// Reduce side (K14a, K14c, K14e): one pass, tile_pass<W, Stage>, one CTA per
// tile (and per column tile of K14a's wider rows), parallel over slots, not
// rows. A grid's busy rows are few and long (the point-sorted grid: ~9 of a
// tile's 128 rows hold its 4,096 slots; the rig grid: 1-3), so a warp per
// row left most warps idle behind chains of dependent loads. The slots of a
// (tile, row) come from the grid's run list (ops/segments.tile_plan: the
// maximal runs of consecutive slots of each (tile, row), in slot order,
// built once on the device), which the CTA loads once (coalesced, into
// shared memory). Per chunk of the tile's slots, a stage fills W per-slot
// columns cs (W, chunk) in shared memory, all 256 threads loading coalesced:
//   K14e  tile_scatter_staged<K>  cs = J_s^T u_s
//   K14c  tile_fused_staged<K>    wu_s = w_s (J_s x_row) stored for every
//                                 slot (x_row = 0 for a local outside
//                                 [0, rb), so wu = 0 there, no memset),
//                                 cs = J_s^T wu_s
//   K14a  tile_reduce_split<W>    contrib's columns [col0, col0 + W) read
//                                 straight from global memory inside the
//                                 piece walk (kReduceDirect: no chunk, no
//                                 stage, no barrier between them), four
//                                 32-slot steps loaded a lane before any is
//                                 added
// Each row's slots, its runs concatenated in slot order, are cut into pieces
// of kPiece (K14a: kReducePiece) at fixed offsets from the row's start;
// piece i of row r goes to warp (r + i) % 8, so every warp sums a similar
// number of slots. A warp's lanes sum its pieces of a row (within a run,
// lane j takes the run's slots j, j + 32, ...), a butterfly gives the warp's
// total, which is added to the warp's partial of that row (chunk by chunk,
// in order); the row's partial is the sum of the 8 warps' partials in warp
// order, stored once (zeros for a row no slot addresses). Fixed order, no
// atomics: the same bits every call.
// Pad slots are slots like any other: they sum into their local row with
// whatever they carry.
//
// Each choice measured against its undoing (tile_variants.py, one H100 80GB
// HBM3 at 700 W, device ms in turns). K14e (point grid k 3 / rig grid k 6;
// kept 0.0434 / 0.0781): chunks of 48 KB, not 24 or 12 KB (0.0435 / 0.0871,
// 0.0477 / 0.1178: a CTA's loads stop while it sums its chunk); a minimum of
// three CTAs an SM asked of ptxas (80 registers; without it ptxas chose 64
// and spilled, 0.0481 / 0.0817, or with fewer slots in flight did not,
// 0.0445 / 0.0803); pieces of 512 slots, not 256 or 128 (0.0446 / 0.0795,
// 0.0471 / 0.0806); a run cache of 128, not 256 (0.0436 / 0.0815: at k 6
// three CTAs then fit an SM's shared memory). K14a (point grid D 9; kept
// 0.0515): contrib read in the piece walk, not staged (0.1167: two CTAs an
// SM); four 32-slot steps in flight a lane at three CTAs an SM (80
// registers), not one (0.0611), two at four CTAs (0.0570), eight at two
// (spilled, 0.0811) or four at four (spilled, 0.0926); pieces of 128, not
// 512, 256 or 64 (0.0532, 0.0529, 0.0566). K14c (rig grid k 6; kept
// 0.0904): x_row from xt through the L2, not staged in shared memory
// (0.0925); each slot's row from local, not a table expanded from the run
// list (0.0913); three CTAs an SM asked of ptxas (without: 0.0926).
//
// Gather side: K14b (tile_gather_flat) writes out (N, D) as one flat stream
// of float4 stores over its N*D floats, with no tile structure: each thread
// derives the slot (f / D), column and tile (slot / ts) of each of its
// floats, reads local through the read-only path and xt (1.2 MB at the
// profile's size) straight from the L2, on a grid sized to the card's
// resident blocks; one float4 a thread per step (30 registers: loops that
// loaded 2, 4 or 8 float4 before storing them were slower in trials on the
// same card). K14d (tile_gather_rows): one CTA per tile stages the tile's
// (rb, k) rows of xt in shared memory, then its threads walk the tile's
// slots: u = J x (0 for a local outside [0, rb)).
//
// Bound: bytes. K14c reads J (2k floats), w and writes wu (2) per slot, and
// xt; K14e reads J and u; K14d reads J, local and writes u; K14a reads D
// floats; K14b reads local and writes D floats per slot. The run lists add
// 12 bytes per run.
#include "tile_reduce.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

// One CTA per tile (K14d): stage xt[t] (rb, K) in shared memory, then per
// slot u (2, N) = J x.
template <int K>
__global__ void __launch_bounds__(kTileThreads) tile_gather_rows(
    int ts, int rb, int n, const int* __restrict__ local, const float* __restrict__ J,
    const float* __restrict__ xt, float* __restrict__ out) {
  extern __shared__ float tile[];
  const int t = blockIdx.x;
  const float* src = xt + (long)t * rb * K;
  for (int i = threadIdx.x; i < rb * K; i += kTileThreads) tile[i] = src[i];
  __syncthreads();
  for (int j = threadIdx.x; j < ts; j += kTileThreads) {
    const long s = (long)t * ts + j;
    const int l = local[s];
    float u0 = 0.f, u1 = 0.f;
    if (l >= 0 && l < rb) {
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
// K14a, K14c, K14e: one tile pass, a stage per kernel
// ---------------------------------------------------------------------------

constexpr int kPiece = 512;          // slots of a row one warp sums at a time
constexpr int kRunCache = 128;       // runs of a tile kept in shared memory
constexpr int kStageFloats = 12288;  // staged values per chunk: 48 KB
constexpr int kScatterBlocks = 3;    // K14e: CTAs an SM holds at k 3 and 6 (shared memory)
constexpr int kFusedBlocks = 3;      // K14c: the same shared memory as K14e
// K14a reads contrib inside the piece walk (no staged chunk): its warp
// partials alone take 36 KB at D 9, rb 128. The walk is bound by the
// latency of its loads, so a lane loads kReduceFlight 32-slot steps of a
// piece before it adds them (in slot order, as one step at a time); four
// steps take 80 registers, three CTAs an SM (a cap of 64 or 48 spills), and
// its pieces are shorter than K14e's (more warps on a row)
constexpr bool kReduceDirect = true;
constexpr int kReduceBlocks = kReduceDirect ? 3 : 2;
constexpr int kReducePiece = 128;
constexpr int kReduceFlight = 4;
// K14c: x_row read from xt through the L2 (xt is 2.3 MB at the profile's
// size), not staged in shared memory; each slot's row from local[s], not
// from a per-slot table expanded from the run list in shared memory
constexpr bool kFusedXtShared = false;
constexpr bool kFusedRowTable = false;
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a CTA may use

// Slots of the tile staged at a time: kStageFloats / W, a multiple of 32,
// at most ts.
inline int stage_chunk(int W, int ts) {
  const int c = kStageFloats / W / 32 * 32;
  return c < ts ? c : ts;
}

// shared bytes of a tile pass: the staged chunk (W, staged slots), warp
// partials (8, rb, W), row run offsets (rb + 1), row sizes (rb), the cached
// runs' starts and lengths, then the stage's own
inline size_t tile_smem(int W, int staged, int rb, size_t extra) {
  return sizeof(float) * ((size_t)W * staged + (size_t)kTileWarps * rb * W) +
         sizeof(int) * (2 * (size_t)rb + 1 + 2 * kRunCache) + extra;
}

// The stages. Each fills cs (W, chunk) for the chunk's cn slots s0 .. s0 +
// cn (s0 the chunk's first slot; tile-local slot c0 + j), all threads,
// coalesced, a few slots loaded before any is stored. A direct stage
// instead hands the walk each value from global memory (direct()).

// K14e: c_s = J_s^T u_s
template <int K>
struct ScatterStage {
  static constexpr bool kDirect = false, kRowTable = false;
  static constexpr int kXsFloats = 0, kRowPiece = kPiece;
  const float* J;
  const float* u;
  long n;
  static size_t extra_bytes(int, int) { return 0; }
  __device__ void prologue(float*, short*, int, int, int) const {}
  __device__ void stage(float* cs, int chunk, long s0, int, int cn, int, int, const float*,
                        const short*) const {
    constexpr int kUnroll = K <= 3 ? 4 : (K <= 6 ? 2 : 1);  // slots staged in flight a thread
    for (int j0 = threadIdx.x; j0 < cn; j0 += kTileThreads * kUnroll) {
      float jv[kUnroll][2 * K], uv[kUnroll][2];
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int j = j0 + m * kTileThreads;
        if (j < cn) {
          const long s = s0 + j;
          uv[m][0] = __ldg(u + s);
          uv[m][1] = __ldg(u + n + s);
#pragma unroll
          for (int c = 0; c < 2 * K; ++c) jv[m][c] = __ldg(J + c * n + s);
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
  }
};

// K14c: wu_s = w_s (J_s x_row), stored for every slot; c_s = J_s^T wu_s
template <int K>
struct FusedStage {
  static constexpr bool kDirect = false, kRowTable = kFusedRowTable;
  static constexpr int kXsFloats = kFusedXtShared ? K : 0;  // per row of the window
  static constexpr int kRowPiece = kPiece;
  const float* J;
  const float* w;
  const float* xt;
  const int* local;
  float* wu;
  long n;
  static size_t extra_bytes(int rb, int ts) {
    return sizeof(float) * kXsFloats * (size_t)rb + (kRowTable ? sizeof(short) * ts : 0);
  }
  // before the first barrier: xt[t] into xs, or the row table cleared
  __device__ void prologue(float* xs, short* s_row, int t, int rb, int ts) const {
    if constexpr (kFusedXtShared) {
      const float* src = xt + (long)t * rb * K;
      for (int i = threadIdx.x; i < rb * K; i += kTileThreads) xs[i] = __ldg(src + i);
    }
    if constexpr (kRowTable) {
      for (int i = threadIdx.x; i < ts; i += kTileThreads) s_row[i] = -1;
    }
  }
  __device__ void stage(float* cs, int chunk, long s0, int c0, int cn, int t, int rb,
                        const float* xs, const short* s_row) const {
    constexpr int kFlight = K <= 3 ? 4 : (K <= 6 ? 2 : 1);  // slots loaded before any is stored
    for (int j0 = threadIdx.x; j0 < cn; j0 += kTileThreads * kFlight) {
      float jv[kFlight][2 * K], wv[kFlight];
      int lv[kFlight];
#pragma unroll
      for (int m = 0; m < kFlight; ++m) {
        const int j = j0 + m * kTileThreads;
        if (j < cn) {
          const long s = s0 + j;
          if constexpr (kRowTable) {
            lv[m] = s_row[c0 + j];
          } else {
            lv[m] = __ldg(local + s);
          }
          wv[m] = __ldg(w + s);
#pragma unroll
          for (int c = 0; c < 2 * K; ++c) jv[m][c] = __ldg(J + c * n + s);
        }
      }
#pragma unroll
      for (int m = 0; m < kFlight; ++m) {
        const int j = j0 + m * kTileThreads;
        if (j < cn) {
          const long s = s0 + j;
          const bool ok = static_cast<unsigned>(lv[m]) < static_cast<unsigned>(rb);
          float u0 = 0.f, u1 = 0.f;
#pragma unroll
          for (int c = 0; c < K; ++c) {
            float xv = 0.f;  // outside the window the gathered row is 0
            if (ok) {
              if constexpr (kFusedXtShared) {
                xv = xs[lv[m] * K + c];
              } else {
                xv = __ldg(xt + ((long)t * rb + lv[m]) * K + c);
              }
            }
            u0 += jv[m][c] * xv;
            u1 += jv[m][K + c] * xv;
          }
          u0 *= wv[m];
          u1 *= wv[m];
          wu[s] = u0;
          wu[n + s] = u1;
#pragma unroll
          for (int c = 0; c < K; ++c) cs[c * chunk + j] = jv[m][c] * u0 + jv[m][K + c] * u1;
        }
      }
    }
  }
};

// K14a: contrib's columns [col0, col0 + W), 0 past D
template <int W>
struct ReduceStage {
  static constexpr bool kDirect = kReduceDirect, kRowTable = false;
  static constexpr int kXsFloats = 0, kRowPiece = kReducePiece, kFlight = kReduceFlight;
  const float* contrib;
  long n;
  int D, col0;
  static size_t extra_bytes(int, int) { return 0; }
  __device__ void prologue(float*, short*, int, int, int) const {}
  __device__ float direct(int c, long s) const {
    return col0 + c < D ? __ldg(contrib + (col0 + c) * n + s) : 0.f;
  }
  __device__ void stage(float* cs, int chunk, long s0, int, int cn, int, int, const float*,
                        const short*) const {
    constexpr int kUnroll = W <= 3 ? 4 : 1;  // slots staged in flight a thread
    for (int j0 = threadIdx.x; j0 < cn; j0 += kTileThreads * kUnroll) {
      float v[kUnroll][W];
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int j = j0 + m * kTileThreads;
        if (j < cn) {
#pragma unroll
          for (int c = 0; c < W; ++c) v[m][c] = direct(c, s0 + j);
        }
      }
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int j = j0 + m * kTileThreads;
        if (j < cn) {
#pragma unroll
          for (int c = 0; c < W; ++c) cs[c * chunk + j] = v[m][c];
        }
      }
    }
  }
};

// The pass over tile blockIdx.x: partials of W columns, stored into columns
// [col0, col0 + W) of the (nt, rb, D) output (those below D).
template <int W, class Stage>
__device__ __forceinline__ void tile_pass(const Stage& stage, int D, int col0, int rb, int ts,
                                          int chunk, long n, const int* __restrict__ run_ptr,
                                          const int* __restrict__ run_start,
                                          const int* __restrict__ run_len,
                                          float* __restrict__ part) {
  extern __shared__ float smem[];
  float* cs = smem;                                     // (W, chunk) staged values of the chunk
  float* pp = cs + (Stage::kDirect ? 0 : W * chunk);    // (8, rb, W) warp partials of each row
  int* s_ptr = reinterpret_cast<int*>(pp + kTileWarps * rb * W);  // (rb + 1) run offsets
  int* s_n = s_ptr + rb + 1;                            // (rb) slots of each row
  int* s_rs = s_n + rb;                                 // (kRunCache) tile-local run starts
  int* s_rl = s_rs + kRunCache;                         // (kRunCache) run lengths
  float* xs = reinterpret_cast<float*>(s_rl + kRunCache);          // the stage's (rb, kXsFloats)
  short* s_row = reinterpret_cast<short*>(xs + Stage::kXsFloats * rb);  // (ts) row of each slot
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
  for (int i = threadIdx.x; i < kTileWarps * rb * W; i += kTileThreads) pp[i] = 0.f;
  stage.prologue(xs, s_row, t, rb, ts);
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
  if constexpr (Stage::kRowTable) {  // each run's slots get its row (warp w: rows w, w + 8, ...)
    for (int r = warp; r < rb; r += kTileWarps) {
      for (int q = s_ptr[r]; q < s_ptr[r + 1]; ++q) {
        int st, len;
        run_at(q, st, len);
        for (int j = lane; j < len; j += 32) s_row[st + j] = static_cast<short>(r);
      }
    }
    __syncthreads();
  }
  for (int c0 = 0; c0 < ts; c0 += chunk) {
    const int cn = min(chunk, ts - c0);
    if constexpr (!Stage::kDirect) stage.stage(cs, chunk, slot0 + c0, c0, cn, t, rb, xs, s_row);
    __syncthreads();  // the staged chunk, and at the first chunk s_n, ready
    // the rows with slots, 32 at a time; piece i of row r belongs to warp
    // (r + i) % 8
    for (int r0 = 0; r0 < rb; r0 += 32) {
      const int nr = r0 + lane < rb ? s_n[r0 + lane] : 0;
      unsigned todo = __ballot_sync(0xffffffffu, nr > 0);
      while (todo) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        const int row = r0 + b, n_row = __shfl_sync(0xffffffffu, nr, b);
        constexpr int kP = Stage::kRowPiece;
        int i = ((warp - row) % kTileWarps + kTileWarps) % kTileWarps;
        if (i * kP >= n_row) continue;
        float acc[W];
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] = 0.f;
        // walk the row's runs: run q holds row positions [a, a + len), its
        // slots st .. st + len (tile-local)
        int q = s_ptr[row], a = 0, st, len;
        run_at(q, st, len);
        for (; i * kP < n_row; i += kTileWarps) {
          const int lo = i * kP, hi = min(lo + kP, n_row);
          while (a + len <= lo) {
            a += len;
            run_at(++q, st, len);
          }
          int qq = q, aa = a, ss = st, ll = len;
          for (;;) {  // the runs overlapping [lo, hi), clipped to the chunk
            const int x_lo = max(max(lo, aa), aa + c0 - ss);
            const int x_hi = min(min(hi, aa + ll), aa + c0 + cn - ss);
            if constexpr (Stage::kDirect) {  // kFlight steps loaded, then added in order
              constexpr int F = Stage::kFlight;
              for (int x = x_lo + lane; x < x_hi; x += 32 * F) {
                float v[F][W];
#pragma unroll
                for (int f = 0; f < F; ++f) {
                  const long s = slot0 + ss + x + 32 * f - aa;
#pragma unroll
                  for (int c = 0; c < W; ++c) {
                    v[f][c] = x + 32 * f < x_hi ? stage.direct(c, s) : 0.f;
                  }
                }
#pragma unroll
                for (int f = 0; f < F; ++f) {
                  if (x + 32 * f < x_hi) {
#pragma unroll
                    for (int c = 0; c < W; ++c) acc[c] += v[f][c];
                  }
                }
              }
            } else {
              for (int x = x_lo + lane; x < x_hi; x += 32) {
                const int sl = ss + x - aa - c0;
#pragma unroll
                for (int c = 0; c < W; ++c) acc[c] += cs[c * chunk + sl];
              }
            }
            if (aa + ll >= hi) break;
            aa += ll;
            run_at(++qq, ss, ll);
          }
        }
        viba::group_sum<32, W>(acc, nullptr);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < W; ++c) pp[(warp * rb + row) * W + c] += acc[c];
        }
      }
    }
    __syncthreads();
  }
  // each row's partial: the warps' partials in warp order, one coalesced store
  float* out = part + (long)t * rb * D;
  for (int e = threadIdx.x; e < rb * W; e += kTileThreads) {
    float v = pp[e];
#pragma unroll
    for (int w = 1; w < kTileWarps; ++w) v += pp[w * rb * W + e];
    const int r = e / W, c = e - r * W;
    if (col0 + c < D) out[r * D + col0 + c] = v;
  }
}

template <int K>
__global__ void __launch_bounds__(kTileThreads, kScatterBlocks) tile_scatter_staged(
    int rb, int ts, int chunk, long n, const int* __restrict__ run_ptr,
    const int* __restrict__ run_start, const int* __restrict__ run_len,
    const float* __restrict__ J, const float* __restrict__ u, float* __restrict__ part) {
  tile_pass<K>(ScatterStage<K>{J, u, n}, K, 0, rb, ts, chunk, n, run_ptr, run_start, run_len,
               part);
}

template <int K>
__global__ void __launch_bounds__(kTileThreads, kFusedBlocks) tile_fused_staged(
    int rb, int ts, int chunk, long n, const int* __restrict__ run_ptr,
    const int* __restrict__ run_start, const int* __restrict__ run_len,
    const float* __restrict__ J, const float* __restrict__ w, const float* __restrict__ xt,
    const int* __restrict__ local, float* __restrict__ wu, float* __restrict__ part) {
  tile_pass<K>(FusedStage<K>{J, w, xt, local, wu, n}, K, 0, rb, ts, chunk, n, run_ptr, run_start,
               run_len, part);
}

// blockIdx.y: the column tile [W y, W y + W) of contrib's D columns
template <int W>
__global__ void __launch_bounds__(kTileThreads, kReduceBlocks) tile_reduce_split(
    int rb, int ts, int chunk, long n, int D, const int* __restrict__ run_ptr,
    const int* __restrict__ run_start, const int* __restrict__ run_len,
    const float* __restrict__ contrib, float* __restrict__ part) {
  const int col0 = blockIdx.y * W;
  tile_pass<W>(ReduceStage<W>{contrib, n, D, col0}, D, col0, rb, ts, chunk, n, run_ptr,
               run_start, run_len, part);
}

// The chunk and shared bytes of a pass over tiles of ts slots; smem 0 when
// they pass what a CTA may use.
template <class Stage, int W>
void pass_shape(int rb, int ts, int& chunk, size_t& smem) {
  chunk = Stage::kDirect ? ts : stage_chunk(W, ts);
  smem = tile_smem(W, Stage::kDirect ? 0 : chunk, rb, Stage::extra_bytes(rb, ts));
  if (smem > kMaxSmem) smem = 0;
}

template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(
                                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
}

template <int K>
cudaError_t launch_scatter_staged(int nt, int rb, int n, const int* run_ptr, const int* run_start,
                                  const int* run_len, const float* J, const float* u, float* part,
                                  cudaStream_t st) {
  const int ts = n / nt;
  int chunk;
  size_t smem;
  pass_shape<ScatterStage<K>, K>(rb, ts, chunk, smem);
  if (smem == 0) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(tile_scatter_staged<K>, smem);
  if (err != cudaSuccess) return err;
  tile_scatter_staged<K><<<nt, kTileThreads, smem, st>>>(rb, ts, chunk, n, run_ptr, run_start,
                                                          run_len, J, u, part);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_fused_staged(int nt, int rb, int n, const int* run_ptr, const int* run_start,
                                const int* run_len, const float* J, const float* w,
                                const float* xt, const int* local, float* wu, float* part,
                                cudaStream_t st) {
  const int ts = n / nt;
  int chunk;
  size_t smem;
  pass_shape<FusedStage<K>, K>(rb, ts, chunk, smem);
  if (smem == 0) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(tile_fused_staged<K>, smem);
  if (err != cudaSuccess) return err;
  tile_fused_staged<K><<<nt, kTileThreads, smem, st>>>(rb, ts, chunk, n, run_ptr, run_start,
                                                        run_len, J, w, xt, local, wu, part);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_reduce_split(int nt, int rb, int n, int D, const int* run_ptr,
                                const int* run_start, const int* run_len, const float* contrib,
                                float* part, cudaStream_t st) {
  const int ts = n / nt;
  int chunk;
  size_t smem;
  pass_shape<ReduceStage<W>, W>(rb, ts, chunk, smem);
  if (smem == 0) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(tile_reduce_split<W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nt, (D + W - 1) / W);
  tile_reduce_split<W><<<grid, kTileThreads, smem, st>>>(rb, ts, chunk, n, D, run_ptr, run_start,
                                                          run_len, contrib, part);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_gather(int nt, int ts, int rb, const int* local, const float* J,
                          const float* xt, float* out, cudaStream_t st) {
  const size_t smem = sizeof(float) * rb * K;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  tile_gather_rows<K><<<nt, kTileThreads, smem, st>>>(ts, rb, nt * ts, local, J, xt, out);
  return cudaGetLastError();
}

// dispatch on a compile-time Jacobian width
#define VIBA_DISPATCH_K(CALL, k, ARGS)              \
  ((k) == 3   ? CALL<3> ARGS                        \
   : (k) == 6 ? CALL<6> ARGS                        \
   : (k) == 9 ? CALL<9> ARGS                        \
              : cudaErrorInvalidValue)

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

// The reduce side refuses, before any launch, a grid whose n is not nt
// tiles of equal size or whose tile needs more than 227 KB of shared memory.
extern "C" int viba_tile_reduce(int nt, int rb, int n, int D, const int* run_ptr,
                                const int* run_start, const int* run_len, const float* contrib,
                                float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0 || D <= 0) return 0;
  if (n % nt != 0) return static_cast<int>(cudaErrorInvalidValue);
  // column tile: 3 for narrow rows, 9 (the 3x3 landmark blocks) otherwise
  return static_cast<int>(
      D <= 3 ? launch_reduce_split<3>(nt, rb, n, D, run_ptr, run_start, run_len, contrib, part, st)
             : launch_reduce_split<9>(nt, rb, n, D, run_ptr, run_start, run_len, contrib, part,
                                      st));
}

extern "C" int viba_tile_mv_scatter(int nt, int rb, int n, int k, const int* run_ptr,
                                    const int* run_start, const int* run_len, const float* J,
                                    const float* u, float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  if (n % nt != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(VIBA_DISPATCH_K(
      launch_scatter_staged, k, (nt, rb, n, run_ptr, run_start, run_len, J, u, part, st)));
}

extern "C" int viba_tile_mv_fused(int nt, int rb, int n, int k, const int* run_ptr,
                                  const int* run_start, const int* run_len, const float* J,
                                  const float* w, const float* xt, const int* local, float* wu,
                                  float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  if (n % nt != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(VIBA_DISPATCH_K(
      launch_fused_staged, k,
      (nt, rb, n, run_ptr, run_start, run_len, J, w, xt, local, wu, part, st)));
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

extern "C" int viba_tile_mv_gather(int nt, int ts, int rb, int k, const int* local,
                                   const float* J, const float* xt, float* u, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  return static_cast<int>(
      VIBA_DISPATCH_K(launch_gather, k, (nt, ts, rb, local, J, xt, u, st)));
}
