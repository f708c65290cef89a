// The landmark pass of the point-sorted routes: K4 and K6 (schur.cu), K9
// and K10 (cal_pcg.cu), and the column K9 (cal_pcg_cols.cuh).
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
// 3x3 inverse (K4, K9) or z = t (K6, K10: kSolve false). A landmark without
// slots gets z = 0. Bound: bytes — 16 B read per real slot, 36 B of hinv
// and 12 B of z per landmark. (K2's landmark pass, assemble_rig.cuh, sums
// 32-byte sectors at the same positions.)
//
// The column K4 and K9 (the covariance columns, C right-hand sides at once)
// read a point-sorted copy of the slot data instead, made once per reduced
// system (ops/segments.py point_sorted_records): one record a real slot at
// its point-sorted position, SlotRec below. Their landmark pass,
// point_pass_cols, fuses the down pass into the landmark sum: a group per
// (landmark, tile of W columns) stages the landmark's records in shared
// memory (cp.async), computes q = J_p^T w (J_r x_r[rig] + J_c x_c[win])
// for its column in registers and sums it in the single-column kernel's
// order, then writes z (L, 3, C) = H_ll^-1 t. Nothing per (slot, column)
// is stored. The sum order is the 16-lane group's: a lane class is the
// slots j = beg + cls, beg + cls + 16, ..., summed in order, and the 16
// class partials meet in the xor butterfly's tree. At W columns a group,
// the lowest bits of the class are P = 16 / W physical lanes (W = 1: the
// single-column layout, P = 16) and the M = 16 / P classes above them run
// in one thread, each in its accumulator, merged in that tree before the
// butterfly over the P lanes: the same additions in the same order, so
// every column's z has the single-column kernel's bits. The rig passes
// (schur.cu, cal_pcg_cols.cuh) walk their rows' classes depth first
// instead (LeafTree), which keeps fewer partials. Bound: operations —
// (4K + 4KC + 12) FMA-equivalents a slot and column; x_r[rig] is read per
// slot and column, from a window of the block's rigs staged in shared
// memory at W = 32 (the block's consecutive landmarks share rigs), x_c[win]
// kept in registers while the window stays the same.
#pragma once

#include "tile_reduce.cuh"

namespace viba {

// ---------------------------------------------------------------------------
// Tree-ordered sums in one thread, and the point-sorted slot records
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// k with its low `bits` bits reversed: the leaf that comes k-th when a
// butterfly's tree is walked depth first
__host__ __device__ constexpr int rev_bits(int k, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
  return r;
}

// The xor butterfly of group_sum over M leaves (M a power of two), in one
// thread: the leaves come in depth-first order (the k-th is leaf
// rev_bits(k, log2 M)); push(k, v) merges v, the k-th leaf's sum, with the
// completed subtrees like a binary counter, each merge the butterfly's
// addition of the same two partial sums. After the last leaf (k = M - 1) v
// holds the total. Called with k known at compile time (unrolled loops),
// the stack stays in registers.
template <int M, int D>
struct LeafTree {
  static constexpr int kLevels = log2i(M);
  float st[kLevels > 0 ? kLevels : 1][D];

  __device__ __forceinline__ void push(int k, float (&v)[D]) {
    int top = 0;
#pragma unroll
    for (int lvl = 0; lvl < kLevels; ++lvl) {
      if (((k >> lvl) & 1) && top == lvl) {
#pragma unroll
        for (int i = 0; i < D; ++i) v[i] = st[lvl][i] + v[i];
        top = lvl + 1;
      }
    }
#pragma unroll
    for (int lvl = 0; lvl < kLevels; ++lvl) {
      if (lvl == top) {
#pragma unroll
        for (int i = 0; i < D; ++i) st[lvl][i] = v[i];
      }
    }
  }
};

// One real slot of a blocked batch, at its point-sorted position
// (ops/segments.py point_sorted_records): J_r's then J_c's columns as
// (row 0, row 1) pairs, padded to whole float4s (the J block, read with
// 128-bit loads), then J_p's pairs, w, and the slot's rig, window and point
// rows as int bits, padded to whole float4s. K4 (KC = 0) and K9 share it.
template <int K, int KC>
struct SlotRec {
  static constexpr int nj = (2 * (K + KC) + 3) / 4 * 4;  // the J block's floats
  static constexpr int jr = 0;                           // pair a < K: J_r's column a
  static constexpr int jc = 2 * K;                       // pair K + a: J_c's column a
  static constexpr int jp = nj;                          // J_p's three pairs
  static constexpr int w = nj + 6;
  static constexpr int rig = nj + 7, win = nj + 8, point = nj + 9;
  static constexpr int floats = nj + 12;
};

// A record's J block in registers: j[2 o], j[2 o + 1] the pair of output o
// (J_r's column o for o < K, J_c's column o - K after)
template <int K, int KC>
__device__ __forceinline__ void load_j(const float* r, float (&j)[SlotRec<K, KC>::nj]) {
  const float4* r4 = reinterpret_cast<const float4*>(r);
#pragma unroll
  for (int i = 0; i < SlotRec<K, KC>::nj / 4; ++i) {
    const float4 q = r4[i];
    j[4 * i] = q.x;
    j[4 * i + 1] = q.y;
    j[4 * i + 2] = q.z;
    j[4 * i + 3] = q.w;
  }
}

// A record's tail: J_p's pairs p[0..5], w, and its rig, window and point rows
struct RecTail {
  float p[6], w;
  int rig, win, point;
};

template <int K, int KC>
__device__ __forceinline__ RecTail load_tail(const float* r) {
  const float4* r4 = reinterpret_cast<const float4*>(r + SlotRec<K, KC>::jp);
  const float4 a = r4[0], b = r4[1], c = r4[2];
  return {{a.x, a.y, a.z, a.w, b.x, b.y}, b.z, __float_as_int(b.w), __float_as_int(c.x),
          __float_as_int(c.y)};
}

// Lanes of a landmark group of the column pass: P physical lanes take the
// low bits of the lane class, M = 16 / P classes run in one thread, W
// columns a group (W = 1: 16 lanes, the single-column layout; W = 8: 2
// lanes a column; W = 32: a warp of 32 columns, all 16 classes in each
// thread). A group stages S of its landmark's records at a time (a
// multiple of the 16 classes).
template <int W>
struct PointLanes {
  static constexpr int P = W >= kPointGroup ? 1 : kPointGroup / W;
  static constexpr int G = P * W;
  static constexpr int M = kPointGroup / P;
  static constexpr int NG = 256 / G;  // groups a block
  static constexpr int B = M < 4 ? M : 4;  // slots a thread takes together
};

// The landmark pass's shared memory: S records a group stages at once (a
// multiple of the 16 classes, one a lane); at W = 32, a window of RW rigs' x_r rows for
// the block's tile (48 KB), which the block's consecutive landmarks (their
// tracks share rigs) read instead of gathering x_r from the L2 slot by slot
template <int K, int KC, int W>
struct PointSmem {
  static constexpr int RF = SlotRec<K, KC>::floats;
  // at most one record a lane (the window check); 16 for K9's long records
  static constexpr int S = RF > 32 || PointLanes<W>::G < 32 ? 16 : 32;
  static constexpr bool kWindow = W == 32;
  static constexpr int RW = kWindow ? 48 * 1024 / (4 * K * W) : 0;
  static constexpr int rec_floats = 2 * PointLanes<W>::NG * S * RF;  // two chunks a group
  static constexpr int bytes = (rec_floats + RW * K * W) * 4;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));  // 0 bytes read: the word is zero-filled
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// q = J_p^T w (J_r x_r[rig] + J_c x_c[win]) of one slot record for column
// c, as the single-column down pass computes it (K4: KC = 0, no J_c term).
// xc holds x_c[cur, :, c]; with kReload it is reloaded when the slot's
// window differs (else the caller knows the window is cur).
// x_r of the slot's rig for column c: from the block's window of rigs
// (xs: (RW, K, W) from rig rlo, column col of the tile) when it holds it,
// else from the table (R, K, C)
struct XrSource {
  const float* x_r;
  const float* xs;
  int rlo, col, W;
  bool window;
};

template <int K, int KC, bool kReload>
__device__ __forceinline__ void slot_q(const float* r, const XrSource& xsrc,
                                       const float* __restrict__ x_c, int C, int c,
                                       float (&xc)[KC > 0 ? KC : 1], int& cur, float (&q)[3]) {
  float j[SlotRec<K, KC>::nj];
  load_j<K, KC>(r, j);
  const RecTail tl = load_tail<K, KC>(r);
  const float* xr = xsrc.window ? xsrc.xs + (long)(tl.rig - xsrc.rlo) * K * xsrc.W + xsrc.col
                                : xsrc.x_r + (long)K * C * tl.rig + c;
  const long xstride = xsrc.window ? xsrc.W : C;
  float u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const float xv = xr[a * xstride];
    u0 += j[2 * a] * xv;
    u1 += j[2 * a + 1] * xv;
  }
  float wu0, wu1;
  if constexpr (KC > 0) {
    if constexpr (kReload) {
      if (tl.win != cur) {
        cur = tl.win;
        const float* xcp = x_c + (long)KC * C * tl.win + c;
#pragma unroll
        for (int a = 0; a < KC; ++a) xc[a] = xcp[(long)a * C];
      }
    }
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int a = 0; a < KC; ++a) {
      v0 += j[2 * (K + a)] * xc[a];
      v1 += j[2 * (K + a) + 1] * xc[a];
    }
    wu0 = (u0 + v0) * tl.w;
    wu1 = (u1 + v1) * tl.w;
  } else {
    wu0 = u0 * tl.w;
    wu1 = u1 * tl.w;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = tl.p[2 * i] * wu0 + tl.p[2 * i + 1] * wu1;
}

// B slots of a round of a staged chunk, classes mb .. mb + B - 1 (known at
// compile time, so the accumulators stay in registers): their loads are
// independent (a slot past c1 computes on the chunk's first record and adds
// nothing)
template <int K, int KC, int W, bool kReload, int mb>
__device__ __forceinline__ void point_batch(const float* rec_s, int r0, int c0, int c1, int phi,
                                           bool live, const XrSource& x_r,
                                           const float* __restrict__ x_c, int C, int c,
                                           float (&xc)[KC > 0 ? KC : 1], int& cur,
                                           float (&acc)[PointLanes<W>::M][3]) {
  using Lanes = PointLanes<W>;
  constexpr int P = Lanes::P, B = Lanes::B, RF = SlotRec<K, KC>::floats;
  if constexpr (mb < Lanes::M) {
    if (r0 + P * mb < c1) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int j = r0 + phi + P * (mb + b);
        float q[3];
        slot_q<K, KC, kReload>(rec_s + (j < c1 ? j - c0 : 0) * RF, x_r, x_c, C, c, xc, cur, q);
        // a separate rounded add, as the single-column pass adds the q it
        // reads back (a plain + would let the compiler fuse q's last product)
        if (j < c1 && live) {
#pragma unroll
          for (int i = 0; i < 3; ++i) acc[mb + b][i] = __fadd_rn(acc[mb + b][i], q[i]);
        }
      }
    }
  }
}

// One staged chunk [c0, c1) of a landmark's records (c0 - beg a multiple of
// 16, beg the landmark's first): thread phi walks its slots in order in
// rounds of the 16 classes, B slots at a time, adding q to the accumulator
// of the slot's class.
template <int K, int KC, int W, bool kReload>
__device__ __forceinline__ void point_chunk(const float* rec_s, int c0, int c1, int phi, bool live,
                                           const XrSource& x_r,
                                           const float* __restrict__ x_c, int C, int c,
                                           float (&xc)[KC > 0 ? KC : 1], int& cur,
                                           float (&acc)[PointLanes<W>::M][3]) {
  constexpr int B = PointLanes<W>::B;
  static_assert(PointLanes<W>::M <= 8 * B, "eight batches a round");
  for (int r0 = c0; r0 < c1; r0 += kPointGroup) {
#define VIBA_BATCH(i)                                                                        \
  point_batch<K, KC, W, kReload, (i) * B>(rec_s, r0, c0, c1, phi, live, x_r, x_c, C, c, xc, \
                                          cur, acc)
    VIBA_BATCH(0);
    VIBA_BATCH(1);
    VIBA_BATCH(2);
    VIBA_BATCH(3);
    VIBA_BATCH(4);
    VIBA_BATCH(5);
    VIBA_BATCH(6);
    VIBA_BATCH(7);
#undef VIBA_BATCH
  }
}

// The landmark pass of the column K4 / K9 (at least two blocks an SM at
// rig width 6 without window columns, which ran faster on the H100; the
// others need more registers than two blocks leave): a group of
// PointLanes<W>::G
// lanes per (landmark, tile of W columns); a block holds NG consecutive
// landmarks (their tracks share rigs: x_r rows shared in L1) for one tile,
// the blocks of a landmark run tile by tile (their records shared in L2).
// Each group copies S of its landmark's records at a time into its part of
// shared memory (cp.async, the next S while it sums these), walks them
// (point_chunk: a chunk whose records all share one window keeps x_c[win]
// in registers without a check), then merges the M classes in the
// butterfly's tree and the P
// lanes with the butterfly. z is (L, 3, C).
template <int K, int KC, int W>
__global__ void __launch_bounds__(256, KC == 0 && K == 6 ? 2 : 1) point_pass_cols(int L, int C, int n_tiles,
                                                       int rig_sorted,
                                                       const int* __restrict__ pt_ptr,
                                                       const float* __restrict__ rec,
                                                       const float* __restrict__ x_r,
                                                       const float* __restrict__ x_c,
                                                       const float* __restrict__ hinv,
                                                       float* __restrict__ z) {
  using Lanes = PointLanes<W>;
  using Sm = PointSmem<K, KC, W>;
  using Rec = SlotRec<K, KC>;
  constexpr int P = Lanes::P, G = Lanes::G, M = Lanes::M, S = Sm::S, RF = Rec::floats;
  constexpr int LOGM = log2i(M);
  extern __shared__ float4 smem4[];
  const int grp = threadIdx.x / G, lane = threadIdx.x % G, phi = lane % P;
  float* rec_g = reinterpret_cast<float*>(smem4) + grp * 2 * S * RF;  // two chunks
  const unsigned mask = G == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  const int l = blockIdx.x / n_tiles * Lanes::NG + grp;
  const int tile = blockIdx.x % n_tiles;
  const int c_tile = tile * W + lane / P;
  const bool live = l < L && c_tile < C;
  const int c = live ? c_tile : 0;  // the loads of a lane past C stay in bounds
  const int beg = l < L ? pt_ptr[l] : 0, end = l < L ? pt_ptr[l + 1] : 0;
  XrSource x_src{x_r, reinterpret_cast<float*>(smem4) + Sm::rec_floats, 0, lane / P, W, false};
  if (Sm::kWindow && rig_sorted) {
    // the block's rigs (rig_sorted: each landmark's records in rig order,
    // the first and last its least and largest): staged as one window of
    // x_r rows when they span at most RW
    __shared__ int win_lo, win_hi;
    if (threadIdx.x == 0) {
      win_lo = 0x7fffffff;
      win_hi = -1;
    }
    __syncthreads();
    if (lane == 0 && end > beg) {
      atomicMin(&win_lo, __float_as_int(rec[(long)beg * RF + Rec::rig]));
      atomicMax(&win_hi, __float_as_int(rec[(long)(end - 1) * RF + Rec::rig]));
    }
    __syncthreads();
    x_src.rlo = win_lo;
    x_src.window = win_hi >= 0 && win_hi - win_lo < Sm::RW;
    if (x_src.window) {
      float* xs = const_cast<float*>(x_src.xs);
      const int n = (win_hi - win_lo + 1) * K * W;
      for (int idx = threadIdx.x; idx < n; idx += 256) {
        const int row = idx / W, col = idx - row * W;  // row = (rig - rlo) K + a
        const bool in = tile * W + col < C;
        cp_async4(xs + idx, x_r + ((long)K * win_lo + row) * C + (in ? tile * W + col : 0), in);
      }
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();
    }
  }
  float xc[KC > 0 ? KC : 1];
  int cur = -1;
  float acc[M][3];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[m][i] = 0.f;
  }
  // the landmark's chunks, each staged while the one before is summed
  const auto stage = [&](int c0, float* buf) {
    for (int idx = lane; idx < (min(end, c0 + S) - c0) * (RF / 4); idx += G)
      cp_async16(buf + 4 * idx, rec + (long)c0 * RF + 4 * idx);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (beg < end) stage(beg, rec_g);
  for (int c0 = beg, h = 0; c0 < end; c0 += S, ++h) {
    const int c1 = min(end, c0 + S);
    const float* rec_s = rec_g + (h & 1) * S * RF;
    if (c1 < end) {
      stage(c1, rec_g + ((h + 1) & 1) * S * RF);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp(mask);
    if constexpr (KC > 0) {
      // the chunk's records on one window (lane i looks at record i): x_c
      // stays in registers without a check a slot
      const int wf = __float_as_int(rec_s[Rec::win]);
      if (__all_sync(mask,
                     lane >= c1 - c0 || __float_as_int(rec_s[lane * RF + Rec::win]) == wf)) {
        if (wf != cur) {
          cur = wf;
          const float* xcp = x_c + (long)KC * C * wf + c;
#pragma unroll
          for (int a = 0; a < KC; ++a) xc[a] = xcp[(long)a * C];
        }
        point_chunk<K, KC, W, false>(rec_s, c0, c1, phi, live, x_src, x_c, C, c, xc, cur, acc);
      } else {
        point_chunk<K, KC, W, true>(rec_s, c0, c1, phi, live, x_src, x_c, C, c, xc, cur, acc);
      }
    } else {
      point_chunk<K, KC, W, false>(rec_s, c0, c1, phi, live, x_src, x_c, C, c, xc, cur, acc);
    }
    __syncwarp(mask);
  }
  // (loops of constant trip counts, so that the accumulators stay in
  // registers: halving h would leave them to local memory)
#pragma unroll
  for (int lvl = 1; lvl <= LOGM; ++lvl) {
#pragma unroll
    for (int m = 0; m < M / 2; ++m) {
      if (m < (M >> lvl)) {
#pragma unroll
        for (int i = 0; i < 3; ++i) acc[m][i] = acc[m][i] + acc[m + (M >> lvl)][i];
      }
    }
  }
  float t[3] = {acc[0][0], acc[0][1], acc[0][2]};
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] += __shfl_xor_sync(0xffffffffu, t[i], off);
  }
  if (live && phi == 0) {
    const float* h = hinv + 9 * (long)l;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      z[(3 * (long)l + i) * C + c] = h[3 * i] * t[0] + h[3 * i + 1] * t[1] + h[3 * i + 2] * t[2];
  }
}

// columns a group of the column passes: 1 for a single column (the
// single-column kernels' lane layout), 8 up to 8 columns, else 32
inline int col_width(int C) { return C == 1 ? 1 : C <= 8 ? 8 : 32; }

template <int K, int KC, int W>
inline cudaError_t launch_point_pass_w(int L, int C, int rig_sorted, const int* pt_ptr,
                                       const float* rec, const float* x_r, const float* x_c,
                                       const float* hinv, float* z, cudaStream_t st) {
  using Lanes = PointLanes<W>;
  constexpr int smem = PointSmem<K, KC, W>::bytes;
  cudaError_t err = cudaFuncSetAttribute(point_pass_cols<K, KC, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (C + W - 1) / W;
  const int grid = (L + Lanes::NG - 1) / Lanes::NG * n_tiles;
  point_pass_cols<K, KC, W><<<grid, 256, smem, st>>>(L, C, n_tiles, rig_sorted, pt_ptr, rec, x_r,
                                                     x_c, hinv, z);
  return cudaGetLastError();
}

template <int K, int KC>
inline cudaError_t launch_point_pass_cols(int L, int C, int rig_sorted, const int* pt_ptr,
                                          const float* rec, const float* x_r, const float* x_c,
                                          const float* hinv, float* z, cudaStream_t st) {
  if (L <= 0) return cudaGetLastError();
  switch (col_width(C)) {
    case 1:
      return launch_point_pass_w<K, KC, 1>(L, C, rig_sorted, pt_ptr, rec, x_r, x_c, hinv, z, st);
    case 8:
      return launch_point_pass_w<K, KC, 8>(L, C, rig_sorted, pt_ptr, rec, x_r, x_c, hinv, z, st);
    default:
      return launch_point_pass_w<K, KC, 32>(L, C, rig_sorted, pt_ptr, rec, x_r, x_c, hinv, z,
                                            st);
  }
}

// ---------------------------------------------------------------------------
// The rig passes' chunks: a segment's records staged in shared memory
// ---------------------------------------------------------------------------

template <int LOGM>
__device__ __forceinline__ int rev_rt(int k) {
  if constexpr (LOGM == 0) {
    return 0;
  } else {
    return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - LOGM));
  }
}

// The rig passes walk a segment (K4: a rig row; K9: a (rig, window row)
// pair) of n slots, lane class = the slot's index mod 32 NWG (NWG warps of
// 32 lanes in the single-column group): lane phi (of P physical class
// lanes) of warp-group wg takes, for k = 0 .. M - 1 in depth-first order,
// the class 32 wg + phi + P rev(k), its slots t = 0 .. T - 1 (T = ceil(n /
// 32 NWG)), step s = k T + t. A chunk is a run of steps [s0, s1) for every
// (wg, phi): entry e = ((s - s0) NWG + wg) P + phi. It holds one slot's
// record (staged) and its du for each of the tile's columns.
template <int NWG, int P, int LOGM>
__device__ __forceinline__ int entry_slot(int e, int s0, int T) {
  const int phi = e % P, wg = (e / P) % NWG, s = s0 + e / (P * NWG);
  const int k = s / T, t = s - k * T;
  return 32 * wg + phi + P * rev_rt<LOGM>(k) + 32 * NWG * t;
}

// Copy the records of a chunk's n_e entries into rec_s (RF floats each),
// every thread of the block issuing its 16-byte copies before one wait;
// entries past the segment (slot >= n) are left alone. pos: each
// rig-side slot's record (PtRecords.rig_pos), from the segment's start.
template <int NWG, int P, int LOGM, int RF>
__device__ __forceinline__ void stage_records(float* rec_s, const float* __restrict__ rec,
                                              const int* __restrict__ pos, int n, int n_e,
                                              int s0, int T) {
  constexpr int RF4 = RF / 4;
  for (int idx = threadIdx.x; idx < n_e * RF4; idx += blockDim.x) {
    const int e = idx / RF4, f = idx - e * RF4;
    const int i = entry_slot<NWG, P, LOGM>(e, s0, T);
    if (i < n) cp_async16(rec_s + 4 * idx, rec + (long)pos[i] * RF + 4 * f);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Landmark l's contiguous range of p summed by the G lanes of its group
// (lane-strided, then the butterfly), z[l] = H_ll^-1[l] t or t; every lane
// of the group takes part, a landmark l >= L with an empty range.
template <int G, bool kSolve>
__device__ __forceinline__ void point_range_row(int l, int lane, int L,
                                                const int* __restrict__ pt_ptr,
                                                const float4* __restrict__ p,
                                                const float* __restrict__ hinv,
                                                float* __restrict__ z) {
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

template <int G, bool kSolve>
__global__ void __launch_bounds__(kBlock) point_range_sum(int L, const int* __restrict__ pt_ptr,
                                                          const float4* __restrict__ p,
                                                          const float* __restrict__ hinv,
                                                          float* __restrict__ z) {
  point_range_row<G, kSolve>(blockIdx.x * (kBlock / G) + threadIdx.x / G, threadIdx.x % G, L,
                             pt_ptr, p, hinv, z);
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
