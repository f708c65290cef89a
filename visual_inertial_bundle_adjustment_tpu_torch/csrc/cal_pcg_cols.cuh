// K9 on C right-hand sides: the covariance columns' PCG matvec of a
// calibration-coupled visual batch (the units and what they share:
// cal_segments.cuh; the single-column K9 it matches column by column:
// cal_pcg.cu). A header: its rig widths 6 and 9 compile as two units,
// cal_pcg_cols.cu and cal_pcg_cols_k9.cu, one nvcc each.
//
// K9 on C right-hand sides (viba_schur_pcg_cal_cols, the covariance
// columns: x_r (R, K, C), x_c (n_c, kc, C), y likewise) is three launches
// over the point-sorted slot records of the reduced system (pt_segments.cuh
// SlotRec, made once per system), each reading a slot's record once for a
// tile of W columns (32; 8 up to 8 columns; 1 for one) and writing nothing
// per (slot, column):
//   points   point_pass_cols (pt_segments.cuh), shared with K4: the down
//            pass fused into the landmark sums, z (L, 3, C);
//   rig      a 256-thread block per (rig row, tile), over the row's (rig,
//            window row) pairs, each pair's slots in chunks whose records
//            are staged in shared memory (cp.async):
//            at W = 32, rig_split_pass_cols: warp w takes the lane classes
//            w + 8 j of the pair, each lane computes its slots' du for its
//            column in registers and adds J^T du to all K + kc outputs
//            with the J values it loaded (below);
//            at W = 1 and 8, rig_pair_pass_cols: every thread computes du
//            for an entry and column into a shared tile (float2, SE x W);
//            then warp g owns four of the K + kc outputs in the record's
//            J order (o < K: y_r[o], else y_c[o - K]; two 128-bit loads of J a
//            slot);
//            a rig output keeps each lane class's partial in shared memory
//            across the row's pairs (the single-column lanes carry acc_r
//            across pairs), a window output merges the pair's classes depth
//            first (LeafTree, its stack in shared memory too, for the
//            registers); the pair's window partials go to part (n_pairs,
//            kc, C), y_r after the last pair;
//   window   sum_partials (tile_reduce.cuh): each window row's pair
//            partials summed in rig order.
// Every column is summed in the single-column kernel's order: a warp per
// rig row, the lane class of a slot its index in the pair mod 32, each
// class summed in order, the classes in the butterfly's tree. A chunk is a
// run of steps (class, slot of the class) in depth-first order, a class's
// partial carried across a chunk's end, so a pair of any length runs in
// order. Bound: operations — (8K + 8kc + 24) FMA-equivalents a slot and
// column.
#pragma once

#include "cal_segments.cuh"

namespace {

// K9 columns, rig pass: shapes of a block per (rig row, tile of W columns).
// Its outputs are the K rig and KC window components, in the record's J
// block order (o < K: y_r[o], else y_c[o - K]); phase-2 warp g owns four
// (eight a warp, half the warps idle in phase 2, ran slower on the H100).
template <int K, int KC, int W>
struct CalCols {
  static constexpr int P = 32 / W, M = W, LOGM = viba::log2i(M);
  static constexpr int RF = viba::SlotRec<K, KC>::floats;
  static constexpr int SE = W == 8 ? 192 : 256;  // entries a chunk
  static constexpr int NS = SE / P;                             // steps a chunk
  static constexpr int NO = 4, NG = (K + KC + NO - 1) / NO;      // outputs a warp, warps
  static constexpr int LV = LOGM > 0 ? LOGM : 1;
  static constexpr int yr_floats = K * M * 32;    // each rig output's class partials
  static constexpr int st_floats = KC * LV * 32;  // each window output's LeafTree stack
  // staged records, du tile, the rig partials, the window stacks
  static constexpr int smem_bytes = SE * RF * 4 + SE * W * 8 + (yr_floats + st_floats) * 4;
  static_assert(NG <= 8, "one warp per four outputs");
  static_assert(W < 32, "32 columns a tile take rig_split_pass_cols");
};

// LeafTree::push of one output with the completed subtrees in shared
// memory: st is this lane's LOGM slots, 32 floats apart (k known or not at
// compile time: the levels are unrolled)
template <int LOGM>
__device__ __forceinline__ void push_shared(int k, float& v, float* st) {
  int top = 0;
#pragma unroll
  for (int lvl = 0; lvl < LOGM; ++lvl) {
    if (((k >> lvl) & 1) && top == lvl) {
      v = st[lvl * 32] + v;
      top = lvl + 1;
    }
  }
#pragma unroll
  for (int lvl = 0; lvl < LOGM; ++lvl) {
    if (lvl == top) st[lvl * 32] = v;
  }
}

// du of one slot record for column c, as the single-column up pass
// computes it: w (J_r x_r + J_c x_c) - w J_p z[point] (z read at landmark 0
// for an entry that holds no record: its du is not stored)
template <int K, int KC>
__device__ __forceinline__ float2 cal_du(const float* r, const float (&xr)[K],
                                         const float (&xc)[KC], const float* __restrict__ z,
                                         int C, int c, bool valid) {
  float j[viba::SlotRec<K, KC>::nj];
  viba::load_j<K, KC>(r, j);
  const viba::RecTail tl = viba::load_tail<K, KC>(r);
  float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int a = 0; a < K; ++a) {
    u0 += j[2 * a] * xr[a];
    u1 += j[2 * a + 1] * xr[a];
  }
#pragma unroll
  for (int a = 0; a < KC; ++a) {
    v0 += j[2 * (K + a)] * xc[a];
    v1 += j[2 * (K + a) + 1] * xc[a];
  }
  const float* zp = z + 3L * C * (valid ? tl.point : 0) + c;
  const float z0 = zp[0], z1 = zp[C], z2 = zp[2L * C];
  const float a0 = tl.p[0] * z0 + tl.p[2] * z1 + tl.p[4] * z2;
  const float a1 = tl.p[1] * z0 + tl.p[3] * z1 + tl.p[5] * z2;
  return make_float2((u0 + v0) * tl.w - a0 * tl.w, (u1 + v1) * tl.w - a1 * tl.w);
}

// K9 columns, rig pass: a block per (rig row, tile of W columns); see the
// file's head
template <int K, int KC, int W>
__global__ void __launch_bounds__(256, 2) rig_pair_pass_cols(
    int C, int n_tiles, const int* __restrict__ rig_pair, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_part, const int* __restrict__ rig_pos,
    const float* __restrict__ rec, const float* __restrict__ x_r, const float* __restrict__ x_c,
    const float* __restrict__ z, float* __restrict__ part, float* __restrict__ y_r) {
  using S = CalCols<K, KC, W>;
  using Rec = viba::SlotRec<K, KC>;
  constexpr int P = S::P, M = S::M, LOGM = S::LOGM, RF = S::RF, NO = S::NO;
  extern __shared__ float4 smem4[];
  float* rec_s = reinterpret_cast<float*>(smem4);              // (SE, RF)
  float2* du = reinterpret_cast<float2*>(rec_s + S::SE * RF);  // (SE, W)
  float* yr_s = reinterpret_cast<float*>(du + S::SE * W);      // (K, M, 32 lanes)
  float* st_s = yr_s + S::yr_floats;                           // (KC, LV, 32 lanes)
  const int row = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = NO * warp;  // this warp's first output in phase 2
  // phase 2: lane = (column, class bits phi); phase 1: thread = (entry lane, column)
  const int phi = lane % P, c = tile * W + lane / P;
  const bool live = c < C;
  const int col1 = threadIdx.x % W, c1 = tile * W + col1;
  const bool live1 = c1 < C;
  const int c1s = live1 ? c1 : 0;  // the loads of a lane past C stay in bounds
  for (int i = threadIdx.x; i < S::yr_floats; i += 256) yr_s[i] = 0.f;
  float xr[K];
#pragma unroll
  for (int a = 0; a < K; ++a) xr[a] = live1 ? x_r[((long)K * row + a) * C + c1] : 0.f;
  float acc[NO];  // the leaf under way (it may span chunks)
  for (int q = rig_pair[row]; q < rig_pair[row + 1]; ++q) {
    const int beg = pair_ptr[q], n_q = pair_ptr[q + 1] - beg, T = (n_q + 31) / 32;
    float xc[KC];
    {
      const int wn = __float_as_int(rec[(long)rig_pos[beg] * RF + Rec::win]);
      const float* xcp = x_c + (long)KC * C * wn + c1;
#pragma unroll
      for (int a = 0; a < KC; ++a) xc[a] = live1 ? xcp[(long)a * C] : 0.f;
    }
    float yc[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) yc[j] = 0.f;
    for (int s0 = 0; s0 < M * T; s0 += S::NS) {
      const int s1 = min(M * T, s0 + S::NS), n_e = (s1 - s0) * P;
      viba::stage_records<1, P, LOGM, RF>(rec_s, rec, rig_pos + beg, n_q, n_e, s0, T);
      // phase 1, the entries of a thread in fours, their z loads independent
      for (int en0 = threadIdx.x / W; en0 < n_e; en0 += 4 * (256 / W)) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int en = en0 + b * (256 / W);
          const bool valid = en < n_e && viba::entry_slot<1, P, LOGM>(en, s0, T) < n_q;
          const float2 d = cal_du<K, KC>(rec_s + (valid ? en : 0) * RF, xr, xc, z, C, c1s, valid);
          if (valid && live1) du[en * W + col1] = d;
        }
      }
      __syncthreads();
      if (warp < S::NG) {  // phase 2: outputs o0 .. o0 + NO - 1 of this pair's chunk
#pragma unroll 1
        for (int k = s0 / T; k < M && k * T < s1; ++k) {
          const int ta = max(0, s0 - k * T), tb = min(T, s1 - k * T);
          const int m = viba::rev_rt<LOGM>(k);
          if (ta == 0) {  // a class starts: rig outputs carry its partial across pairs
#pragma unroll
            for (int j = 0; j < NO; ++j)
              acc[j] = o0 + j < K ? yr_s[((o0 + j) * M + m) * 32 + lane] : 0.f;
          }
          if (live) {
#pragma unroll 2
            for (int t = ta; t < tb && phi + P * m + 32 * t < n_q; ++t) {
              const int en = (k * T + t - s0) * P + phi;
              const float2 d = du[en * W + lane / P];
              const float4* r4 = reinterpret_cast<const float4*>(rec_s + en * RF + 2 * o0);
#pragma unroll
              for (int h = 0; h < NO / 2; ++h) {
                const float4 jv = r4[h];
                if (o0 + 2 * h < K + KC) acc[2 * h] += jv.x * d.x + jv.y * d.y;
                if (o0 + 2 * h + 1 < K + KC) acc[2 * h + 1] += jv.z * d.x + jv.w * d.y;
              }
            }
          }
          if (tb == T) {  // the class is done
#pragma unroll
            for (int j = 0; j < NO; ++j) {
              const int o = o0 + j;
              if (o < K) {
                yr_s[(o * M + m) * 32 + lane] = acc[j];
              } else if (o < K + KC) {
                push_shared<LOGM>(k, acc[j], st_s + (o - K) * S::LV * 32 + lane);
                if (k == M - 1) yc[j] = acc[j];
              }
            }
          }
        }
      }
      __syncthreads();
    }
    if (warp < S::NG && o0 + NO > K) {  // this pair's window partials
#pragma unroll
      for (int off = P / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < NO; ++j) yc[j] += __shfl_xor_sync(0xffffffffu, yc[j], off);
      }
      if (live && phi == 0) {
        float* dst = part + (long)KC * C * pair_part[q] + c;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          if (o0 + j >= K && o0 + j < K + KC) dst[(long)(o0 + j - K) * C] = yc[j];
        }
      }
    }
  }
  if (warp < S::NG && o0 < K) {  // the classes of each rig output in the butterfly's tree
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (o0 + j < K) {
        float* ys = yr_s + (o0 + j) * M * 32 + lane;  // this lane's own slots
#pragma unroll
        for (int lvl = 1; lvl <= LOGM; ++lvl) {
#pragma unroll
          for (int m = 0; m < M / 2; ++m) {
            if (m < (M >> lvl)) ys[m * 32] = ys[m * 32] + ys[(m + (M >> lvl)) * 32];
          }
        }
        float v = ys[0];
#pragma unroll
        for (int off = P / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (live && phi == 0) y_r[((long)K * row + o0 + j) * C + c] = v;
      }
    }
  }
}

template <int K, int KC, int W>
cudaError_t launch_rig_pair_pass(int R, int C, const int* rig_pair, const int* pair_ptr,
                                 const int* pair_part, const int* rig_pos, const float* rec,
                                 const float* x_r, const float* x_c, const float* z, float* part,
                                 float* y_r, cudaStream_t st) {
  constexpr int smem = CalCols<K, KC, W>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(rig_pair_pass_cols<K, KC, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (C + W - 1) / W;
  rig_pair_pass_cols<K, KC, W><<<R * n_tiles, 256, smem, st>>>(
      C, n_tiles, rig_pair, pair_ptr, pair_part, rig_pos, rec, x_r, x_c, z, part, y_r);
  return cudaGetLastError();
}

// K9 columns at 32 columns a tile, rig pass with the lane classes split
// over the block's warps (rig_split_pass_cols): warp w takes the classes
// w + 8 j, j < 4, of each (rig, window row) pair, and each lane computes,
// for its column, du of each of its slots in registers and adds J^T du to
// all K + kc outputs at once (the J values it loaded for du; no du tile).
// The class tree (the single-column warp's butterfly, bit 4 first) splits
// along it: the classes' bits 3-4 (j) merge in the warp, depth first
// (LeafTree, the window outputs' stacks in shared memory) or, for the rig
// outputs, whose partials run across the row's pairs, from the partials
// kept in shared memory; then bits 2, 1, 0 (w) across the warps, in that
// order, from shared memory. The chunks' records are staged with cp.async
// one chunk ahead.
template <int K, int KC>
struct SplitCols {
  static constexpr int NW = 8;                        // warps; classes w + NW j
  static constexpr int M = 32 / NW, LOGM = viba::log2i(M);
  static constexpr int RF = viba::SlotRec<K, KC>::floats;
  static constexpr int NS = 16;                       // steps a chunk, each warp
  static constexpr int SE = NS * NW;                  // entries a chunk
  static constexpr int NO = K + KC;
  static constexpr int yr_floats = NW * M * K * 32;   // rig outputs' class partials
  static constexpr int st_floats = NW * LOGM * KC * 32;  // window outputs' stacks
  static constexpr int sub_floats = NW * NO * 32;     // each warp's subtree of a pair / the row
  // two chunks of staged records (the next one copied while this one is
  // summed), the partials, stacks and subtrees
  static constexpr int smem_bytes = (2 * SE * RF + yr_floats + st_floats + sub_floats) * 4;
};

// the rig-side slot of chunk entry e = (s - s0) NW + w: class w + NW rev(k)
template <int NW, int LOGM>
__device__ __forceinline__ int split_slot(int e, int s0, int T) {
  const int w = e % NW, s = s0 + e / NW, k = s / T;
  return w + NW * viba::rev_rt<LOGM>(k) + 32 * (s - k * T);
}

// the butterfly's tree over the warps' subtrees (class bits 2, 1, 0: warp
// bits 2, 1, 0): ((S0 + S4) + (S2 + S6)) + ((S1 + S5) + (S3 + S7)), S_w at
// sub[w * stride]
__device__ __forceinline__ float warp_tree8(const float* sub, int stride) {
  return ((sub[0] + sub[4 * stride]) + (sub[2 * stride] + sub[6 * stride])) +
         ((sub[stride] + sub[5 * stride]) + (sub[3 * stride] + sub[7 * stride]));
}

template <int K, int KC>
__global__ void __launch_bounds__(256, 1) rig_split_pass_cols(
    int C, int n_tiles, const int* __restrict__ rig_pair, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_part, const int* __restrict__ rig_pos,
    const float* __restrict__ rec, const float* __restrict__ x_r, const float* __restrict__ x_c,
    const float* __restrict__ z, float* __restrict__ part, float* __restrict__ y_r) {
  using S = SplitCols<K, KC>;
  using Rec = viba::SlotRec<K, KC>;
  constexpr int NW = S::NW, M = S::M, LOGM = S::LOGM, RF = S::RF, NO = S::NO;
  static_assert(NW == 8 && LOGM == 2, "warp_tree8; two in-warp levels");
  extern __shared__ float4 smem4[];
  float* rec_b = reinterpret_cast<float*>(smem4);  // (2, SE, RF)
  float* yr_s = rec_b + 2 * S::SE * RF;            // (NW, M, K, 32 lanes)
  float* st_s = yr_s + S::yr_floats;               // (NW, LOGM, KC, 32)
  float* sub_s = st_s + S::st_floats;              // (NW, NO, 32)
  const int row = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c_tile = tile * 32 + lane;
  const bool live = c_tile < C;
  const int c = live ? c_tile : 0;  // the loads of a lane past C stay in bounds
  float* my_yr = yr_s + w * M * K * 32 + lane;     // [j][a] at (j K + a) 32
  float* my_st = st_s + w * LOGM * KC * 32 + lane;  // [lvl][a] at (lvl KC + a) 32
  float* my_sub = sub_s + w * NO * 32 + lane;       // [o] at o 32
  for (int i = threadIdx.x; i < S::yr_floats; i += 256) yr_s[i] = 0.f;
  float xr[K];
#pragma unroll
  for (int a = 0; a < K; ++a) xr[a] = live ? x_r[((long)K * row + a) * C + c] : 0.f;
  float acc[NO];  // the class under way (it may span chunks)
#pragma unroll
  for (int o = 0; o < NO; ++o) acc[o] = 0.f;
  __syncthreads();
  for (int q = rig_pair[row]; q < rig_pair[row + 1]; ++q) {
    const int beg = pair_ptr[q], n_q = pair_ptr[q + 1] - beg, T = (n_q + 31) / 32;
    float xc[KC];
    {
      const int wn = __float_as_int(rec[(long)rig_pos[beg] * RF + Rec::win]);
      const float* xcp = x_c + (long)KC * C * wn + c;
#pragma unroll
      for (int a = 0; a < KC; ++a) xc[a] = live ? xcp[(long)a * C] : 0.f;
    }
    // the pair's chunks, each staged while the one before is summed
    const auto stage = [&](int s0, float* buf) {
      const int n_e = (min(M * T, s0 + S::NS) - s0) * NW;
      for (int idx = threadIdx.x; idx < n_e * (RF / 4); idx += 256) {
        const int e = idx / (RF / 4), f = idx - e * (RF / 4);
        const int i = split_slot<NW, LOGM>(e, s0, T);
        if (i < n_q) viba::cp_async16(buf + 4 * idx, rec + (long)rig_pos[beg + i] * RF + 4 * f);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    stage(0, rec_b);
    for (int s0 = 0, h = 0; s0 < M * T; s0 += S::NS, ++h) {
      const int s1 = min(M * T, s0 + S::NS);
      float* rec_s = rec_b + (h & 1) * S::SE * RF;
      if (s1 < M * T) {
        stage(s1, rec_b + ((h + 1) & 1) * S::SE * RF);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
#pragma unroll 1
      for (int k = s0 / T; k < M && k * T < s1; ++k) {
        const int ta = max(0, s0 - k * T), tb = min(T, s1 - k * T);
        const int jc = viba::rev_rt<LOGM>(k);
        if (ta == 0) {  // a class starts: rig outputs carry its partial across pairs
#pragma unroll
          for (int o = 0; o < NO; ++o) acc[o] = o < K ? my_yr[(jc * K + o) * 32] : 0.f;
        }
#pragma unroll 2
        for (int t = ta; t < tb && w + NW * jc + 32 * t < n_q; ++t) {
          const float* r = rec_s + ((k * T + t - s0) * NW + w) * RF;
          float j[Rec::nj];
          viba::load_j<K, KC>(r, j);
          const viba::RecTail tl = viba::load_tail<K, KC>(r);
          float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
          for (int a = 0; a < K; ++a) {
            u0 += j[2 * a] * xr[a];
            u1 += j[2 * a + 1] * xr[a];
          }
#pragma unroll
          for (int a = 0; a < KC; ++a) {
            v0 += j[2 * (K + a)] * xc[a];
            v1 += j[2 * (K + a) + 1] * xc[a];
          }
          const float* zp = z + 3L * C * tl.point + c;
          const float z0 = zp[0], z1 = zp[C], z2 = zp[2L * C];
          const float a0 = tl.p[0] * z0 + tl.p[2] * z1 + tl.p[4] * z2;
          const float a1 = tl.p[1] * z0 + tl.p[3] * z1 + tl.p[5] * z2;
          const float d0 = (u0 + v0) * tl.w - a0 * tl.w;
          const float d1 = (u1 + v1) * tl.w - a1 * tl.w;
#pragma unroll
          for (int o = 0; o < NO; ++o) acc[o] += j[2 * o] * d0 + j[2 * o + 1] * d1;
        }
        if (tb == T) {  // the class is done
#pragma unroll
          for (int o = 0; o < K; ++o) my_yr[(jc * K + o) * 32] = acc[o];
#pragma unroll
          for (int a = 0; a < KC; ++a) {
            float v = acc[K + a];
            int top = 0;  // LeafTree::push, the stack in shared memory
#pragma unroll
            for (int lvl = 0; lvl < LOGM; ++lvl) {
              if (((k >> lvl) & 1) && top == lvl) {
                v = my_st[(lvl * KC + a) * 32] + v;
                top = lvl + 1;
              }
            }
#pragma unroll
            for (int lvl = 0; lvl < LOGM; ++lvl) {
              if (lvl == top) my_st[(lvl * KC + a) * 32] = v;
            }
            if (k == M - 1) my_sub[(K + a) * 32] = v;
          }
        }
      }
      __syncthreads();
    }
    // the pair's window partials: the warps' subtrees in the butterfly's
    // order, warp w taking outputs a = w, w + NW, ...
    for (int a = w; a < KC; a += NW) {
      const float v = warp_tree8(sub_s + (K + a) * 32 + lane, NO * 32);
      if (live) part[((long)KC * pair_part[q] + a) * C + c] = v;
    }
    __syncthreads();
  }
  // the rig outputs: each warp's classes (bits 4 then 3 of the class), then
  // the warps
#pragma unroll
  for (int o = 0; o < K; ++o) {
    my_sub[o * 32] = (my_yr[(0 * K + o) * 32] + my_yr[(2 * K + o) * 32]) +
                     (my_yr[(1 * K + o) * 32] + my_yr[(3 * K + o) * 32]);
  }
  __syncthreads();
  for (int o = w; o < K; o += NW) {
    const float v = warp_tree8(sub_s + o * 32 + lane, NO * 32);
    if (live) y_r[((long)K * row + o) * C + c] = v;
  }
}

template <int K, int KC>
cudaError_t launch_rig_split_pass(int R, int C, const int* rig_pair, const int* pair_ptr,
                                  const int* pair_part, const int* rig_pos, const float* rec,
                                  const float* x_r, const float* x_c, const float* z,
                                  float* part, float* y_r, cudaStream_t st) {
  constexpr int smem = SplitCols<K, KC>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(rig_split_pass_cols<K, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (C + 31) / 32;
  rig_split_pass_cols<K, KC><<<R * n_tiles, 256, smem, st>>>(
      C, n_tiles, rig_pair, pair_ptr, pair_part, rig_pos, rec, x_r, x_c, z, part, y_r);
  return cudaGetLastError();
}

template <int K, int KC>
cudaError_t pcg_cal_cols_fused(int R, int L, int n_c, int C, int rig_sorted, const int* rig_pair,
                               const int* pair_ptr, const int* pair_part, const int* win_pair,
                               const int* rig_pos, const int* pt_ptr, const float* rec,
                               const float* x_r, const float* x_c, const float* hinv, float* z,
                               float* part, float* y_r, float* y_c, cudaStream_t st) {
  cudaError_t err =
      viba::launch_point_pass_cols<K, KC>(L, C, rig_sorted, pt_ptr, rec, x_r, x_c, hinv, z, st);
  if (err != cudaSuccess) return err;
  if (R > 0) {
    switch (viba::col_width(C)) {
      case 1:
        err = launch_rig_pair_pass<K, KC, 1>(R, C, rig_pair, pair_ptr, pair_part, rig_pos, rec,
                                             x_r, x_c, z, part, y_r, st);
        break;
      case 8:
        err = launch_rig_pair_pass<K, KC, 8>(R, C, rig_pair, pair_ptr, pair_part, rig_pos, rec,
                                             x_r, x_c, z, part, y_r, st);
        break;
      default:
        err = launch_rig_split_pass<K, KC>(R, C, rig_pair, pair_ptr, pair_part, rig_pos, rec, x_r,
                                           x_c, z, part, y_r, st);
    }
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_c, KC * C, win_pair, part, y_c, st);
}

// the column K9 at rig width K, dispatched on kc
template <int K>
int pcg_cal_cols_at(int R, int L, int n_c, int kc, int C, int rig_sorted, const int* rig_pair,
    const int* pair_ptr, const int* pair_part, const int* win_pair, const int* rig_pos,
    const int* pt_ptr, const float* rec, const float* x_r, const float* x_c,
    const float* hinv, float* z, float* part, float* y_r, float* y_c, cudaStream_t st) {
#define VIBA_PCG_COLS(KC)                                                                      \
  static_cast<int>(pcg_cal_cols_fused<K, KC>(R, L, n_c, C, rig_sorted, rig_pair, pair_ptr,     \
                                             pair_part, win_pair, rig_pos, pt_ptr, rec, x_r,    \
                                             x_c, hinv, z, part, y_r, y_c, st))
  return VIBA_DISPATCH_KC(kc, VIBA_PCG_COLS(6), VIBA_PCG_COLS(17), VIBA_PCG_COLS(23));
#undef VIBA_PCG_COLS
}

}  // namespace

// the two units' entries: rig width 6 (cal_pcg_cols.cu), 9 (cal_pcg_cols_k9.cu)
int viba_pcg_cal_cols_k6(int R, int L, int n_c, int kc, int C, int rig_sorted, const int* rig_pair,
    const int* pair_ptr, const int* pair_part, const int* win_pair, const int* rig_pos,
    const int* pt_ptr, const float* rec, const float* x_r, const float* x_c,
    const float* hinv, float* z, float* part, float* y_r, float* y_c, cudaStream_t st);
int viba_pcg_cal_cols_k9(int R, int L, int n_c, int kc, int C, int rig_sorted, const int* rig_pair,
    const int* pair_ptr, const int* pair_part, const int* win_pair, const int* rig_pos,
    const int* pt_ptr, const float* rec, const float* x_r, const float* x_c,
    const float* hinv, float* z, float* part, float* y_r, float* y_c, cudaStream_t st);
