// K6 / K5 / K4: the Schur-complement matvec passes of a rig-only batch.
//
// schur_down replaces _schur_down_kernel (JAX ops/segments.py:586);
// schur_up_rows replaces _schur_up_kernel (:725). K4, the PCG matvec
// y = J_r^T w J_r x - W H_ll^-1 W^T x (entry seg_schur_pcg :1387, Pallas
// bodies _down_light_kernel :1318 and _up_du_kernel :1347), is
// viba_schur_pcg below.
//
// K6, y = J_r^T w J_r x (optional) and t = W^T x = sum J_p^T w J_r x per
// landmark, is K4's down half around each slot's point-sorted position
// (pt_segments.cuh), in two launches, no memset and no staged wu:
//   want_y false  (the Schur right-hand side, rcs.w_transpose_x) K4's
//                 pcg_down: one thread per slot in slot order stores
//                 p = J_p^T w J_r x[rig] as one float4 at p[pt_pos[s]];
//   want_y true   schur_down_rows, a 128-thread group per rig row over its
//                 contiguous run of slots: the same p stored at pt_pos, and
//                 y = sum J_r^T w J_r x;
// then point_range_sum without the 3x3 solve: t = the sum of each
// landmark's contiguous range of p. Bound: bytes — J_r (8K B), J_p (24 B),
// w, rig or the row lists and pt_pos read once per slot, p (16 B) written
// and read once.
//
// K5, y = sum J_r^T w J_p z[pt] (= W z) per rig row, is one launch,
// schur_up_rows: a 128-thread group per rig row (its slots a contiguous
// run of the row's list), each thread taking its slots in batches of
// kUpBatch with every load of a batch issued before its first product, so
// that a row's ~330 slots (the bias headline's 1,200 rows) are one round of
// dependent loads (list, then J, w and the landmark index, then z) and not
// three; each thread sums its slots in order, then the group's butterfly
// and its warps in order. (A warp per row took 0.029 ms against 0.014 for
// K4's up pass on the H100: too few warps for the card.) Bound: bytes —
// J_r, J_p, w and the landmark index of each real slot, the rig lists and
// z read once, y written once; the L2 holds all of it across repeated
// calls, so it is timed with the L2 flushed.
// K = rig_k (6 or 9) is a template parameter, and so is TJ, J's element
// type in K4-K6: float, or bf16 for the PCG loop's copies
// (rcs.MATVEC_BF16; tile_reduce.cuh jf), which halve J's bytes in their
// bounds.
//
// K4 is one entry of three launches around each slot's point-sorted
// position (pt_segments.cuh), the design of K9 (cal_segments.cu) without
// the window columns:
//   down     one thread per slot: wu = w J_r x[rig[s]] in registers and
//            p = J_p^T wu, stored as one float4 at p[pt_pos[s]]; wu is not
//            stored. Every slot array is read in slot order (coalesced).
//   points   a 16-thread group per landmark: t = the sum of p over the
//            landmark's contiguous range, z = H_ll^-1[l] t.
//   up       a 128-thread group per rig row (its slots a contiguous run):
//            wu recomputed from J_r and the row's x in registers,
//            du = wu - w J_p z[point], y = sum J_r^T du. (A warp per rig row
//            took 0.029 ms against 0.014 on the H100 at the bias headline's
//            1,200 rows: too few warps to fill the card.)
// The landmark solve is a global barrier between the passes, so J_r and J_p
// are read twice (coalesced): no memset, no staged wu, no host work between
// the passes. Bound: bytes — ~2 x (8K + 24 + 12) B per real slot plus the
// 16 B of p written and read back.
//
// K4 on C right-hand sides (viba_schur_pcg_cols, the covariance columns:
// x and y are (R, K, C), one row's C values of a component contiguous) is
// two launches over the point-sorted slot records of the reduced system
// (pt_segments.cuh SlotRec, made once per system), each reading a slot's
// record once for a tile of W columns (32; 8 up to 8 columns; 1 for one)
// and writing nothing per (slot, column):
//   points   point_pass_cols (pt_segments.cuh): the down pass fused into
//            the landmark sums, z (L, 3, C) = H_ll^-1 W^T x;
//   rig      rig_row_pass_cols, four warps per (rig row, tile): the row's
//            records staged in shared memory a chunk at a time, each lane
//            computes du = w J_r x - w J_p z[point] for its slots and column
//            in registers and sums y = J_r^T du.
// Each column is summed in the single-column up pass's order: the 128
// lane classes of the row (slots i = cls, cls + 128, ... of the row's run)
// summed in order, each warp's 32 classes in the xor butterfly's tree, the
// four warps' totals in order. Warp wg takes the classes of the
// single-column group's warp wg; at W = 32 a lane runs all 32 of them for
// its column (depth first, LeafTree), at W = 1 the lanes are the classes,
// as in pcg_up. So every column has the single-column kernel's bits.
// Bound: operations — (8K + 30) FMA-equivalents a slot and column over the
// two passes.

#include "pt_segments.cuh"
#include "tile_reduce.cuh"

namespace {

using viba::kRowGroup;

// K6 with y: per rig row, y = sum J_r^T wu; p[pt_pos[s]] = J_p^T wu per slot
template <int K, class TJ>
__global__ void __launch_bounds__(viba::kBlock) schur_down_rows(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ pt_pos, const TJ* __restrict__ J_r, const TJ* __restrict__ J_p,
    const float* __restrict__ w, const float* __restrict__ x, float* __restrict__ y,
    float4* __restrict__ p) {
  const int row = blockIdx.x;  // one rig row per block (kRowGroup == kBlock)
  float xr[K];
#pragma unroll
  for (int c = 0; c < K; ++c) xr[c] = row < R ? x[K * (long)row + c] : 0.f;
  viba::reduce_segments<kRowGroup, K>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[K]) {
        float j0[K], j1[K], u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          j0[c] = viba::jf(J_r[c * (long)n + s]);
          j1[c] = viba::jf(J_r[(K + c) * (long)n + s]);
          u0 += j0[c] * xr[c];
          u1 += j1[c] * xr[c];
        }
        const float ws = w[s];
        const float wu0 = u0 * ws, wu1 = u1 * ws;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += j0[c] * wu0 + j1[c] * wu1;
        float q[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          q[c] = viba::jf(J_p[c * (long)n + s]) * wu0 + viba::jf(J_p[(3 + c) * (long)n + s]) * wu1;
        p[pt_pos[s]] = make_float4(q[0], q[1], q[2], 0.f);
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
      });
}

// K5: per rig row, y = sum J_r^T w J_p z[point] (see the file's head)
constexpr int kUpBatch = 4;

template <int K, class TJ>
__global__ void __launch_bounds__(viba::kBlock) schur_up_rows(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const TJ* __restrict__ J_r, const TJ* __restrict__ J_p,
    const float* __restrict__ w, const float* __restrict__ z, float* __restrict__ y) {
  constexpr int G = kRowGroup, B = kUpBatch;
  static_assert(G == viba::kBlock, "one rig row a block");
  __shared__ float smem[(G / 32) * K];
  const int row = blockIdx.x, lane = threadIdx.x;
  const int beg = rig_ptr[row], end = rig_ptr[row + 1];
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;
  for (int j0 = beg + lane; j0 < end; j0 += B * G) {
    // a slot past the row's end repeats slot j0 and adds nothing
    int s[B];
    bool ok[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      ok[b] = j0 + b * G < end;
      s[b] = rig_obs[ok[b] ? j0 + b * G : j0];
    }
    int pt[B];
    float ws[B], jp[B][6], jr[B][2 * K], zz[B][3];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      pt[b] = point[s[b]];
      ws[b] = w[s[b]];
#pragma unroll
      for (int c = 0; c < 6; ++c) jp[b][c] = viba::jf(J_p[c * (long)n + s[b]]);
#pragma unroll
      for (int c = 0; c < 2 * K; ++c) jr[b][c] = viba::jf(J_r[c * (long)n + s[b]]);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
#pragma unroll
      for (int c = 0; c < 3; ++c) zz[b][c] = z[3 * (long)pt[b] + c];
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (ok[b]) {
        const float u0 = jp[b][0] * zz[b][0] + jp[b][1] * zz[b][1] + jp[b][2] * zz[b][2];
        const float u1 = jp[b][3] * zz[b][0] + jp[b][4] * zz[b][1] + jp[b][5] * zz[b][2];
        const float d0 = u0 * ws[b], d1 = u1 * ws[b];
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += jr[b][c] * d0 + jr[b][K + c] * d1;
      }
    }
  }
  viba::group_sum<G, K>(acc, smem);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) y[K * (long)row + c] = acc[c];
  }
}

// K4 down: p[pt_pos[s]] = J_p^T w J_r x[rig[s]] per real slot
template <int K, class TJ>
__global__ void __launch_bounds__(256) pcg_down(int n, const int* __restrict__ rig,
                                                const int* __restrict__ pt_pos,
                                                const TJ* __restrict__ J_r,
                                                const TJ* __restrict__ J_p,
                                                const float* __restrict__ w,
                                                const float* __restrict__ x,
                                                float4* __restrict__ p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int pos = pt_pos[s];
  if (pos < 0) return;
  const float* xr = x + K * (long)rig[s];
  float u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float xv = xr[c];
    u0 += viba::jf(J_r[c * (long)n + s]) * xv;
    u1 += viba::jf(J_r[(K + c) * (long)n + s]) * xv;
  }
  const float ws = w[s];
  const float wu0 = u0 * ws, wu1 = u1 * ws;
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = viba::jf(J_p[c * (long)n + s]) * wu0 + viba::jf(J_p[(3 + c) * (long)n + s]) * wu1;
  p[pos] = make_float4(q[0], q[1], q[2], 0.f);
}

// K4 up: per rig row, du = w J_r x_r - w J_p z[point] per slot (wu
// recomputed), y = sum J_r^T du
template <int K, class TJ>
__global__ void __launch_bounds__(viba::kBlock) pcg_up(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const TJ* __restrict__ J_r, const TJ* __restrict__ J_p,
    const float* __restrict__ w, const float* __restrict__ x, const float* __restrict__ z,
    float* __restrict__ y) {
  const int row = blockIdx.x;  // one rig row per block (kRowGroup == kBlock)
  float xr[K];
#pragma unroll
  for (int c = 0; c < K; ++c) xr[c] = row < R ? x[K * (long)row + c] : 0.f;
  viba::reduce_segments<kRowGroup, K>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[K]) {
        float j0[K], j1[K], u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          j0[c] = viba::jf(J_r[c * (long)n + s]);
          j1[c] = viba::jf(J_r[(K + c) * (long)n + s]);
          u0 += j0[c] * xr[c];
          u1 += j1[c] * xr[c];
        }
        const float* zp = z + 3 * (long)point[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float a0 = viba::jf(J_p[s]) * z0 + viba::jf(J_p[(long)n + s]) * z1 +
                         viba::jf(J_p[2 * (long)n + s]) * z2;
        const float a1 = viba::jf(J_p[3 * (long)n + s]) * z0 +
                         viba::jf(J_p[4 * (long)n + s]) * z1 + viba::jf(J_p[5 * (long)n + s]) * z2;
        const float ws = w[s];
        const float d0 = u0 * ws - a0 * ws, d1 = u1 * ws - a1 * ws;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += j0[c] * d0 + j1[c] * d1;
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
      });
}

// K4 columns, rig pass: shapes of a block per (rig row, tile of W columns)
template <int K, int W>
struct RowCols {
  static constexpr int NWG = kRowGroup / 32;  // the single-column group's warps
  static constexpr int P = 32 / W, M = W, LOGM = viba::log2i(M);
  static constexpr int RF = viba::SlotRec<K, 0>::floats;
  static constexpr int SE = 256;               // entries a chunk
  static constexpr int NS = SE / (NWG * P);    // steps a chunk
  // staged records, each warp-group's totals
  static constexpr int smem_bytes = SE * RF * 4 + NWG * K * 32 * 4;
};

// K4 columns, rig pass: a block of four warps per (rig row, tile of W
// columns), warp wg the single-column group's warp wg. The row's slots run
// in chunks (pt_segments.cuh entry_slot), their records staged in shared
// memory; lane (column, phi) takes its M classes of warp-group wg depth
// first (LeafTree, across chunks), computing each slot's du for its column
// in registers (w J_r x_r - w J_p z[point], as the single-column up pass)
// and adding J_r^T du, the butterfly over the P physical lanes, then the
// four warp-groups' totals in order.
template <int K, int W>
__global__ void __launch_bounds__(128) rig_row_pass_cols(int C, int n_tiles,
                                                         const int* __restrict__ rig_ptr,
                                                         const int* __restrict__ rig_pos,
                                                         const float* __restrict__ rec,
                                                         const float* __restrict__ x_r,
                                                         const float* __restrict__ z,
                                                         float* __restrict__ y) {
  using S = RowCols<K, W>;
  using Rec = viba::SlotRec<K, 0>;
  constexpr int NWG = S::NWG, P = S::P, M = S::M, LOGM = S::LOGM, RF = S::RF;
  extern __shared__ float4 smem4[];
  float* rec_s = reinterpret_cast<float*>(smem4);  // (SE, RF)
  float* e_s = rec_s + S::SE * RF;                 // (NWG, K, 32 lanes)
  const int row = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int wg = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int phi = lane % P, c_tile = tile * W + lane / P;
  const bool live = c_tile < C;
  const int c = live ? c_tile : 0;  // the loads of a lane past C stay in bounds
  float xr[K];
#pragma unroll
  for (int a = 0; a < K; ++a) xr[a] = live ? x_r[((long)K * row + a) * C + c] : 0.f;
  const int beg = rig_ptr[row], n_r = rig_ptr[row + 1] - beg;
  const int T = (n_r + 32 * NWG - 1) / (32 * NWG);
  viba::LeafTree<M, K> tree;
  float acc[K], e[K];
#pragma unroll
  for (int a = 0; a < K; ++a) acc[a] = e[a] = 0.f;
  for (int s0 = 0; s0 < M * T; s0 += S::NS) {
    const int s1 = min(M * T, s0 + S::NS), n_e = (s1 - s0) * NWG * P;
    viba::stage_records<NWG, P, LOGM, RF>(rec_s, rec, rig_pos + beg, n_r, n_e, s0, T);
#pragma unroll 1
    for (int k = max(0, s0 / T); k < M && k * T < s1; ++k) {
      const int ta = max(0, s0 - k * T), tb = min(T, s1 - k * T);
      if (ta == 0) {
#pragma unroll
        for (int a = 0; a < K; ++a) acc[a] = 0.f;
      }
      const int cls = 32 * wg + phi + P * viba::rev_rt<LOGM>(k);
#pragma unroll 2
      for (int t = ta; t < tb && cls + 32 * NWG * t < n_r; ++t) {
        const float* r = rec_s + (((k * T + t - s0) * NWG + wg) * P + phi) * RF;
        float j[Rec::nj];
        viba::load_j<K, 0>(r, j);
        const viba::RecTail tl = viba::load_tail<K, 0>(r);
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int a = 0; a < K; ++a) {
          u0 += j[2 * a] * xr[a];
          u1 += j[2 * a + 1] * xr[a];
        }
        const float* zp = z + 3L * C * tl.point + c;
        const float z0 = zp[0], z1 = zp[C], z2 = zp[2L * C];
        const float a0 = tl.p[0] * z0 + tl.p[2] * z1 + tl.p[4] * z2;
        const float a1 = tl.p[1] * z0 + tl.p[3] * z1 + tl.p[5] * z2;
        const float d0 = u0 * tl.w - a0 * tl.w, d1 = u1 * tl.w - a1 * tl.w;
#pragma unroll
        for (int a = 0; a < K; ++a) acc[a] += j[2 * a] * d0 + j[2 * a + 1] * d1;
      }
      if (tb == T) {
        tree.push(k, acc);
        if (k == M - 1) {
#pragma unroll
          for (int a = 0; a < K; ++a) e[a] = acc[a];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < K; ++a) e[a] += __shfl_xor_sync(0xffffffffu, e[a], off);
  }
#pragma unroll
  for (int a = 0; a < K; ++a) e_s[(wg * K + a) * 32 + lane] = e[a];
  __syncthreads();
  if (wg == 0 && live && phi == 0) {
#pragma unroll
    for (int a = 0; a < K; ++a) {
      float total = e_s[a * 32 + lane];
#pragma unroll
      for (int w2 = 1; w2 < NWG; ++w2) total = total + e_s[(w2 * K + a) * 32 + lane];
      y[((long)K * row + a) * C + c] = total;
    }
  }
}

template <int K, int W>
cudaError_t launch_rig_row_pass(int R, int C, const int* rig_ptr, const int* rig_pos,
                                const float* rec, const float* x, const float* z, float* y,
                                cudaStream_t st) {
  constexpr int smem = RowCols<K, W>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(rig_row_pass_cols<K, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (C + W - 1) / W;
  rig_row_pass_cols<K, W><<<R * n_tiles, 32 * RowCols<K, W>::NWG, smem, st>>>(
      C, n_tiles, rig_ptr, rig_pos, rec, x, z, y);
  return cudaGetLastError();
}

template <int K>
cudaError_t schur_pcg_cols_fused(int R, int L, int C, int rig_sorted, const int* rig_ptr,
                                 const int* rig_pos, const int* pt_ptr, const float* rec,
                                 const float* x, const float* hinv, float* z, float* y,
                                 cudaStream_t st) {
  cudaError_t err = viba::launch_point_pass_cols<K, 0>(L, C, rig_sorted, pt_ptr, rec, x, nullptr,
                                                       hinv, z, st);
  if (err != cudaSuccess || R <= 0) return err;
  switch (viba::col_width(C)) {
    case 1:
      return launch_rig_row_pass<K, 1>(R, C, rig_ptr, rig_pos, rec, x, z, y, st);
    case 8:
      return launch_rig_row_pass<K, 8>(R, C, rig_ptr, rig_pos, rec, x, z, y, st);
    default:
      return launch_rig_row_pass<K, 32>(R, C, rig_ptr, rig_pos, rec, x, z, y, st);
  }
}

template <int K, class TJ>
cudaError_t schur_pcg(int R, int L, int n, int n_real, const int* rig, const int* point,
                      const int* pt_pos, const int* pt_ptr, const int* rig_ptr,
                      const int* rig_obs, const TJ* J_r, const TJ* J_p, const float* w,
                      const float* x, const float* hinv, float4* p, float* z, float* y,
                      cudaStream_t st) {
  if (n_real > 0) {
    pcg_down<K, TJ><<<(n + 255) / 256, 256, 0, st>>>(n, rig, pt_pos, J_r, J_p, w, x, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = viba::launch_point_range_sum(L, pt_ptr, p, hinv, z, st);
  if (err != cudaSuccess || R <= 0) return err;
  pcg_up<K, TJ><<<viba::segment_blocks<kRowGroup>(R), viba::kBlock, 0, st>>>(
      R, n, rig_ptr, rig_obs, point, J_r, J_p, w, x, z, y);
  return cudaGetLastError();
}

// K6 (both launches) for J of element type TJ
template <class TJ>
cudaError_t schur_down_typed(int R, int L, int n, int n_real, int k, int want_y, const int* rig,
                             const int* pt_pos, const int* pt_ptr, const int* rig_ptr,
                             const int* rig_obs, const void* J_r, const void* J_p,
                             const float* w, const float* x, float* y, float* t, float4* p4,
                             cudaStream_t st) {
  const TJ* jr = static_cast<const TJ*>(J_r);
  const TJ* jp = static_cast<const TJ*>(J_p);
  if (k != 6 && k != 9) return cudaErrorInvalidValue;
  if (want_y && R > 0) {
    const int grid = viba::segment_blocks<kRowGroup>(R);
    if (k == 6) {
      schur_down_rows<6, TJ><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, pt_pos, jr,
                                                            jp, w, x, y, p4);
    } else {
      schur_down_rows<9, TJ><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, pt_pos, jr,
                                                            jp, w, x, y, p4);
    }
  } else if (!want_y && n_real > 0) {
    const int grid = (n + 255) / 256;
    if (k == 6) {
      pcg_down<6, TJ><<<grid, 256, 0, st>>>(n, rig, pt_pos, jr, jp, w, x, p4);
    } else {
      pcg_down<9, TJ><<<grid, 256, 0, st>>>(n, rig, pt_pos, jr, jp, w, x, p4);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return viba::launch_point_sums(L, pt_ptr, p4, t, st);
}

// K5 for J of element type TJ
template <class TJ>
cudaError_t schur_up_typed(int R, int n, int k, const int* rig_ptr, const int* rig_obs,
                           const int* point, const void* J_r, const void* J_p, const float* w,
                           const float* z, float* y, cudaStream_t st) {
  const TJ* jr = static_cast<const TJ*>(J_r);
  const TJ* jp = static_cast<const TJ*>(J_p);
  if (k == 6) {
    schur_up_rows<6, TJ><<<R, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, jr, jp, w, z,
                                                     y);
  } else if (k == 9) {
    schur_up_rows<9, TJ><<<R, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, jr, jp, w, z,
                                                     y);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K4 (three launches) for J of element type TJ
template <class TJ>
cudaError_t schur_pcg_typed(int R, int L, int n, int n_real, int k, const int* rig,
                            const int* point, const int* pt_pos, const int* pt_ptr,
                            const int* rig_ptr, const int* rig_obs, const void* J_r,
                            const void* J_p, const float* w, const float* x, const float* hinv,
                            float4* p4, float* z, float* y, cudaStream_t st) {
  const TJ* jr = static_cast<const TJ*>(J_r);
  const TJ* jp = static_cast<const TJ*>(J_p);
  if (k == 6) {
    return schur_pcg<6, TJ>(R, L, n, n_real, rig, point, pt_pos, pt_ptr, rig_ptr, rig_obs, jr,
                            jp, w, x, hinv, p4, z, y, st);
  }
  if (k == 9) {
    return schur_pcg<9, TJ>(R, L, n, n_real, rig, point, pt_pos, pt_ptr, rig_ptr, rig_obs, jr,
                            jp, w, x, hinv, p4, z, y, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// jt: the J type code of the K4-K6 entries (VIBA_BY_JTYPE)
extern "C" int viba_schur_down(int R, int L, int n, int n_real, int k, int jt, int want_y,
                               const int* rig, const int* pt_pos, const int* pt_ptr,
                               const int* rig_ptr, const int* rig_obs, const void* J_r,
                               const void* J_p, const float* w, const float* x, float* y,
                               float* t, float* p, void* stream) {
  return VIBA_BY_JTYPE(jt, schur_down_typed, R, L, n, n_real, k, want_y, rig, pt_pos, pt_ptr,
                       rig_ptr, rig_obs, J_r, J_p, w, x, y, t, reinterpret_cast<float4*>(p),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int viba_schur_up(int R, int n, int k, int jt, const int* rig_ptr, const int* rig_obs,
                             const int* point, const void* J_r, const void* J_p,
                             const float* w, const float* z, float* y, void* stream) {
  if (R <= 0) return 0;
  return VIBA_BY_JTYPE(jt, schur_up_typed, R, n, k, rig_ptr, rig_obs, point, J_r, J_p, w, z, y,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int viba_schur_pcg(int R, int L, int n, int n_real, int k, int jt, const int* rig,
                              const int* point, const int* pt_pos, const int* pt_ptr,
                              const int* rig_ptr, const int* rig_obs, const void* J_r,
                              const void* J_p, const float* w, const float* x, const float* hinv,
                              float* p, float* z, float* y, void* stream) {
  return VIBA_BY_JTYPE(jt, schur_pcg_typed, R, L, n, n_real, k, rig, point, pt_pos, pt_ptr,
                       rig_ptr, rig_obs, J_r, J_p, w, x, hinv, reinterpret_cast<float4*>(p), z, y,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int viba_schur_pcg_cols(int R, int L, int k, int C, int rig_sorted,
                                   const int* rig_ptr, const int* rig_pos, const int* pt_ptr,
                                   const float* rec, const float* x, const float* hinv, float* z,
                                   float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 6) {
    return static_cast<int>(schur_pcg_cols_fused<6>(R, L, C, rig_sorted, rig_ptr, rig_pos, pt_ptr,
                                                    rec, x, hinv, z, y, st));
  }
  if (k == 9) {
    return static_cast<int>(schur_pcg_cols_fused<9>(R, L, C, rig_sorted, rig_ptr, rig_pos, pt_ptr,
                                                    rec, x, hinv, z, y, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* viba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
