// K6 / K5 / K4: the Schur-complement matvec passes of a rig-only batch.
//
// schur_down replaces _schur_down_kernel (JAX ops/segments.py:586);
// schur_up replaces _schur_up_kernel (:725). K4, the PCG matvec
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
// and read once. schur_down_points (a 16-thread group per landmark
// gathering J_p and a staged wu through its list) is K10's landmark pass
// (cal_segments.cu).
// schur_up (K5), a 128-thread group per rig row:
//   y = sum J_r^T w J_p z[pt]  (= W z).
// K = rig_k (6 or 9) is a template parameter.
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
//
// The tiled design it replaced (viba_schur_pcg_cols_tiles), kept as the
// yardstick until the next change to these kernels, runs the same three
// passes once per tile of kColTile columns (pt_segments.cuh): the down
// pass, kColTile threads a slot (one column each), stores
// p[pt_pos[s] * kColTile + c]; the landmark pass sums each column and
// writes z (L, kColTile, 3); the up pass keeps K x kColTile sums a rig
// row, each thread loading its slot's J once a tile. Bound: bytes — per
// column, 2 x (8K + 36) / kColTile B of J a slot, the 32 B of
// p written and read back, and 12 B of z read.
#include "pt_segments.cuh"
#include "tile_reduce.cuh"

namespace {

using viba::kPointGroup;
using viba::kRowGroup;

// K6 with y: per rig row, y = sum J_r^T wu; p[pt_pos[s]] = J_p^T wu per slot
template <int K>
__global__ void __launch_bounds__(viba::kBlock) schur_down_rows(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ pt_pos, const float* __restrict__ J_r, const float* __restrict__ J_p,
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
          j0[c] = J_r[c * (long)n + s];
          j1[c] = J_r[(K + c) * (long)n + s];
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
          q[c] = J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
        p[pt_pos[s]] = make_float4(q[0], q[1], q[2], 0.f);
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
      });
}

__global__ void __launch_bounds__(viba::kBlock) schur_down_points(
    int L, int n, const int* __restrict__ pt_ptr, const int* __restrict__ pt_obs,
    const float* __restrict__ J_p, const float* __restrict__ wu, float* __restrict__ t) {
  viba::reduce_segments<kPointGroup, 3>(
      blockIdx.x, L, pt_ptr, pt_obs,
      [&](int s, float(&acc)[3]) {
        const float wu0 = wu[s], wu1 = wu[n + s];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[c] += J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
      },
      [&](int p, float(&acc)[3]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) t[3 * (long)p + c] = acc[c];
      });
}

template <int K>
__global__ void __launch_bounds__(viba::kBlock) schur_up(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ z,
    float* __restrict__ y) {
  viba::reduce_segments<kRowGroup, K>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[K]) {
        const float* zp = z + 3 * (long)point[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float u0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
        const float u1 =
            J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
        const float ws = w[s];
        const float d0 = u0 * ws, d1 = u1 * ws;
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] += J_r[c * (long)n + s] * d0 + J_r[(K + c) * (long)n + s] * d1;
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y[K * (long)r + c] = acc[c];
      });
}

// K4 down: p[pt_pos[s]] = J_p^T w J_r x[rig[s]] per real slot
template <int K>
__global__ void __launch_bounds__(256) pcg_down(int n, const int* __restrict__ rig,
                                                const int* __restrict__ pt_pos,
                                                const float* __restrict__ J_r,
                                                const float* __restrict__ J_p,
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
    u0 += J_r[c * (long)n + s] * xv;
    u1 += J_r[(K + c) * (long)n + s] * xv;
  }
  const float ws = w[s];
  const float wu0 = u0 * ws, wu1 = u1 * ws;
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
  p[pos] = make_float4(q[0], q[1], q[2], 0.f);
}

// K4 up: per rig row, du = w J_r x_r - w J_p z[point] per slot (wu
// recomputed), y = sum J_r^T du
template <int K>
__global__ void __launch_bounds__(viba::kBlock) pcg_up(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r, const float* __restrict__ J_p,
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
          j0[c] = J_r[c * (long)n + s];
          j1[c] = J_r[(K + c) * (long)n + s];
          u0 += j0[c] * xr[c];
          u1 += j1[c] * xr[c];
        }
        const float* zp = z + 3 * (long)point[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float a0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
        const float a1 =
            J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
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

// K4 columns, down: p[pt_pos[s] * CT + c] = J_p^T w J_r x[rig[s], :, c0 + c];
// CT consecutive threads per slot, one column each, so a warp's x loads and
// its float4 stores of p are contiguous runs (the slot's J loads broadcast)
template <int K, int CT>
__global__ void __launch_bounds__(256) pcg_down_cols(int n, int C, int c0, int ncol,
                                                     const int* __restrict__ rig,
                                                     const int* __restrict__ pt_pos,
                                                     const float* __restrict__ J_r,
                                                     const float* __restrict__ J_p,
                                                     const float* __restrict__ w,
                                                     const float* __restrict__ x,
                                                     float4* __restrict__ p) {
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const int s = static_cast<int>(t / CT), c = static_cast<int>(t % CT);
  if (s >= n || c >= ncol) return;
  const int pos = pt_pos[s];
  if (pos < 0) return;
  const float* xr = x + (long)K * C * rig[s] + c0 + c;
  float u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const float xv = xr[(long)a * C];
    u0 += J_r[a * (long)n + s] * xv;
    u1 += J_r[(K + a) * (long)n + s] * xv;
  }
  const float ws = w[s];
  const float wu0 = u0 * ws, wu1 = u1 * ws;
  float q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    q[a] = J_p[a * (long)n + s] * wu0 + J_p[(3 + a) * (long)n + s] * wu1;
  p[(long)pos * CT + c] = make_float4(q[0], q[1], q[2], 0.f);
}

// K4 columns, up: per rig row and column, du = w J_r x - w J_p z[point],
// y[row, :, c0 + c] = sum J_r^T du
template <int K, int CT>
__global__ void __launch_bounds__(viba::kBlock) pcg_up_cols(
    int R, int n, int C, int c0, int ncol, const int* __restrict__ rig_ptr,
    const int* __restrict__ rig_obs, const int* __restrict__ point,
    const float* __restrict__ J_r, const float* __restrict__ J_p, const float* __restrict__ w,
    const float* __restrict__ x, const float* __restrict__ z, float* __restrict__ y) {
  const int row = blockIdx.x;  // one rig row per block (kRowGroup == kBlock)
  const float* xr = x + (long)K * C * (row < R ? row : 0) + c0;
  viba::reduce_segments<kRowGroup, K * CT>(
      blockIdx.x, R, rig_ptr, rig_obs,
      [&](int s, float(&acc)[K * CT]) {
        float j0[K], j1[K];
#pragma unroll
        for (int a = 0; a < K; ++a) {
          j0[a] = J_r[a * (long)n + s];
          j1[a] = J_r[(K + a) * (long)n + s];
        }
        float jp[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) jp[a] = J_p[a * (long)n + s];
        const float ws = w[s];
        const float* zp = z + 3 * (long)CT * point[s];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (c < ncol) {
            float u0 = 0.f, u1 = 0.f;
#pragma unroll
            for (int a = 0; a < K; ++a) {
              const float xv = xr[(long)a * C + c];
              u0 += j0[a] * xv;
              u1 += j1[a] * xv;
            }
            const float z0 = zp[3 * c], z1 = zp[3 * c + 1], z2 = zp[3 * c + 2];
            const float a0 = jp[0] * z0 + jp[1] * z1 + jp[2] * z2;
            const float a1 = jp[3] * z0 + jp[4] * z1 + jp[5] * z2;
            const float d0 = u0 * ws - a0 * ws, d1 = u1 * ws - a1 * ws;
#pragma unroll
            for (int a = 0; a < K; ++a) acc[c * K + a] += j0[a] * d0 + j1[a] * d1;
          }
        }
      },
      [&](int r, float(&acc)[K * CT]) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (c < ncol) {
#pragma unroll
            for (int a = 0; a < K; ++a) y[((long)K * r + a) * C + c0 + c] = acc[c * K + a];
          }
        }
      });
}

template <int K>
cudaError_t schur_pcg_cols(int R, int L, int n, int n_real, int C, const int* rig,
                           const int* point, const int* pt_pos, const int* pt_ptr,
                           const int* rig_ptr, const int* rig_obs, const float* J_r,
                           const float* J_p, const float* w, const float* x, const float* hinv,
                           float4* p, float* z, float* y, cudaStream_t st) {
  constexpr int CT = viba::kColTile;
  for (int c0 = 0; c0 < C; c0 += CT) {
    const int ncol = C - c0 < CT ? C - c0 : CT;
    if (n_real > 0) {
      pcg_down_cols<K, CT><<<static_cast<int>(((long)n * CT + 255) / 256), 256, 0, st>>>(
          n, C, c0, ncol, rig, pt_pos, J_r, J_p, w, x, p);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    cudaError_t err = viba::launch_point_range_sum_cols<CT>(L, ncol, pt_ptr, p, hinv, z, st);
    if (err != cudaSuccess) return err;
    if (R > 0) {
      pcg_up_cols<K, CT><<<viba::segment_blocks<kRowGroup>(R), viba::kBlock, 0, st>>>(
          R, n, C, c0, ncol, rig_ptr, rig_obs, point, J_r, J_p, w, x, z, y);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
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

template <int K>
cudaError_t schur_pcg(int R, int L, int n, int n_real, const int* rig, const int* point,
                      const int* pt_pos, const int* pt_ptr, const int* rig_ptr,
                      const int* rig_obs, const float* J_r, const float* J_p, const float* w,
                      const float* x, const float* hinv, float4* p, float* z, float* y,
                      cudaStream_t st) {
  if (n_real > 0) {
    pcg_down<K><<<(n + 255) / 256, 256, 0, st>>>(n, rig, pt_pos, J_r, J_p, w, x, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = viba::launch_point_range_sum(L, pt_ptr, p, hinv, z, st);
  if (err != cudaSuccess || R <= 0) return err;
  pcg_up<K><<<viba::segment_blocks<kRowGroup>(R), viba::kBlock, 0, st>>>(
      R, n, rig_ptr, rig_obs, point, J_r, J_p, w, x, z, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" int viba_schur_down_points(int L, int n, const int* pt_ptr, const int* pt_obs,
                                      const float* J_p, const float* wu, float* t,
                                      void* stream) {
  if (L <= 0) return 0;
  schur_down_points<<<viba::segment_blocks<kPointGroup>(L), viba::kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(L, n, pt_ptr, pt_obs, J_p, wu, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_schur_down(int R, int L, int n, int n_real, int k, int want_y,
                               const int* rig, const int* pt_pos, const int* pt_ptr,
                               const int* rig_ptr, const int* rig_obs, const float* J_r,
                               const float* J_p, const float* w, const float* x, float* y,
                               float* t, float* p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(p);
  if (k != 6 && k != 9) return static_cast<int>(cudaErrorInvalidValue);
  if (want_y && R > 0) {
    const int grid = viba::segment_blocks<kRowGroup>(R);
    if (k == 6) {
      schur_down_rows<6><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, pt_pos, J_r, J_p,
                                                        w, x, y, p4);
    } else {
      schur_down_rows<9><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, pt_pos, J_r, J_p,
                                                        w, x, y, p4);
    }
  } else if (!want_y && n_real > 0) {
    const int grid = (n + 255) / 256;
    if (k == 6) {
      pcg_down<6><<<grid, 256, 0, st>>>(n, rig, pt_pos, J_r, J_p, w, x, p4);
    } else {
      pcg_down<9><<<grid, 256, 0, st>>>(n, rig, pt_pos, J_r, J_p, w, x, p4);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(viba::launch_point_sums(L, pt_ptr, p4, t, st));
}

extern "C" int viba_schur_up(int R, int n, int k, const int* rig_ptr, const int* rig_obs,
                             const int* point, const float* J_r, const float* J_p,
                             const float* w, const float* z, float* y, void* stream) {
  if (R <= 0) return 0;
  const int grid = viba::segment_blocks<kRowGroup>(R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 6) {
    schur_up<6><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w, z,
                                               y);
  } else if (k == 9) {
    schur_up<9><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w, z,
                                               y);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viba_schur_pcg(int R, int L, int n, int n_real, int k, const int* rig,
                              const int* point, const int* pt_pos, const int* pt_ptr,
                              const int* rig_ptr, const int* rig_obs,
                              const float* J_r, const float* J_p, const float* w,
                              const float* x, const float* hinv, float* p, float* z, float* y,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(p);
  if (k == 6) {
    return static_cast<int>(schur_pcg<6>(R, L, n, n_real, rig, point, pt_pos, pt_ptr,
                                         rig_ptr, rig_obs, J_r, J_p, w, x, hinv, p4, z, y, st));
  }
  if (k == 9) {
    return static_cast<int>(schur_pcg<9>(R, L, n, n_real, rig, point, pt_pos, pt_ptr,
                                         rig_ptr, rig_obs, J_r, J_p, w, x, hinv, p4, z, y, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" int viba_schur_pcg_cols_tiles(int R, int L, int n, int n_real, int k, int C,
                                         const int* rig, const int* point, const int* pt_pos,
                                         const int* pt_ptr, const int* rig_ptr,
                                         const int* rig_obs, const float* J_r, const float* J_p,
                                         const float* w, const float* x, const float* hinv,
                                         float* p, float* z, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(p);
  if (k == 6) {
    return static_cast<int>(schur_pcg_cols<6>(R, L, n, n_real, C, rig, point, pt_pos, pt_ptr,
                                              rig_ptr, rig_obs, J_r, J_p, w, x, hinv, p4, z, y,
                                              st));
  }
  if (k == 9) {
    return static_cast<int>(schur_pcg_cols<9>(R, L, n, n_real, C, rig, point, pt_pos, pt_ptr,
                                              rig_ptr, rig_obs, J_r, J_p, w, x, hinv, p4, z, y,
                                              st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* viba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
