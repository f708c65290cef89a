// K8 / K9 / K10: segment kernels of a calibration-coupled visual batch.
//
// The batch couples, besides rigs (J_r, K = rig_k columns) and landmarks
// (J_p, 3 columns), the calibration-window variables of each observation's
// window row (J_c, kc columns in the batch's cal_groups order: cam extr 6 |
// cam intr 17, or one of the two alone, kc = 23, 6 or 17 — a template
// parameter of the window kernels, dispatched on the runtime kc). Replaces the
// Pallas kernels _assemble_cal_kernel (JAX ops/segments.py:1674, entry
// seg_assemble_cal :1741), _schur_down_cal_kernel (:1005) and
// _schur_up_cal_kernel (:1146) (K10), and _down_light_cal_kernel (:1468) +
// _up_du_cal_kernel (:1519) (K9, the PCG matvec, entry viba_schur_pcg_cal
// below).
//
// Window rows are few and long (120 rows of ~15k observations at the
// full-sensor size): one group per row would leave most of the card idle.
// K8 cuts each row's slot list into chunks of at most CHUNK slots
// (ops/segments.py) whose partial rows a second pass sums in chunk order;
// K9 and K10 walk each rig row's (rig, window row) pairs and write one
// partial row a pair, which a second pass sums in rig order. Landmark rows
// (~30 observations) are summed over each slot's point-sorted position
// (pt_segments.cuh). Deterministic, no atomics.
//
// K8 (viba_assemble_cal) is three launches: K2's first (assemble_rig.cuh: the
// rig rows, and each slot's landmark-side sector at its point-sorted
// position), then
//   window   one 256-thread block per chunk, two blocks an SM. The chunk's
//            slots come into shared memory in stages of 256 (J_c's 2 x kc
//            columns, the residual, w; a slot a thread, cp.async into one of
//            two buffers while the warps reduce the other, ~52 kB a stage at
//            kc = 23), and every output of the window row (g_c and the upper
//            triangle of each split's self block: 197 at kc = 23, 170 at
//            kc = 17, 27 at kc = 6) comes from that one read of J_c. The
//            outputs are cut into 3x3 register tiles (items: the split
//            blocks' upper tiles, 3 gradient entries each); warp q owns items
//            q, q + 8, q + 16, q + 24, its 32 lanes 4 slots of each 128-slot
//            step each (one float4 a column), and sums each item with a
//            fixed butterfly at the end. The item is a runtime value the
//            whole warp shares, so all warps run one short code path per
//            kind. Device time of the window pass at kc = 23 on one H100
//            80GB HBM3 at 700 W (chip_smoke.py): 0.215 ms. Measured and
//            dropped: 128-slot tiles with each warp's items unrolled into
//            its own code, 0.384 ms; half chunks staged behind one barrier,
//            no copy in flight while reducing, 0.274 ms; 128-slot stages at
//            three blocks an SM, 0.199 ms but 36 B of spill; 512-slot stages
//            at one block an SM, 0.288 ms; the entries as two FMAs on w a,
//            0.212 ms (noise).
//   sum      one thread per entry of g_c, diag_c and the full symmetric
//            blocks (n_c, 6, 6) / (n_c, 17, 17): the row's chunk partials
//            summed in chunk order; the same launch's other blocks are K2's
//            second, 16 lanes per landmark summing its sectors (H_ll0 as
//            full 3x3 blocks), so that K2's two launches add none.
// Bound: bytes, J_c (2 x kc floats a slot) read once; FP32 FMA throughout
// (TF32 stays off). Shared-memory traffic, ~13 floats a slot per 3x3 tile
// (~1.3 kB a slot at kc = 23), is the second limit.
//
// K9, y = H x - W H_ll^-1 W^T x over rig and window columns, is one entry of
// four launches built around each slot's point-sorted position (pt_pos):
//   down     one thread per slot: wu = w (J_r x_r[rig] + J_c x_c[win]) and
//            p = J_p^T wu, stored at p[pt_pos[s]] (16 B, slot-major); wu is
//            not stored. Coalesced: every slot array is read in slot order.
//   points   a 16-thread group per landmark: t = the sum of p over the
//            landmark's contiguous range, z = H_ll^-1[l] t in registers
//            (pt_segments.cuh, shared with K4).
//   up       a warp per rig row, over the rig's (rig, window row) pairs
//            (ops/segments.py pair_plan_arrays): wu recomputed from J_r, J_c
//            and x (this pass reads them anyway), du = wu - w J_p z[point],
//            y_r = sum J_r^T du, and one partial row of sum J_c^T du per pair.
//   window   each window row's pair partials summed in rig order.
// The landmark solve is a global barrier between the passes, so J_r, J_c
// and J_p are read twice (coalesced): ~600 B per slot at k 9, kc 23, no
// staged wu and no window chunk lists.
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
//
// K10 (viba_schur_down_cal, viba_schur_up_cal), the Schur right-hand
// side, back-substitution and two-pass PCG matvec of a batch that the
// fused K9 does not take, reads each slot's J once a call, on the plans K9
// uses (pt_pos; the (rig, window row) pairs), and stores nothing per slot
// but the landmark side's 16 B:
//   down, t only (want_y false: rcs.w_transpose_x)   K9's pcg_cal_down (p =
//            J_p^T wu at p[pt_pos[s]]), then point_range_sum without the
//            3x3 solve: 2 launches;
//   down with y   cal_pair_pass<kDown>: a 128-thread group per rig row over
//            its pairs, x_r and the pair's x_c in registers; per slot wu =
//            w (J_r x_r + J_c x_c) from one read of J_r, J_c, J_p and w, p
//            stored at p[pt_pos[s]], y_r = sum J_r^T wu in registers, one
//            partial row of J_c^T wu a pair; then cal_down_sums, one launch
//            of the landmarks' sums of p (t) and the window rows' sums of
//            their pair partials (y_c): 2 launches;
//   up       cal_pair_pass<!kDown>: the same walk with wu = w J_p z[point]
//            in registers, then sum_partials over the pairs: 2 launches.
// A warp per rig row, pcg_cal_up's walk, left each lane ~9 slots of a rig
// one after another: the pass took 0.2818 / 0.2456 ms up / down with y at
// full against 0.2030 / 0.2034 for the group (chip_smoke on one H100,
// PERF.md).
// Bound: bytes — J_r, J_c, J_p and w of each real slot, the indices, x or
// z read once, the outputs written once; the down pass's p (16 B a slot)
// written and read back is its only staging.
#include "assemble_rig.cuh"
#include "pt_segments.cuh"
#include "tile_reduce.cuh"

extern "C" int viba_assemble_rows_slots(int R, int n, int k, const int* rig_ptr,
                                        const int* rig_obs, const int* pt_pos, const float* J_r,
                                        const float* J_p, const float* w, const float* res,
                                        float* g_r, float* diag_r, float* q, void* stream);

namespace {

// the window columns of a batch: cam extr (KE = 6 or 0) then cam intr
// (KI = 17 or 0), as the batch's cal_groups fold them (kc = 6, 17 or 23)
template <int KE, int KI>
struct Cal {
  static constexpr int kc = KE + KI;
  static constexpr int tri0 = kc, tri1 = kc + KE * (KE + 1) / 2;
  // K8 window outputs in order: g_c[0..kc), then the row-major upper
  // triangle of each split's self block
  static constexpr int out = tri1 + KI * (KI + 1) / 2;
};

// upper-triangle position of (a, b), a <= b, in a dim x dim block
__host__ __device__ constexpr int tri_index(int a, int b, int dim) {
  return a * dim - a * (a - 1) / 2 + (b - a);
}

constexpr int kCalThreads = 256;  // K8 window pass: 8 warps a block, 2 blocks an SM
constexpr int kCalSub = 256;      // slots a stage: a quarter of a chunk, a slot a thread
constexpr int kCalStep = 128;     // slots a warp takes per step: 32 lanes x 4

struct CalItem {
  int kind, a0, b0;  // kind 0: 3x3 tile, 1: diagonal tile, 2: 3 gradient entries
};

// K8's window outputs cut into 3x3 register tiles (items). In shared memory
// the columns are J_c's (extr KE, then intr padded with zeros to KIP, a
// multiple of 3) and the residual (column KP), each kCalSub slots long, then w.
template <int KE, int KI>
struct CalTiles {
  using C = Cal<KE, KI>;
  static constexpr int kc = KE + KI, KIP = (KI + 2) / 3 * 3, KP = KE + KIP, cols = KP + 1;
  static constexpr int nE = KE / 3, nI = KIP / 3, nG = (kc + 2) / 3;
  static constexpr int items = nE * (nE + 1) / 2 + nI * (nI + 1) / 2 + nG;
  static constexpr int stage_floats = (2 * cols + 1) * kCalSub;
  static constexpr int smem_bytes = 2 * stage_floats * 4;  // two stages in flight
  __host__ __device__ static constexpr CalItem item(int i) {
    for (int bi = 0; bi < nE; ++bi) {
      for (int bj = bi; bj < nE; ++bj) {
        if (i-- == 0) return {bi == bj ? 1 : 0, 3 * bi, 3 * bj};
      }
    }
    for (int bi = 0; bi < nI; ++bi) {
      for (int bj = bi; bj < nI; ++bj) {
        if (i-- == 0) return {bi == bj ? 1 : 0, KE + 3 * bi, KE + 3 * bj};
      }
    }
    return {2, 3 * i, KP};
  }
  // the partial-row position (Cal's output order) of entry e = 3 i + j of
  // item `it`, or -1 (lower half of a diagonal tile, padding)
  __host__ __device__ static constexpr int out_index(CalItem it, int e) {
    const int a = it.a0 + e / 3, b = it.b0 + e % 3;
    if (it.kind == 2) return (e % 3 == 0 && a < kc) ? a : -1;
    if (a > b) return -1;
    if (b < KE) return C::tri0 + tri_index(a, b, KE);
    return b - KE < KI ? C::tri1 + tri_index(a - KE, b - KE, KI) : -1;
  }
};

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc[3 i + j] += sum over a lane's 4 slots of w (a0_i b0_j + a1_i b1_j), the
// slots in order; a diagonal tile takes the rows i <= j
template <bool kDiag>
__device__ __forceinline__ void cal_tile_col(const float4 (&a)[2][3], const float4& w4,
                                             const float4& b0, const float4& b1, int j,
                                             float (&acc)[9]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float ws = lane4(w4, q);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (!kDiag || i <= j) {
        acc[3 * i + j] += (lane4(a[0][i], q) * ws) * lane4(b0, q) +
                          (lane4(a[1][i], q) * ws) * lane4(b1, q);
      }
    }
  }
}

// one item over a stage's slots, lane l taking slots 4l..4l+3 of each
// 128-slot step: acc += sum w J_c^T [J_c | res]. The item is the same for
// the whole warp, so each kind is one short code path shared by all warps;
// the a columns stay in registers, the b columns come one at a time.
template <class T>
__device__ __forceinline__ void cal_item(const float* sm, int lane, const CalItem& it,
                                         float (&acc)[9]) {
  const float* sw = sm + 2 * T::cols * kCalSub;
#pragma unroll 1
  for (int off = 4 * lane; off < kCalSub; off += kCalStep) {
    const auto col = [&](int d, int c) {
      return *reinterpret_cast<const float4*>(sm + (d * T::cols + c) * kCalSub + off);
    };
    const float4 w4 = *reinterpret_cast<const float4*>(sw + off);
    float4 a[2][3];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int i = 0; i < 3; ++i) a[d][i] = col(d, it.a0 + i);
    }
    if (it.kind == 2) {  // gradient entries: the b column is the residual
      const float4 r0 = col(0, T::KP), r1 = col(1, T::KP);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ws = lane4(w4, q);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          acc[3 * i] += (lane4(a[0][i], q) * ws) * lane4(r0, q) +
                        (lane4(a[1][i], q) * ws) * lane4(r1, q);
      }
    } else if (it.kind == 1) {  // diagonal tile: the b columns are the a columns
#pragma unroll
      for (int j = 0; j < 3; ++j) cal_tile_col<true>(a, w4, a[0][j], a[1][j], j, acc);
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 b0 = col(0, it.b0 + j), b1 = col(1, it.b0 + j);
        cal_tile_col<false>(a, w4, b0, b1, j, acc);
      }
    }
  }
}

using viba::cp_async4;

// K8 window pass: one block per chunk writes the chunk's partial row of all
// C::out outputs. Its slots come in stages of kCalSub (a slot a thread),
// copied with cp.async into one of two shared-memory buffers while the warps
// reduce the other (each stage's slot index read a stage ahead); warp q
// owns items q, q + 8, q + 16, q + 24 (in registers across the stages) and
// takes them one at a time in each stage.
template <int KE, int KI>
__global__ void __launch_bounds__(kCalThreads, 2) assemble_cal_window(
    int n, const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_obs,
    const float* __restrict__ J_c, const float* __restrict__ w, const float* __restrict__ res,
    float* __restrict__ part) {
  using T = CalTiles<KE, KI>;
  static_assert(kCalSub == kCalThreads, "a slot a thread");
  extern __shared__ float4 cal_smem[];
  float* const buf = reinterpret_cast<float*>(cal_smem);
  const int ch = blockIdx.x, j = threadIdx.x, lane = j % 32, warp = j / 32;
  const int beg = chunk_ptr[ch], end = chunk_ptr[ch + 1];
  const int stages = (end - beg + kCalSub - 1) / kCalSub;
#pragma unroll
  for (int b = 0; b < 2; ++b) {  // the padding columns stay zero
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int c = T::kc; c < T::KP; ++c)
        buf[b * T::stage_floats + (d * T::cols + c) * kCalSub + j] = 0.f;
    }
  }
  const auto slot = [&](int g) {  // this thread's slot of stage g, -1 past the chunk
    const int pos = beg + g * kCalSub + j;
    return pos < end ? chunk_obs[pos] : -1;
  };
  const auto stage = [&](int g, int s) {  // copy stage g into buffer g % 2
    const bool ok = s >= 0;
    const long sk = ok ? s : 0;
    float* dst = buf + (g % 2) * T::stage_floats + j;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int c = 0; c < T::kc; ++c)
        cp_async4(dst + (d * T::cols + c) * kCalSub, J_c + (d * T::kc + c) * (long)n + sk, ok);
      cp_async4(dst + (d * T::cols + T::KP) * kCalSub, res + d * (long)n + sk, ok);
    }
    cp_async4(dst + 2 * T::cols * kCalSub, w + sk, ok);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  float acc[4][9];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < 9; ++e) acc[q][e] = 0.f;
  }
  int s_next = 0;
  if (stages > 0) {
    stage(0, slot(0));
    s_next = slot(1);
  }
  for (int g = 0; g < stages; ++g) {
    if (g + 1 < stages) {
      stage(g + 1, s_next);
      s_next = slot(g + 2);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* sm = buf + (g % 2) * T::stage_floats;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = warp + q * (kCalThreads / 32);
      if (i < T::items) cal_item<T>(sm, lane, T::item(i), acc[q]);
    }
    __syncthreads();  // the buffer is refilled two stages on
  }
  float* row = part + T::C::out * (long)ch;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = warp + q * (kCalThreads / 32);
    if (i >= T::items) continue;
    const CalItem it = T::item(i);
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      const int o = T::out_index(it, e);  // the same for the whole warp
      if (o >= 0) {
        float v[1] = {acc[q][e]};
        viba::group_sum<32, 1>(v, nullptr);  // fixed butterfly
        if (lane == 0) row[o] = v[0];
      }
    }
  }
}

// K8 sum pass, blocks [0, n_sum): g_c, diag_c and the full symmetric split
// blocks of each window row, the row's chunk partials summed in chunk order,
// one thread per entry; blocks [n_sum, ...): K2's second launch, 16 lanes
// per landmark over the point-sorted sectors q (assemble_rig.cuh)
template <int KE, int KI>
__global__ void __launch_bounds__(256) sum_cal_points(
    int n_c, int n_sum, const int* __restrict__ row_chunk, const float* __restrict__ part,
    float* __restrict__ g_c, float* __restrict__ diag_c, float* __restrict__ blk_e,
    float* __restrict__ blk_i, int L, const int* __restrict__ pt_ptr,
    const float4* __restrict__ q, float* __restrict__ g_l, float* __restrict__ H) {
  if (static_cast<int>(blockIdx.x) >= n_sum) {
    viba::assemble_point_row((blockIdx.x - n_sum) * (256 / viba::kPointGroup) +
                                 threadIdx.x / viba::kPointGroup,
                             L, pt_ptr, q, g_l, H);
    return;
  }
  using C = Cal<KE, KI>;
  constexpr int kc = C::kc, per = 2 * kc + KE * KE + KI * KI;
  const long idx = blockIdx.x * 256L + threadIdx.x;
  if (idx >= (long)n_c * per) return;
  const int r = static_cast<int>(idx / per), e = static_cast<int>(idx % per);
  int p = e;  // g_c
  float* dst = g_c + kc * (long)r + e;
  if (e >= kc && e < 2 * kc) {
    const int c = e - kc;
    p = c < KE ? C::tri0 + tri_index(c, c, KE) : C::tri1 + tri_index(c - KE, c - KE, KI);
    dst = diag_c + kc * (long)r + c;
  } else if (e >= 2 * kc) {
    const int f = e - 2 * kc;
    if constexpr (KE > 0) {
      if (f < KE * KE) {
        const int a = f / KE, b = f % KE;
        p = C::tri0 + (a <= b ? tri_index(a, b, KE) : tri_index(b, a, KE));
        dst = blk_e + KE * KE * (long)r + f;
      }
    }
    if constexpr (KI > 0) {
      if (f >= KE * KE) {
        const int g = f - KE * KE, a = g / KI, b = g % KI;
        p = C::tri1 + (a <= b ? tri_index(a, b, KI) : tri_index(b, a, KI));
        dst = blk_i + KI * KI * (long)r + g;
      }
    }
  }
  float sum = 0.f;
  for (int ch = row_chunk[r]; ch < row_chunk[r + 1]; ++ch) sum += part[C::out * (long)ch + p];
  *dst = sum;
}

// K9 down: p[pt_pos[s]] = J_p^T w (J_r x_r[rig] + J_c x_c[win]) per real slot
template <int K, int KC>
__global__ void __launch_bounds__(256) pcg_cal_down(
    int n, const int* __restrict__ rig, const int* __restrict__ win,
    const int* __restrict__ pt_pos, const float* __restrict__ J_r, const float* __restrict__ J_c,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ x_r,
    const float* __restrict__ x_c, float4* __restrict__ p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int pos = pt_pos[s];
  if (pos < 0) return;
  const float* xr = x_r + K * (long)rig[s];
  const float* xc = x_c + KC * (long)win[s];
  float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float xv = xr[c];
    u0 += J_r[c * (long)n + s] * xv;
    u1 += J_r[(K + c) * (long)n + s] * xv;
  }
  // eight columns of J_c in flight: fully unrolled at kc 23, ptxas kept 32
  // registers and spilled
#pragma unroll 8
  for (int c = 0; c < KC; ++c) {
    const float xv = xc[c];
    v0 += J_c[c * (long)n + s] * xv;
    v1 += J_c[(KC + c) * (long)n + s] * xv;
  }
  const float ws = w[s];
  const float wu0 = (u0 + v0) * ws, wu1 = (u1 + v1) * ws;
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
  p[pos] = make_float4(q[0], q[1], q[2], 0.f);
}

template <int D>
__device__ __forceinline__ void warp_sum(float (&acc)[D]) {
  viba::group_sum<32, D>(acc, nullptr);
}

// K9 up: per rig row, du = w (J_r x_r + J_c x_c[win]) - w J_p z[point] per slot,
// y_r = sum J_r^T du, and per (rig, window row) pair one partial sum J_c^T du
template <int K, int KC>
__global__ void __launch_bounds__(viba::kBlock) pcg_cal_up(
    int R, int n, const int* __restrict__ rig_pair, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_obs, const int* __restrict__ pair_part,
    const int* __restrict__ win, const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_c, const float* __restrict__ J_p, const float* __restrict__ w,
    const float* __restrict__ x_r, const float* __restrict__ x_c, const float* __restrict__ z,
    float* __restrict__ part, float* __restrict__ y_r) {
  const int r = blockIdx.x * (viba::kBlock / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;  // the whole warp
  float xr[K], acc_r[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    xr[c] = x_r[K * (long)r + c];
    acc_r[c] = 0.f;
  }
  for (int q = rig_pair[r]; q < rig_pair[r + 1]; ++q) {
    const int beg = pair_ptr[q], end = pair_ptr[q + 1];
    const float* xcp = x_c + KC * (long)win[pair_obs[beg]];
    float xc[KC], acc_c[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      xc[c] = xcp[c];
      acc_c[c] = 0.f;
    }
    for (int j = beg + lane; j < end; j += 32) {
      const int s = pair_obs[j];
      float jr0[K], jr1[K], jc0[KC], jc1[KC];
      float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        jr0[c] = J_r[c * (long)n + s];
        jr1[c] = J_r[(K + c) * (long)n + s];
        u0 += jr0[c] * xr[c];
        u1 += jr1[c] * xr[c];
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        jc0[c] = J_c[c * (long)n + s];
        jc1[c] = J_c[(KC + c) * (long)n + s];
        v0 += jc0[c] * xc[c];
        v1 += jc1[c] * xc[c];
      }
      const float ws = w[s];
      const float* zp = z + 3 * (long)point[s];
      const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
      const float a0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
      const float a1 =
          J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
      const float d0 = (u0 + v0) * ws - a0 * ws;
      const float d1 = (u1 + v1) * ws - a1 * ws;
#pragma unroll
      for (int c = 0; c < K; ++c) acc_r[c] += jr0[c] * d0 + jr1[c] * d1;
#pragma unroll
      for (int c = 0; c < KC; ++c) acc_c[c] += jc0[c] * d0 + jc1[c] * d1;
    }
    warp_sum<KC>(acc_c);
    float* dst = part + KC * (long)pair_part[q];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (lane == c) dst[c] = acc_c[c];
    }
  }
  warp_sum<K>(acc_r);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (lane == c) y_r[K * (long)r + c] = acc_r[c];
  }
}

// K10 down with y (kDown) and up: a 128-thread group per rig row over the
// row's (rig, window row) pairs (pcg_cal_up's walk).
// A slot's wu: down, w (J_r x_r + J_c x_c[win]) with x_r and the pair's
// x_c in registers, and p[pt_pos[s]] = J_p^T wu stored for the landmark
// sums (idx = pt_pos); up, w J_p z[point] (idx = point). Thread l sums
// J_r^T wu over the slots l, l + 128, ... of each of the rig's pairs in
// pair order (y_r after the group's sum: the butterfly, then the warps in
// order) and J_c^T wu over those of one pair (the pair's partial row after
// the group's sum).
template <int K, int KC, bool kDown>
__global__ void __launch_bounds__(viba::kBlock) cal_pair_pass(
    int n, const int* __restrict__ rig_pair, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_obs, const int* __restrict__ pair_part,
    const int* __restrict__ win, const int* __restrict__ idx, const float* __restrict__ J_r,
    const float* __restrict__ J_c, const float* __restrict__ J_p, const float* __restrict__ w,
    const float* __restrict__ x_r, const float* __restrict__ x_c, const float* __restrict__ z,
    float4* __restrict__ p, float* __restrict__ part, float* __restrict__ y_r) {
  constexpr int G = viba::kBlock;  // one rig row a block
  __shared__ float smem[(G / 32) * (K > KC ? K : KC)];
  const int r = blockIdx.x, lane = threadIdx.x;
  float xr[kDown ? K : 1], acc_r[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if constexpr (kDown) xr[c] = x_r[K * (long)r + c];
    acc_r[c] = 0.f;
  }
  for (int q = rig_pair[r]; q < rig_pair[r + 1]; ++q) {
    const int beg = pair_ptr[q], end = pair_ptr[q + 1];
    float xc[kDown ? KC : 1], acc_c[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) acc_c[c] = 0.f;
    if constexpr (kDown) {
      const float* xcp = x_c + KC * (long)win[pair_obs[beg]];
#pragma unroll
      for (int c = 0; c < KC; ++c) xc[c] = xcp[c];
    }
    for (int j = beg + lane; j < end; j += G) {
      const int s = pair_obs[j];
      const float ws = w[s];
      if constexpr (kDown) {
        float jr0[K], jr1[K], jc0[KC], jc1[KC];
        float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          jr0[c] = J_r[c * (long)n + s];
          jr1[c] = J_r[(K + c) * (long)n + s];
          u0 += jr0[c] * xr[c];
          u1 += jr1[c] * xr[c];
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          jc0[c] = J_c[c * (long)n + s];
          jc1[c] = J_c[(KC + c) * (long)n + s];
          v0 += jc0[c] * xc[c];
          v1 += jc1[c] * xc[c];
        }
        const float wu0 = (u0 + v0) * ws, wu1 = (u1 + v1) * ws;
        float q3[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          q3[c] = J_p[c * (long)n + s] * wu0 + J_p[(3 + c) * (long)n + s] * wu1;
        p[idx[s]] = make_float4(q3[0], q3[1], q3[2], 0.f);
#pragma unroll
        for (int c = 0; c < K; ++c) acc_r[c] += jr0[c] * wu0 + jr1[c] * wu1;
#pragma unroll
        for (int c = 0; c < KC; ++c) acc_c[c] += jc0[c] * wu0 + jc1[c] * wu1;
      } else {
        const float* zp = z + 3 * (long)idx[s];
        const float z0 = zp[0], z1 = zp[1], z2 = zp[2];
        const float a0 = J_p[s] * z0 + J_p[(long)n + s] * z1 + J_p[2 * (long)n + s] * z2;
        const float a1 =
            J_p[3 * (long)n + s] * z0 + J_p[4 * (long)n + s] * z1 + J_p[5 * (long)n + s] * z2;
        const float d0 = a0 * ws, d1 = a1 * ws;
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc_r[c] += J_r[c * (long)n + s] * d0 + J_r[(K + c) * (long)n + s] * d1;
#pragma unroll
        for (int c = 0; c < KC; ++c)
          acc_c[c] += J_c[c * (long)n + s] * d0 + J_c[(KC + c) * (long)n + s] * d1;
      }
    }
    viba::group_sum<G, KC>(acc_c, smem);
    if (lane == 0) {
      float* dst = part + KC * (long)pair_part[q];
#pragma unroll
      for (int c = 0; c < KC; ++c) dst[c] = acc_c[c];
    }
    __syncthreads();  // smem is read before the next sum
  }
  viba::group_sum<G, K>(acc_r, smem);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) y_r[K * (long)r + c] = acc_r[c];
  }
}

// K10 down with y, second launch: blocks [0, n_sum) the window rows' sums
// of their pair partials in rig order (y_c, a thread an entry), blocks
// [n_sum, ...) each landmark's contiguous range of p (t, a 16-lane group)
__global__ void __launch_bounds__(viba::kBlock) cal_down_sums(
    int n_c, int kc, int n_sum, const int* __restrict__ win_pair, const float* __restrict__ part,
    float* __restrict__ y_c, int L, const int* __restrict__ pt_ptr, const float4* __restrict__ p,
    float* __restrict__ t) {
  constexpr int G = viba::kPointGroup;
  if (static_cast<int>(blockIdx.x) < n_sum) {  // the whole block
    viba::sum_partials_entry(blockIdx.x * (long)viba::kBlock + threadIdx.x, n_c, kc, win_pair,
                             part, y_c);
    return;
  }
  viba::point_range_row<G, false>((blockIdx.x - n_sum) * (viba::kBlock / G) + threadIdx.x / G,
                                  threadIdx.x % G, L, pt_ptr, p, nullptr, t);
}

template <int K, int KC>
cudaError_t down_cal(int R, int L, int n, int n_real, int n_c, int want_y, const int* rig,
                     const int* win, const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                     const int* pair_ptr, const int* pair_obs, const int* pair_part,
                     const int* win_pair, const float* J_r, const float* J_c, const float* J_p,
                     const float* w, const float* x_r, const float* x_c, float4* p, float* part,
                     float* y_r, float* y_c, float* t, cudaStream_t st) {
  if (!want_y) {
    if (n_real > 0) {
      pcg_cal_down<K, KC><<<(n + 255) / 256, 256, 0, st>>>(n, rig, win, pt_pos, J_r, J_c, J_p, w,
                                                           x_r, x_c, p);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return viba::launch_point_sums(L, pt_ptr, p, t, st);
  }
  if (R > 0) {
    cal_pair_pass<K, KC, true><<<R, viba::kBlock, 0, st>>>(
        n, rig_pair, pair_ptr, pair_obs, pair_part, win, pt_pos, J_r, J_c, J_p, w, x_r, x_c,
        nullptr, p, part, y_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_sum = static_cast<int>(((long)n_c * KC + viba::kBlock - 1) / viba::kBlock);
  const int grid = n_sum + (L > 0 ? viba::segment_blocks<viba::kPointGroup>(L) : 0);
  if (grid > 0) {
    cal_down_sums<<<grid, viba::kBlock, 0, st>>>(n_c, KC, n_sum, win_pair, part, y_c, L, pt_ptr,
                                                 p, t);
  }
  return cudaGetLastError();
}

template <int K, int KC>
cudaError_t up_cal(int R, int n, int n_c, const int* rig_pair, const int* pair_ptr,
                   const int* pair_obs, const int* pair_part, const int* win_pair,
                   const int* point, const float* J_r, const float* J_c, const float* J_p,
                   const float* w, const float* z, float* part, float* y_r, float* y_c,
                   cudaStream_t st) {
  if (R > 0) {
    cal_pair_pass<K, KC, false><<<R, viba::kBlock, 0, st>>>(
        n, rig_pair, pair_ptr, pair_obs, pair_part, nullptr, point, J_r, J_c, J_p, w, nullptr,
        nullptr, z, nullptr, part, y_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_c, KC, win_pair, part, y_c, st);
}

// ---------------------------------------------------------------------------
// K9 columns, fused: the rig pass (the landmark pass is pt_segments.cuh's)
// ---------------------------------------------------------------------------

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

template <int K, int KC>
cudaError_t pcg_cal(int R, int L, int n, int n_real, int n_c, const int* rig, const int* win,
                    const int* point, const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                    const int* pair_ptr, const int* pair_obs, const int* pair_part,
                    const int* win_pair, const float* J_r, const float* J_c, const float* J_p,
                    const float* w, const float* x_r, const float* x_c, const float* hinv,
                    float4* p, float* z, float* part, float* y_r, float* y_c, cudaStream_t st) {
  if (n_real > 0) {
    pcg_cal_down<K, KC><<<(n + 255) / 256, 256, 0, st>>>(n, rig, win, pt_pos, J_r, J_c, J_p, w,
                                                         x_r, x_c, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  {
    const cudaError_t err = viba::launch_point_range_sum(L, pt_ptr, p, hinv, z, st);
    if (err != cudaSuccess) return err;
  }
  if (R > 0) {
    pcg_cal_up<K, KC><<<viba::segment_blocks<32>(R), viba::kBlock, 0, st>>>(
        R, n, rig_pair, pair_ptr, pair_obs, pair_part, win, point, J_r, J_c, J_p, w, x_r, x_c, z,
        part, y_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_c, KC, win_pair, part, y_c, st);
}

template <int KE, int KI>
int assemble_cal(int L, int n, int n_c, int n_chunks, const int* pt_ptr, const int* chunk_ptr,
                 const int* chunk_obs, const int* row_chunk, const float* J_c, const float* w,
                 const float* res, const float4* q, float* g_l, float* H, float* part,
                 float* g_c, float* diag_c, float* blk_e, float* blk_i, cudaStream_t st) {
  if (n_chunks > 0) {
    constexpr int smem = CalTiles<KE, KI>::smem_bytes;
    cudaError_t err = cudaFuncSetAttribute(assemble_cal_window<KE, KI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    assemble_cal_window<KE, KI><<<n_chunks, kCalThreads, smem, st>>>(n, chunk_ptr, chunk_obs,
                                                                    J_c, w, res, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long total = (long)n_c * (2 * (KE + KI) + KE * KE + KI * KI);
  constexpr int pts_per_block = 256 / viba::kPointGroup;
  const int n_sum = static_cast<int>((total + 255) / 256);
  const int grid = n_sum + (L + pts_per_block - 1) / pts_per_block;
  if (grid > 0) {
    sum_cal_points<KE, KI><<<grid, 256, 0, st>>>(n_c, n_sum, row_chunk, part, g_c, diag_c, blk_e,
                                                 blk_i, L, pt_ptr, q, g_l, H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dispatch on the window column count kc: cam extr (6), cam intr (17) or both (23)
#define VIBA_DISPATCH_KC(kc, CALL6, CALL17, CALL23) \
  ((kc) == 6 ? (CALL6) : (kc) == 17 ? (CALL17) : (kc) == 23 ? (CALL23) \
                                                         : static_cast<int>(cudaErrorInvalidValue))

extern "C" int viba_assemble_cal(int R, int L, int n, int k, int kc, int n_c, int n_chunks,
                                 const int* rig_ptr, const int* rig_obs, const int* pt_ptr,
                                 const int* pt_pos, const int* chunk_ptr, const int* chunk_obs,
                                 const int* row_chunk, const float* J_r, const float* J_p,
                                 const float* w, const float* J_c, const float* res, float* g_r,
                                 float* diag_r, float* g_l, float* H, float* part, float* g_c,
                                 float* diag_c, float* blk_e, float* blk_i, float* q,
                                 void* stream) {
  if (k != 6 && k != 9) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = viba_assemble_rows_slots(R, n, k, rig_ptr, rig_obs, pt_pos, J_r, J_p, w, res,
                                          g_r, diag_r, q, stream);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* q4 = reinterpret_cast<const float4*>(q);
#define VIBA_ASM(KE, KI)                                                                     \
  assemble_cal<KE, KI>(L, n, n_c, n_chunks, pt_ptr, chunk_ptr, chunk_obs, row_chunk, J_c, w, \
                       res, q4, g_l, H, part, g_c, diag_c, blk_e, blk_i, st)
  return VIBA_DISPATCH_KC(kc, VIBA_ASM(6, 0), VIBA_ASM(0, 17), VIBA_ASM(6, 17));
#undef VIBA_ASM
}

extern "C" int viba_schur_down_cal(int R, int L, int n, int n_real, int k, int kc, int n_c,
                                   int want_y, const int* rig, const int* win, const int* pt_pos,
                                   const int* pt_ptr, const int* rig_pair, const int* pair_ptr,
                                   const int* pair_obs, const int* pair_part, const int* win_pair,
                                   const float* J_r, const float* J_c, const float* J_p,
                                   const float* w, const float* x_r, const float* x_c, float* p,
                                   float* part, float* y_r, float* y_c, float* t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(p);
#define VIBA_DOWN(K, KC)                                                                       \
  static_cast<int>(down_cal<K, KC>(R, L, n, n_real, n_c, want_y, rig, win, pt_pos, pt_ptr,     \
                                   rig_pair, pair_ptr, pair_obs, pair_part, win_pair, J_r, J_c, \
                                   J_p, w, x_r, x_c, p4, part, y_r, y_c, t, st))
  if (k == 6) return VIBA_DISPATCH_KC(kc, VIBA_DOWN(6, 6), VIBA_DOWN(6, 17), VIBA_DOWN(6, 23));
  if (k == 9) return VIBA_DISPATCH_KC(kc, VIBA_DOWN(9, 6), VIBA_DOWN(9, 17), VIBA_DOWN(9, 23));
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_DOWN
}

extern "C" int viba_schur_up_cal(int R, int n, int k, int kc, int n_c, const int* rig_pair,
                                 const int* pair_ptr, const int* pair_obs, const int* pair_part,
                                 const int* win_pair, const int* point, const float* J_r,
                                 const float* J_c, const float* J_p, const float* w,
                                 const float* z, float* part, float* y_r, float* y_c,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VIBA_UP(K, KC)                                                                        \
  static_cast<int>(up_cal<K, KC>(R, n, n_c, rig_pair, pair_ptr, pair_obs, pair_part, win_pair, \
                                 point, J_r, J_c, J_p, w, z, part, y_r, y_c, st))
  if (k == 6) return VIBA_DISPATCH_KC(kc, VIBA_UP(6, 6), VIBA_UP(6, 17), VIBA_UP(6, 23));
  if (k == 9) return VIBA_DISPATCH_KC(kc, VIBA_UP(9, 6), VIBA_UP(9, 17), VIBA_UP(9, 23));
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_UP
}

extern "C" int viba_schur_pcg_cal(int R, int L, int n, int n_real, int k, int kc, int n_c,
                                  const int* rig, const int* win, const int* point,
                                  const int* pt_pos, const int* pt_ptr, const int* rig_pair,
                                  const int* pair_ptr, const int* pair_obs, const int* pair_part,
                                  const int* win_pair, const float* J_r, const float* J_c,
                                  const float* J_p, const float* w, const float* x_r,
                                  const float* x_c, const float* hinv, float* p, float* z,
                                  float* part, float* y_r, float* y_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(p);
#define VIBA_PCG(K, KC)                                                                        \
  static_cast<int>(pcg_cal<K, KC>(R, L, n, n_real, n_c, rig, win, point, pt_pos, pt_ptr,       \
                                  rig_pair, pair_ptr, pair_obs, pair_part, win_pair, J_r, J_c, \
                                  J_p, w, x_r, x_c, hinv, p4, z, part, y_r, y_c, st))
  if (k == 6) return VIBA_DISPATCH_KC(kc, VIBA_PCG(6, 6), VIBA_PCG(6, 17), VIBA_PCG(6, 23));
  if (k == 9) return VIBA_DISPATCH_KC(kc, VIBA_PCG(9, 6), VIBA_PCG(9, 17), VIBA_PCG(9, 23));
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_PCG
}

extern "C" int viba_schur_pcg_cal_cols(int R, int L, int k, int kc, int n_c, int C,
                                       int rig_sorted, const int* rig_pair, const int* pair_ptr,
                                       const int* pair_part, const int* win_pair,
                                       const int* rig_pos, const int* pt_ptr, const float* rec,
                                       const float* x_r, const float* x_c, const float* hinv,
                                       float* z, float* part, float* y_r, float* y_c,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VIBA_PCG_COLS(K, KC)                                                                   \
  static_cast<int>(pcg_cal_cols_fused<K, KC>(R, L, n_c, C, rig_sorted, rig_pair, pair_ptr,   \
                                             pair_part, win_pair, rig_pos, pt_ptr, rec, x_r,    \
                                             x_c, hinv, z, part, y_r, y_c, st))
  if (k == 6) {
    return VIBA_DISPATCH_KC(kc, VIBA_PCG_COLS(6, 6), VIBA_PCG_COLS(6, 17), VIBA_PCG_COLS(6, 23));
  }
  if (k == 9) {
    return VIBA_DISPATCH_KC(kc, VIBA_PCG_COLS(9, 6), VIBA_PCG_COLS(9, 17), VIBA_PCG_COLS(9, 23));
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef VIBA_PCG_COLS
}
