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
// Rig rows (~300 observations) and landmark rows (~30) keep K2-K6's
// group-per-row scheme (tile_reduce.cuh). Window rows are few and long (120
// rows of ~15k observations at the full-sensor size): one group per row would
// leave most of the card idle, so each row's slot list is cut into chunks of
// at most CHUNK slots (ops/segments.py) whose partial rows a second pass sums
// in chunk order. Deterministic, no atomics.
//
// K8 (viba_assemble_cal) is three launches: K2's assemble_rig for the rig and
// landmark rows (H_ll0 written as full 3x3 blocks), then
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
//            summed in chunk order.
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
// staged wu and no window chunk lists. K10's passes below stay separate
// (down_cal_rig stages wu, schur_down_points gathers it through the landmark
// lists, the window rows reduce through chunks).
#include "pt_segments.cuh"
#include "tile_reduce.cuh"

extern "C" int viba_assemble_rig(int R, int L, int n, int k, const int* rig_ptr,
                                 const int* rig_obs, const int* pt_ptr, const int* pt_obs,
                                 const float* J_r, const float* J_p, const float* w,
                                 const float* res, float* g_r, float* diag_r, float* g_l,
                                 float* H, void* stream);
extern "C" int viba_schur_down_points(int L, int n, const int* pt_ptr, const int* pt_obs,
                                      const float* J_p, const float* wu, float* t, void* stream);

namespace {

using viba::kRowGroup;

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));  // 0 bytes read: the word is zero-filled
}

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

// K8 sum pass: g_c, diag_c and the full symmetric split blocks of each
// window row, the row's chunk partials summed in chunk order
template <int KE, int KI>
__global__ void __launch_bounds__(256) sum_cal(int n_c, const int* __restrict__ row_chunk,
                                               const float* __restrict__ part,
                                               float* __restrict__ g_c,
                                               float* __restrict__ diag_c,
                                               float* __restrict__ blk_e,
                                               float* __restrict__ blk_i) {
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

// K9/K10 window pass: chunk partials of J_c^T u for a staged 2-row u
template <int KC>
__global__ void __launch_bounds__(viba::kBlock) cal_partials(
    int n_chunks, int n, const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_obs,
    const float* __restrict__ J_c, const float* __restrict__ u, float* __restrict__ part) {
  viba::reduce_segments<kRowGroup, KC>(
      blockIdx.x, n_chunks, chunk_ptr, chunk_obs,
      [&](int s, float(&acc)[KC]) {
        const float u0 = u[s], u1 = u[n + s];
#pragma unroll
        for (int c = 0; c < KC; ++c)
          acc[c] += J_c[c * (long)n + s] * u0 + J_c[(KC + c) * (long)n + s] * u1;
      },
      [&](int ch, float(&acc)[KC]) {
#pragma unroll
        for (int c = 0; c < KC; ++c) part[KC * (long)ch + c] = acc[c];
      });
}

template <int KC>
cudaError_t launch_rows(int n_rows, int n_chunks, int n, const int* chunk_ptr,
                        const int* chunk_obs, const int* row_chunk, const float* J_c,
                        const float* u, float* part, float* out, cudaStream_t st) {
  if (n_chunks > 0) {
    cal_partials<KC><<<n_chunks, viba::kBlock, 0, st>>>(n_chunks, n, chunk_ptr, chunk_obs, J_c,
                                                        u, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return viba::launch_sum_partials(n_rows, KC, row_chunk, part, out, st);
}

// K10 down, rig pass: wu = w (J_r x_r[rig] + J_c x_c[win]) for every
// real slot and, if want_y, y_r = sum J_r^T wu
template <int K, int KC>
__global__ void __launch_bounds__(viba::kBlock) down_cal_rig(
    int R, int n, int want_y, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ win, const float* __restrict__ J_r, const float* __restrict__ J_c,
    const float* __restrict__ w, const float* __restrict__ x_r, const float* __restrict__ x_c,
    float* __restrict__ y_r, float* __restrict__ wu) {
  const int row = blockIdx.x;
  float xr[K];
#pragma unroll
  for (int c = 0; c < K; ++c) xr[c] = row < R ? x_r[K * (long)row + c] : 0.f;
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
        const float* xc = x_c + KC * (long)win[s];
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const float xv = xc[c];
          v0 += J_c[c * (long)n + s] * xv;
          v1 += J_c[(KC + c) * (long)n + s] * xv;
        }
        const float ws = w[s];
        const float wu0 = (u0 + v0) * ws, wu1 = (u1 + v1) * ws;
        wu[s] = wu0;
        wu[n + s] = wu1;
        if (want_y) {
#pragma unroll
          for (int c = 0; c < K; ++c) acc[c] += j0[c] * wu0 + j1[c] * wu1;
        }
      },
      [&](int r, float(&acc)[K]) {
        if (want_y) {
#pragma unroll
          for (int c = 0; c < K; ++c) y_r[K * (long)r + c] = acc[c];
        }
      });
}

// K10 up, rig pass: du = w J_p z[pt], stored for the window pass, and
// y_r = sum J_r^T du
template <int K>
__global__ void __launch_bounds__(viba::kBlock) up_cal_rig(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const float* __restrict__ J_r,
    const float* __restrict__ J_p, const float* __restrict__ w, const float* __restrict__ z,
    float* __restrict__ du, float* __restrict__ y_r) {
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
        du[s] = d0;
        du[n + s] = d1;
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] += J_r[c * (long)n + s] * d0 + J_r[(K + c) * (long)n + s] * d1;
      },
      [&](int r, float(&acc)[K]) {
#pragma unroll
        for (int c = 0; c < K; ++c) y_r[K * (long)r + c] = acc[c];
      });
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
int assemble_cal(int n_c, int n_chunks, int n, const int* chunk_ptr, const int* chunk_obs,
                 const int* row_chunk, const float* J_c, const float* w, const float* res,
                 float* part, float* g_c, float* diag_c, float* blk_e, float* blk_i,
                 cudaStream_t st) {
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
  if (total > 0) {
    sum_cal<KE, KI><<<static_cast<int>((total + 255) / 256), 256, 0, st>>>(
        n_c, row_chunk, part, g_c, diag_c, blk_e, blk_i);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int down_cal(int R, int L, int n, int k, int n_c, int n_chunks, int want_y, const int* rig_ptr,
             const int* rig_obs, const int* pt_ptr, const int* pt_obs, const int* win,
             const int* chunk_ptr, const int* chunk_obs, const int* row_chunk, const float* J_r,
             const float* J_p, const float* w, const float* J_c, const float* x_r,
             const float* x_c, float* y_r, float* y_c, float* part, float* t, float* wu,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const int grid = viba::segment_blocks<kRowGroup>(R);
    if (k == 6) {
      down_cal_rig<6, KC><<<grid, viba::kBlock, 0, st>>>(R, n, want_y, rig_ptr, rig_obs, win,
                                                         J_r, J_c, w, x_r, x_c, y_r, wu);
    } else if (k == 9) {
      down_cal_rig<9, KC><<<grid, viba::kBlock, 0, st>>>(R, n, want_y, rig_ptr, rig_obs, win,
                                                         J_r, J_c, w, x_r, x_c, y_r, wu);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rc = viba_schur_down_points(L, n, pt_ptr, pt_obs, J_p, wu, t, stream);
  if (rc != 0 || !want_y) return rc;
  return static_cast<int>(launch_rows<KC>(n_c, n_chunks, n, chunk_ptr, chunk_obs, row_chunk,
                                          J_c, wu, part, y_c, st));
}

}  // namespace

// dispatch on the window column count kc: cam extr (6), cam intr (17) or both (23)
#define VIBA_DISPATCH_KC(kc, CALL6, CALL17, CALL23) \
  ((kc) == 6 ? (CALL6) : (kc) == 17 ? (CALL17) : (kc) == 23 ? (CALL23) \
                                                         : static_cast<int>(cudaErrorInvalidValue))

extern "C" int viba_assemble_cal(int R, int L, int n, int k, int kc, int n_c, int n_chunks,
                                 const int* rig_ptr, const int* rig_obs, const int* pt_ptr,
                                 const int* pt_obs, const int* chunk_ptr, const int* chunk_obs,
                                 const int* row_chunk, const float* J_r, const float* J_p,
                                 const float* w, const float* J_c, const float* res, float* g_r,
                                 float* diag_r, float* g_l, float* H, float* part, float* g_c,
                                 float* diag_c, float* blk_e, float* blk_i, void* stream) {
  const int rc = viba_assemble_rig(R, L, n, k, rig_ptr, rig_obs, pt_ptr, pt_obs, J_r, J_p, w,
                                   res, g_r, diag_r, g_l, H, stream);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VIBA_ASM(KE, KI)                                                                      \
  assemble_cal<KE, KI>(n_c, n_chunks, n, chunk_ptr, chunk_obs, row_chunk, J_c, w, res, part, \
                       g_c, diag_c, blk_e, blk_i, st)
  return VIBA_DISPATCH_KC(kc, VIBA_ASM(6, 0), VIBA_ASM(0, 17), VIBA_ASM(6, 17));
#undef VIBA_ASM
}

extern "C" int viba_schur_down_cal(int R, int L, int n, int k, int kc, int n_c, int n_chunks,
                                   int want_y, const int* rig_ptr, const int* rig_obs,
                                   const int* pt_ptr, const int* pt_obs, const int* win,
                                   const int* chunk_ptr, const int* chunk_obs,
                                   const int* row_chunk, const float* J_r, const float* J_p,
                                   const float* w, const float* J_c, const float* x_r,
                                   const float* x_c, float* y_r, float* y_c, float* part,
                                   float* t, float* wu, void* stream) {
#define VIBA_DOWN(KC)                                                                       \
  down_cal<KC>(R, L, n, k, n_c, n_chunks, want_y, rig_ptr, rig_obs, pt_ptr, pt_obs, win,     \
               chunk_ptr, chunk_obs, row_chunk, J_r, J_p, w, J_c, x_r, x_c, y_r, y_c, part, t, \
               wu, stream)
  return VIBA_DISPATCH_KC(kc, VIBA_DOWN(6), VIBA_DOWN(17), VIBA_DOWN(23));
#undef VIBA_DOWN
}

extern "C" int viba_schur_up_cal(int R, int n, int k, int kc, int n_c, int n_chunks,
                                 const int* rig_ptr, const int* rig_obs, const int* point,
                                 const int* chunk_ptr, const int* chunk_obs, const int* row_chunk,
                                 const float* J_r, const float* J_p, const float* w,
                                 const float* J_c, const float* z, float* du, float* part,
                                 float* y_r, float* y_c, void* stream) {
  if (kc != 6 && kc != 17 && kc != 23) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const int grid = viba::segment_blocks<kRowGroup>(R);
    if (k == 6) {
      up_cal_rig<6><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w,
                                                   z, du, y_r);
    } else if (k == 9) {
      up_cal_rig<9><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, J_r, J_p, w,
                                                   z, du, y_r);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#define VIBA_UP(KC)                                                                       \
  static_cast<int>(launch_rows<KC>(n_c, n_chunks, n, chunk_ptr, chunk_obs, row_chunk, J_c, du, \
                                   part, y_c, st))
  return VIBA_DISPATCH_KC(kc, VIBA_UP(6), VIBA_UP(17), VIBA_UP(23));
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
