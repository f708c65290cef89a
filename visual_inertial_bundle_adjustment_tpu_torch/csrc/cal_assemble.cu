// K8: the assembly of a calibration-coupled visual batch (the units and
// what they share: cal_segments.cuh). Replaces the Pallas kernel
// _assemble_cal_kernel (JAX ops/segments.py:1674, entry seg_assemble_cal
// :1741).
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
#include "assemble_rig.cuh"
#include "cal_segments.cuh"

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
