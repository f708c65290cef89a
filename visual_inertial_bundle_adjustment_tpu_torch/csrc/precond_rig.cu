// K3: Schur-corrected block-Jacobi rig blocks (per lambda).
//
// Replaces the Pallas kernel _precond_rig_kernel (JAX ops/segments.py:1861,
// entry seg_precond_rig :1911). Per rig row, the full symmetric K x K block
//   E = sum_slots  w J_r J_r^T - A H_ll^-1[pt] A^T,   A = J_r^T w J_p
// (K = rig_k: 6 for global-shutter batches, 9 for rolling-shutter ones,
// where the velocity couples), with H_ll^-1 gathered per slot from an f32
// (L, 3, 3) table (the bf16 table of the TPU version is not carried over).
// TJ is J's element type: float, or bf16 for the PCG loop's copies
// (rcs.MATVEC_BF16; tile_reduce.cuh jf), upcast where it is loaded.
//
// Bound: bytes of J (4 or 2 B an element), w and the landmark index of each
// real slot, the rig lists and the H_ll^-1 table (L2-resident) once. What
// held the first design below that bound was the work of each rig
// row, not of its slots: a 128-thread group per row, a list entry loaded
// before each slot's loads, then 5 T shuffles a thread (T = K(K+1)/2
// entries of the triangle), thread 0 summing the four warps' T values and
// writing the K^2 entries alone, and that for every row, empty or not.
// This design:
//   * a warp per rig row, four rows a block. A row's ~170-330 slots are
//     5-10 a lane; at the bias headline's 1,200 rows four warps a row
//     measured the same (PERF.md, section 6);
//   * the warp walks the row's slot range [rig_obs[beg], rig_obs[end-1]]
//     directly: rows are contiguous runs of the rig-sorted tiles, and the
//     pads between their real slots have w = 0 and add nothing (the plain
//     version sums them too), so no list entry is loaded per slot;
//   * each lane takes its slots in batches (kBatch6 at K 6, kBatch9 at
//     K 9, where a slot's ~360 FMAs and 128 registers leave no room for a
//     second slot's loads), every load of a batch (J, w and the landmark
//     index, then the 9 floats of H_ll^-1) issued before the first product
//     (schur.cu schur_up_rows);
//   * an empty row writes its K^2 zeros and does nothing else;
//   * the tail is a reduce-scatter: at each of the butterfly's five levels
//     a lane keeps half the entries it holds and adds its partner's copy of
//     them (~T shuffles, not 5 T), ending with at most ceil(T / 32)
//     entries, which it writes at (a, b) and (b, a).
// The per-slot product keeps the first design's form, A, then A H a row at
// a time: E_s = J_r^T M_s J_r with the 2x2 M_s = w I - w^2 J_p H J_p^T takes
// half the FMAs, but its float32 error against the float64 plain version
// rose at the capacity shape on bf16 J, 3.4e-6 -> 7.5e-6 of the 1e-5
// bound (PERF.md, section 6).
// Every sum has a fixed order (a lane's slots in order, then the xor
// butterfly's tree), so calls repeat bit for bit, and a bf16 call gives the
// float32 instantiation's bits on the upcast values.
#include "tile_reduce.cuh"

namespace {

constexpr int kBatch6 = 2;  // slots a lane loads before its first product, K 6
constexpr int kBatch9 = 1;  // the same, K 9
constexpr int kRows = viba::kBlock / 32;  // rig rows a block, a warp each

// (a, b), a <= b, of entry e of a K x K block's upper triangle, row by row
template <int K>
__device__ __forceinline__ void tri_entry(int e, int& a, int& b) {
  int row = 0, start = 0;
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    if (row == i && e >= start + (K - i)) {
      start += K - i;
      row = i + 1;
    }
  }
  a = row;
  b = row + e - start;
}

// Reduce-scatter of N entries over a warp, levels OFF = 16, 8, ..., 1: a
// lane holds positions [0, N) of the id range [base, base + N) (the first
// cnt real); it keeps the lower ceil(N / 2) positions (lane bit OFF clear)
// or the upper rest, padded with a zero, and adds its partner's copy of
// them. Partners hold the same range, so the ranges split until each lane
// owns ids base + i, i < cnt, each the warp's total in group_sum's tree:
// the same bits as the all-reduce butterfly.
template <int N, int OFF>
struct ReduceScatter {
  static constexpr int H = (N + 1) / 2;
  using Next = ReduceScatter<H, OFF / 2>;
  static constexpr int kOut = Next::kOut;

  static __device__ __forceinline__ void run(const float (&acc)[N], float (&own)[kOut],
                                             int lane, int& base, int& cnt) {
    const bool upper = lane & OFF;
    float kept[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = acc[i], hi = H + i < N ? acc[H + i] : 0.f;
      kept[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, OFF);
    }
    if (upper) {
      base += H;
      cnt = max(cnt - H, 0);
    } else {
      cnt = min(cnt, H);
    }
    Next::run(kept, own, lane, base, cnt);
  }
};

template <int N>
struct ReduceScatter<N, 0> {
  static constexpr int kOut = N;
  static __device__ __forceinline__ void run(const float (&acc)[N], float (&own)[N], int, int&,
                                             int&) {
#pragma unroll
    for (int i = 0; i < N; ++i) own[i] = acc[i];
  }
};

// acc (the upper triangle, row by row) += w J_r J_r^T - A H A^T of one
// slot, A = w J_r^T J_p (K x 3); one row of A H at a time
template <int K, int T>
__device__ __forceinline__ void slot_block(const float (&jr)[2 * K], const float (&jp)[6],
                                           float ws, const float (&H)[9], float (&acc)[T]) {
  float A[K][3];
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) A[a][c] = (jr[a] * ws) * jp[c] + (jr[K + a] * ws) * jp[3 + c];
  }
  int m = 0;
#pragma unroll
  for (int a = 0; a < K; ++a) {
    float C[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) C[c] = A[a][0] * H[c] + A[a][1] * H[3 + c] + A[a][2] * H[6 + c];
    const float t0 = jr[a] * ws, t1 = jr[K + a] * ws;
#pragma unroll
    for (int b = a; b < K; ++b, ++m) {
      const float corr = C[0] * A[b][0] + C[1] * A[b][1] + C[2] * A[b][2];
      acc[m] += (t0 * jr[b] + t1 * jr[K + b]) - corr;
    }
  }
}

template <int K, class TJ>
__global__ void __launch_bounds__(viba::kBlock) precond_rig(
    int R, int n, const int* __restrict__ rig_ptr, const int* __restrict__ rig_obs,
    const int* __restrict__ point, const TJ* __restrict__ J_r, const TJ* __restrict__ J_p,
    const float* __restrict__ w, const float* __restrict__ hinv, float* __restrict__ out) {
  constexpr int T = K * (K + 1) / 2, B = K == 6 ? kBatch6 : kBatch9;
  using Scatter = ReduceScatter<T, 16>;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= R) return;  // a whole warp: rows past R only in the last block
  const int beg = rig_ptr[row], end = rig_ptr[row + 1];
  float* blk = out + K * K * (long)row;
  if (beg == end) {  // uniform over the warp
    for (int e = lane; e < K * K; e += 32) blk[e] = 0.f;
    return;
  }
  float acc[T];
#pragma unroll
  for (int i = 0; i < T; ++i) acc[i] = 0.f;
  const int first = rig_obs[beg], last = rig_obs[end - 1];
  // not unrolled: a batch's loads and products are already unrolled, and
  // copies of them only lengthen the build
#pragma unroll 1
  for (int j0 = first + lane; j0 <= last; j0 += B * 32) {
    // a slot past the row's range repeats slot j0 and adds nothing
    int s[B];
    bool ok[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      ok[b] = j0 + b * 32 <= last;
      s[b] = ok[b] ? j0 + b * 32 : j0;
    }
    int pt[B];
    float ws[B], jr[B][2 * K], jp[B][6], h[B][9];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      pt[b] = point[s[b]];
      ws[b] = w[s[b]];
#pragma unroll
      for (int c = 0; c < 2 * K; ++c) jr[b][c] = viba::jf(J_r[c * (long)n + s[b]]);
#pragma unroll
      for (int c = 0; c < 6; ++c) jp[b][c] = viba::jf(J_p[c * (long)n + s[b]]);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float* H = hinv + 9 * (long)pt[b];
#pragma unroll
      for (int c = 0; c < 9; ++c) h[b][c] = H[c];
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (ok[b]) slot_block<K, T>(jr[b], jp[b], ws[b], h[b], acc);
    }
  }
  float own[Scatter::kOut];
  int base = 0, cnt = T;
  Scatter::run(acc, own, lane, base, cnt);
#pragma unroll
  for (int i = 0; i < Scatter::kOut; ++i) {
    if (i < cnt) {
      int a, b;
      tri_entry<K>(base + i, a, b);
      blk[K * a + b] = own[i];
      if (a != b) blk[K * b + a] = own[i];
    }
  }
}

template <class TJ>
cudaError_t precond_rig_typed(int R, int n, int k, const int* rig_ptr, const int* rig_obs,
                              const int* point, const void* J_r, const void* J_p, const float* w,
                              const float* hinv, float* out, cudaStream_t st) {
  const TJ* jr = static_cast<const TJ*>(J_r);
  const TJ* jp = static_cast<const TJ*>(J_p);
  const int grid = (R + kRows - 1) / kRows;
  if (k == 6) {
    precond_rig<6, TJ><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, jr, jp, w,
                                                      hinv, out);
  } else if (k == 9) {
    precond_rig<9, TJ><<<grid, viba::kBlock, 0, st>>>(R, n, rig_ptr, rig_obs, point, jr, jp, w,
                                                      hinv, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// jt: the J type code (VIBA_BY_JTYPE)
extern "C" int viba_precond_rig(int R, int n, int k, int jt, const int* rig_ptr,
                                const int* rig_obs, const int* point, const void* J_r,
                                const void* J_p, const float* w, const float* hinv, float* out,
                                void* stream) {
  if (R <= 0) return 0;
  return VIBA_BY_JTYPE(jt, precond_rig_typed, R, n, k, rig_ptr, rig_obs, point, J_r, J_p, w,
                       hinv, out, static_cast<cudaStream_t>(stream));
}
