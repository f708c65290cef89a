// K9 on C right-hand sides at rig width 6, and the C entry of both rig
// widths (the kernels: cal_pcg_cols.cuh; rig width 9: cal_pcg_cols_k9.cu).
#include "cal_pcg_cols.cuh"

int viba_pcg_cal_cols_k6(int R, int L, int n_c, int kc, int C, int rig_sorted, const int* rig_pair,
    const int* pair_ptr, const int* pair_part, const int* win_pair, const int* rig_pos,
    const int* pt_ptr, const float* rec, const float* x_r, const float* x_c,
    const float* hinv, float* z, float* part, float* y_r, float* y_c, cudaStream_t st) {
  return pcg_cal_cols_at<6>(R, L, n_c, kc, C, rig_sorted, rig_pair, pair_ptr, pair_part,
                              win_pair, rig_pos, pt_ptr, rec, x_r, x_c, hinv, z, part, y_r,
                              y_c, st);
}

extern "C" int viba_schur_pcg_cal_cols(int R, int L, int k, int kc, int n_c, int C,
                                       int rig_sorted, const int* rig_pair, const int* pair_ptr,
                                       const int* pair_part, const int* win_pair,
                                       const int* rig_pos, const int* pt_ptr, const float* rec,
                                       const float* x_r, const float* x_c, const float* hinv,
                                       float* z, float* part, float* y_r, float* y_c,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 6) {
    return viba_pcg_cal_cols_k6(R, L, n_c, kc, C, rig_sorted, rig_pair, pair_ptr,
                                pair_part, win_pair, rig_pos, pt_ptr, rec, x_r, x_c, hinv, z,
                                part, y_r, y_c, st);
  }
  if (k == 9) {
    return viba_pcg_cal_cols_k9(R, L, n_c, kc, C, rig_sorted, rig_pair, pair_ptr,
                                pair_part, win_pair, rig_pos, pt_ptr, rec, x_r, x_c, hinv, z,
                                part, y_r, y_c, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
