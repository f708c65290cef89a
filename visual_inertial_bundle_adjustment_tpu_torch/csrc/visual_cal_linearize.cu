// K11: fused linearization of a blocked global-shutter visual batch with the
// camera calibration estimated (point + pose + cam extr + cam intr active).
//
// Replaces the Pallas kernel _visual_cal_kernel (JAX ops/visual_fused.py:347,
// entry _run_cal :445), which took its 32-column Jacobian from an in-kernel
// jax.linearize + two linear-transpose passes over lane vectors. One thread
// per observation, K1's body with the calibration columns (visual_body.cuh):
// K7 (rs_linearize.cu) without the capture-time shift. J_r keeps the
// 12-column rig layout with columns 6-11 zero; J_cal = [extr 6 | intr 17],
// columns 21-22 (readout, time offset) zero.
//
// Inputs and outputs are float32. Bound: bytes — 52 B of per-observation
// inputs, ~100 B of gathered rows (L2 hits) and 316 B of outputs (res 2,
// valid 1, J 2 x 38 floats) per observation; outputs are written with the
// observation axis last (coalesced).
//
// Design on the card (visual_cal_linearize_mode): one instantiation per
// camera model; float64 for the primal chain and the residual only, the
// chain below A in float32 with the rotations applied as quaternions, the
// intrinsics columns from the projection's own intermediates (no second
// float64 pass through the model), each group stored as soon as it is
// computed (visual_body.cuh). ptxas: 80 registers (Fisheye624) / 70
// (pinhole) against the old kernel's 176. Device time on one H100 80GB HBM3
// at 700 W (chip_smoke.py, in turns with the old kernel): 0.2234 ms against
// 0.4141 at 1.75M observations (bound 0.1925).
#include "visual_body.cuh"

namespace {

using namespace viba;

// 128 threads a block and no minimum of blocks an SM, as K7
template <int CAM>
__global__ void __launch_bounds__(128) visual_cal_linearize_mode(VisArgs a) {
  visual_body<CAM, true, true>(a);
}

}  // namespace

extern "C" int viba_visual_cal_linearize(
    int n, int camera_kind, const int* rig, const int* point, const int* intr, const int* extr,
    const int* bias, const float* bias_on, const float* obs_uv, const float* sqrt_h,
    const float* pad, const float* pose_q, const float* pose_t, const float* points,
    const float* cam_intr, const float* extr_q, const float* extr_t, const float* det_bias,
    const float* rig_mask, const float* pt_mask, const float* intr_mask, const float* extr_mask,
    float* res, float* valid, float* J_pt, float* J_r, float* J_cal, void* stream) {
  if (n <= 0) return 0;
  const VisArgs a{n, rig, point, intr, extr, bias, bias_on, obs_uv, sqrt_h, pad, pose_q,
                  pose_t, points, cam_intr, extr_q, extr_t, det_bias, rig_mask, pt_mask,
                  intr_mask, extr_mask, res, valid, J_pt, J_r, J_cal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n + 127) / 128;
  if (camera_kind == 1) {
    visual_cal_linearize_mode<1><<<grid, 128, 0, st>>>(a);
  } else {
    visual_cal_linearize_mode<0><<<grid, 128, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
