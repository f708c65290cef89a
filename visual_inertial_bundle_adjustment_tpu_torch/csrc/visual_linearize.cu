// K1: fused linearization of a blocked plain-visual batch.
//
// Replaces the Pallas kernel _visual_kernel (JAX ops/visual_fused.py:139,
// entry _run :237). One thread per observation (visual_body.cuh, shared with
// K11): gather pose/point/camera rows by index, p_rig = R(T) p + t(T),
// p_cam = R(E) p_rig + t(E), project, whiten, and (with the Jacobian)
//   J_pt = sqrt_h D R(E) R(T),  J_pose = sqrt_h D R(E) [I | -hat(p_rig)],
// where D = d uv / d p_cam comes from three forward tangents carried
// through the camera model in a small dual type (the Pallas kernel used
// jax.linearize; the library atan2 replaces its Mosaic atan2 workaround).
//
// Inputs and outputs are float32. Bound: bytes — per observation 52 B of
// inputs and 132 B of outputs with the Jacobian (res, valid, J_pt, J_r),
// 12 B residual-only, the gathered table rows L2 hits; outputs are written
// with the observation axis last, so every column store is coalesced.
//
// Design on the card (visual_linearize_mode): one instantiation per mode,
// <camera model, Jacobian>. The residual-only pass, the cost of every path,
// compiles no Jacobian chain: the projection's tangents are dead code there,
// and it reads no masks. The Jacobian pass keeps float64 for the primal chain
// and the residual, and runs the chain below A in float32 with the rotations
// applied as quaternions (visual_body.cuh). ptxas: 40 registers residual-only,
// 72 (Fisheye624) / 62 (pinhole) with the Jacobian, against the old kernel's
// 90. Device time on one H100 80GB HBM3 at 700 W (chip_smoke.py, in turns
// with the old kernel): residual-only 0.0475 ms against 0.0913 at 1.75M
// observations (bound 0.0336), with the Jacobian 0.2304 against 0.2540 at
// 3.1M (bound 0.1704).
#include "visual_body.cuh"

namespace {

using namespace viba;

// 128 threads a block and no minimum of blocks an SM, as K7
template <int CAM, bool JAC>
__global__ void __launch_bounds__(128) visual_linearize_mode(VisArgs a) {
  visual_body<CAM, JAC, false>(a);
}

template <int CAM, bool JAC>
cudaError_t launch_visual(const VisArgs& a, cudaStream_t st) {
  visual_linearize_mode<CAM, JAC><<<(a.n + 127) / 128, 128, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int viba_visual_linearize(
    int n, int camera_kind, int with_jac, const int* rig, const int* point, const int* intr,
    const int* extr, const int* bias, const float* bias_on, const float* obs_uv,
    const float* sqrt_h, const float* pad, const float* pose_q, const float* pose_t,
    const float* rig_mask, const float* points, const float* pt_mask, const float* cam_intr,
    const float* extr_q, const float* extr_t, const float* det_bias, float* res, float* valid,
    float* J_pt, float* J_r, void* stream) {
  if (n <= 0) return 0;
  const VisArgs a{n, rig, point, intr, extr, bias, bias_on, obs_uv, sqrt_h, pad, pose_q,
                  pose_t, points, cam_intr, extr_q, extr_t, det_bias, rig_mask, pt_mask,
                  nullptr, nullptr, res, valid, J_pt, J_r, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (camera_kind == 1) {
    err = with_jac ? launch_visual<1, true>(a, st) : launch_visual<1, false>(a, st);
  } else {
    err = with_jac ? launch_visual<0, true>(a, st) : launch_visual<0, false>(a, st);
  }
  return static_cast<int>(err);
}
