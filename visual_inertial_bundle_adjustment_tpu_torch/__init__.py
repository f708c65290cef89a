"""PyTorch/CUDA port of the visual-inertial bundle adjustment framework.

Mirrors the layout of `visual_inertial_bundle_adjustment_tpu` (ops/,
ops/camera/, models/, problem/, pipeline/) with the same module and
function names. Plain tensor code is PyTorch; every TPU Pallas kernel on the
ported paths is a hand-written CUDA C++ kernel for Hopper (`csrc/`), built
by `ops/_kernels.py` at first use and dispatched only for CUDA tensors. CPU
tensors take each kernel's plain PyTorch version.

Two Levenberg-Marquardt paths are ported:
  - bias-only: synthetic session -> `pipeline.builder.build_synthetic_problem`
    -> `problem.optimizer.optimize` (kernels K1-K6);
  - full sensor (rolling shutter, calibration windows, two IMUs): synthetic
    session -> `pipeline.synthetic_io.write_session_dir` ->
    `pipeline.session_data.load_session` ->
    `pipeline.adapter.SessionAdapter(...).build()` -> `optimize` (K3, K7-K10).

Beside them: the global-shutter calibration and general two-grid routes,
the CLI (`pipeline.cli`), covariances (`problem.covariance`), multi-session
problems (`pipeline.multi_session.merge_sessions`, the base-map factor)
and the preprocessing tools (`tools.save_observations`, `tools.process_vrs`).
"""

__version__ = "0.1.0"
