"""PyTorch/CUDA port of the visual-inertial bundle adjustment framework.

Mirrors the layout of `visual_inertial_bundle_adjustment_tpu` (ops/,
ops/camera/, models/, problem/, pipeline/) with the same module and
function names. Plain tensor code is PyTorch; every TPU Pallas kernel on the
bias-only LM path is a hand-written CUDA C++ kernel for Hopper (`csrc/`),
built by `ops/_kernels.py` at first use and dispatched only for CUDA
tensors. CPU tensors take each kernel's plain PyTorch version.

This first slice covers the bias-only Levenberg-Marquardt main path:
synthetic session -> `pipeline.builder.build_synthetic_problem` ->
`problem.optimizer.Problem` -> `problem.optimizer.optimize`.
"""

__version__ = "0.1.0"
