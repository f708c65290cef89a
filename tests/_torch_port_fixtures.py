"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py).

The parity tests run the JAX package (the reference) and the PyTorch port on
the same inputs, made with numpy from a seed, in float64 on the CPU, where
the JAX package's Pallas entries take their XLA branches and its fused
linearizers decline, so the generic AD path runs. The tiny blocked problem
is built once per process: a 6 s / 60-landmark session with IMU bias
estimated, blocked by `rcs.finalize_blocks(pb, rb=8, prb=16, ts=64)` so the
single-pass rig-only engine engages (as tests/test_rcs.py builds it).

This module imports JAX only inside the functions that build the JAX side,
so the card-only tests (tests/test_torch_kernels_cuda.py) use it on a
machine without JAX.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SESSION = dict(duration=6.0, keyframe_hz=5.0, gyro_hz=200.0, accel_hz=200.0,
               num_points=60, seed=3, pixel_noise=0.2)
BUILD = dict(init_pose_noise=0.01, init_point_noise=0.05, init_vel_noise=0.05,
             estimate_imu_calib=True, imu_calib_options=dict(accelBias=True, gyroBias=True))
BLOCKS = dict(rb=8, prb=16, ts=64)
F64 = torch.float64


def rel(a, b):
    """max |a - b| relative to max |b| (0 for empty arrays)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-300))


def t(a, dtype=F64):
    """numpy (or JAX) array -> torch tensor on the CPU (floats as dtype)."""
    a = np.array(a)
    out = torch.from_numpy(a)
    return out.to(dtype) if out.is_floating_point() else out


@functools.lru_cache(maxsize=None)
def jax_session():
    from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic import SyntheticSession

    return SyntheticSession(**SESSION)


@functools.lru_cache(maxsize=None)
def port_session():
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession

    return SyntheticSession(**SESSION)


@functools.lru_cache(maxsize=None)
def jax_problem():
    """The JAX package's tiny blocked problem (cached: callers that run its
    optimize() must restore `problem.variables`)."""
    from visual_inertial_bundle_adjustment_tpu.pipeline import builder as jb
    from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs

    p = jb.build_synthetic_problem(jax_session(), jb.BuildOptions(**BUILD))
    jrcs.finalize_blocks(p, **BLOCKS)
    assert any(getattr(c, "block_info", None) for c in p.cfgs)
    return p


def port_blocked_problem(device="cpu", dtype=F64):
    """The same tiny problem built by the port's own builder (no JAX) and
    blocked like jax_problem(), on `device` as `dtype`."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tb
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

    p = tb.build_synthetic_problem(port_session(), tb.BuildOptions(**BUILD), device=device,
                                   dtype=dtype)
    return trcs.finalize_blocks(p, **BLOCKS)


def to_numpy(p):
    """The JAX problem as the numpy handoff of interop.problem_from_numpy."""
    return dict(
        variables={k: np.asarray(a) for k, a in p.variables._asdict().items()},
        masks={k: np.asarray(a) for k, a in p.masks._asdict().items()},
        cfgs=[dataclasses.asdict(c) for c in p.cfgs],
        datas=[{k: np.asarray(a) for k, a in d.items()} for d in p.datas],
    )


def port_problem(dtype=F64, device="cpu"):
    """A fresh port Problem holding the JAX problem's state."""
    from visual_inertial_bundle_adjustment_tpu_torch import interop

    return interop.problem_from_numpy(**to_numpy(jax_problem()), device=device, dtype=dtype)


def jax_active_cfgs(p):
    """cfgs with active_groups resolved, as the JAX Problem._build does."""
    from visual_inertial_bundle_adjustment_tpu.problem import factors as fct

    ga = {g: bool(np.asarray(getattr(p.masks, g)).any())
          for g in fct.GROUP_DIMS if g != fct.POINTS}
    ga[fct.POINTS] = True
    return tuple(dataclasses.replace(c, active_groups=tuple(
        g for g, _ in fct.REGISTRY[c.kind]["tangents"] if ga[g])) for c in p.cfgs)


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)
