"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py).

The parity tests run the JAX package (the reference) and the PyTorch port on
the same inputs, made with numpy from a seed, in float64 on the CPU, where
the JAX package's Pallas entries take their XLA branches and its fused
linearizers decline, so the generic AD path runs. The tiny blocked problem
is built once per process: a 6 s / 60-landmark session with IMU bias
estimated, blocked by `rcs.finalize_blocks(pb, rb=8, prb=16, ts=64)` so the
single-pass rig-only engine engages (as tests/test_rcs.py builds it).

The tiny full-sensor problem: an 8 s / 80-landmark session with two IMUs and
a rolling-shutter camera (readout 0.03 s), written as a session directory,
loaded, built by the session adapter with readout and time offset estimated
(two 5 s calibration windows), and blocked by `finalize_blocks(ts=64)` so
the calibration-coupled single-pass engine engages.

The two-grid problem is the tiny blocked problem with
`finalize_blocks(rb=8, prb=16, ts=64, prb2_cap=0)`: no per-tile landmark
window fits, so both packages solve it on their general (two-grid) path.
The global-shutter session is the full-sensor one written with
`readout_time_sec=None`; with the adapter's default options its visual batch
is calibration-coupled single-pass (K11 linearizes it), and with
`use_detector_bias=True` it carries a fourth group and takes the general path.

This module imports JAX only inside the functions that build the JAX side,
so the card-only tests (tests/test_torch_kernels_cuda.py) use it on a
machine without JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SESSION = dict(duration=6.0, keyframe_hz=5.0, gyro_hz=200.0, accel_hz=200.0,
               num_points=60, seed=3, pixel_noise=0.2)
BUILD = dict(init_pose_noise=0.01, init_point_noise=0.05, init_vel_noise=0.05,
             estimate_imu_calib=True, imu_calib_options=dict(accelBias=True, gyroBias=True))
BLOCKS = dict(rb=8, prb=16, ts=64)
FULL_SESSION = dict(duration=8.0, keyframe_hz=5.0, gyro_hz=200.0, accel_hz=200.0,
                    num_points=80, seed=5, pixel_noise=0.3, track_lifetime_sec=4.0)
FULL_WRITE = dict(num_imus=2, readout_time_sec=0.03, seed=5)
FULL_ADAPT = dict(estimate_readout=True, estimate_cam_time_offset=True)
FULL_BLOCKS = dict(ts=64)
TWO_GRID_BLOCKS = dict(BLOCKS, prb2_cap=0)
GS_WRITE = dict(num_imus=2, readout_time_sec=None, seed=5)
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


def port_blocked_problem(device="cpu", dtype=F64, blocks=None):
    """The same tiny problem built by the port's own builder (no JAX) and
    blocked like jax_problem() (or with `blocks`, e.g. TWO_GRID_BLOCKS), on
    `device` as `dtype`."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tb
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

    p = tb.build_synthetic_problem(port_session(), tb.BuildOptions(**BUILD), device=device,
                                   dtype=dtype)
    return trcs.finalize_blocks(p, **(BLOCKS if blocks is None else blocks))


@functools.lru_cache(maxsize=None)
def jax_two_grid_problem():
    """The tiny JAX problem blocked with no landmark window (two-grid path);
    cached: callers that run its optimize() restore `problem.variables`."""
    from visual_inertial_bundle_adjustment_tpu.pipeline import builder as jb
    from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs

    p = jb.build_synthetic_problem(jax_session(), jb.BuildOptions(**BUILD))
    jrcs.finalize_blocks(p, **TWO_GRID_BLOCKS)
    (info,) = [c.block_info for c in p.cfgs if getattr(c, "block_info", None)]
    assert info.prb2 == 0 and info.nhg == 0
    return p


def port_two_grid_problem(dtype=F64, device="cpu"):
    """A fresh port Problem holding the JAX two-grid problem's state."""
    from visual_inertial_bundle_adjustment_tpu_torch import interop

    return interop.problem_from_numpy(**to_numpy(jax_two_grid_problem()), device=device,
                                      dtype=dtype)


def _leaf_numpy(a):
    if isinstance(a, tuple):  # the RS tables: a dict of their fields
        return {f: np.asarray(x) for f, x in zip(a._fields, a)}
    return np.asarray(a)


def to_numpy(p):
    """The JAX problem as the numpy handoff of interop.problem_from_numpy."""
    return dict(
        variables={k: np.asarray(a) for k, a in p.variables._asdict().items()},
        masks={k: np.asarray(a) for k, a in p.masks._asdict().items()},
        cfgs=[dataclasses.asdict(c) for c in p.cfgs],
        datas=[{k: _leaf_numpy(a) for k, a in d.items()} for d in p.datas],
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


@functools.lru_cache(maxsize=None)
def full_session_dir():
    """The tiny full-sensor session directory, written by the port (its
    files equal the JAX package's byte for byte, test_torch_full_build.py)."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic_io import (
        write_session_dir)

    path = pathlib.Path(tempfile.mkdtemp(prefix="viba_full_"))
    write_session_dir(SyntheticSession(**FULL_SESSION), path, **FULL_WRITE)
    return path


@functools.lru_cache(maxsize=None)
def jax_full():
    """(problem, adapter) of the JAX package on the tiny full-sensor session,
    blocked (cached: callers that run its optimize() restore variables)."""
    from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as jsd
    from visual_inertial_bundle_adjustment_tpu.pipeline.adapter import (AdapterOptions,
                                                                        SessionAdapter)
    from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs

    adapter = SessionAdapter(jsd.load_session(full_session_dir()), AdapterOptions(**FULL_ADAPT),
                             log=None)
    p = adapter.build()
    jrcs.finalize_blocks(p, **FULL_BLOCKS)
    return p, adapter


def port_full_from_jax(dtype=F64, device="cpu"):
    """A fresh port Problem holding the JAX full-sensor problem's state."""
    from visual_inertial_bundle_adjustment_tpu_torch import interop

    return interop.problem_from_numpy(**to_numpy(jax_full()[0]), device=device, dtype=dtype)


def port_full_built(device="cpu", dtype=F64, blocked=True):
    """(problem, adapter) built by the port's own pipeline (no JAX) on the
    tiny full-sensor session, blocked like jax_full()."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import (AdapterOptions,
                                                                              SessionAdapter)
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

    adapter = SessionAdapter(tsd.load_session(full_session_dir()), AdapterOptions(**FULL_ADAPT),
                             log=None, device=device, dtype=dtype)
    p = adapter.build()
    if blocked:
        trcs.finalize_blocks(p, **FULL_BLOCKS)
    return p, adapter


@functools.lru_cache(maxsize=None)
def gs_session_dir():
    """The tiny global-shutter session directory (no ReadoutTimeSec)."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic_io import (
        write_session_dir)

    path = pathlib.Path(tempfile.mkdtemp(prefix="viba_gs_"))
    write_session_dir(SyntheticSession(**FULL_SESSION), path, **GS_WRITE)
    return path


def jax_gs(use_detector_bias=False):
    """(problem, adapter) of the JAX package on the global-shutter session
    with the adapter's default options (intrinsics and extrinsics estimated),
    blocked; cached: callers that run its optimize() restore variables."""
    return _jax_gs(bool(use_detector_bias))


@functools.lru_cache(maxsize=None)
def _jax_gs(use_detector_bias):
    from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as jsd
    from visual_inertial_bundle_adjustment_tpu.pipeline.adapter import (AdapterOptions,
                                                                        SessionAdapter)
    from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs

    adapter = SessionAdapter(jsd.load_session(gs_session_dir()),
                             AdapterOptions(use_detector_bias=use_detector_bias), log=None)
    p = adapter.build()
    jrcs.finalize_blocks(p, **FULL_BLOCKS)
    return p, adapter


def port_gs_from_jax(use_detector_bias=False, dtype=F64, device="cpu"):
    """A fresh port Problem holding the JAX global-shutter problem's state."""
    from visual_inertial_bundle_adjustment_tpu_torch import interop

    return interop.problem_from_numpy(**to_numpy(jax_gs(use_detector_bias)[0]), device=device,
                                      dtype=dtype)


def port_gs_built(use_detector_bias=False, device="cpu", dtype=F64, blocked=True):
    """(problem, adapter) built by the port's own pipeline (no JAX) on the
    global-shutter session, blocked like jax_gs()."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import (AdapterOptions,
                                                                              SessionAdapter)
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

    adapter = SessionAdapter(tsd.load_session(gs_session_dir()),
                             AdapterOptions(use_detector_bias=use_detector_bias), log=None,
                             device=device, dtype=dtype)
    p = adapter.build()
    if blocked:
        trcs.finalize_blocks(p, **FULL_BLOCKS)
    return p, adapter


@functools.lru_cache(maxsize=None)
def port_full_session():
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession

    return SyntheticSession(**FULL_SESSION)


def port_merge_inputs(device="cpu", dtype=F64):
    """The tiny full-sensor (rolling shutter) and global-shutter sessions,
    built unblocked by the port's adapter, with what chip_smoke's multi path
    merges its 600 s recordings with (its `landmark_ids` and `base_map`):
    every landmark matched by generated point id, and a base map of
    constant keyrigs at every 10th rig of the first. Returns (problems,
    matches, base-map batch, base-map keyrigs)."""
    import chip_smoke

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import multi_session as tms

    pa, aa = port_full_built(device, dtype, blocked=False)
    pb, ab = port_gs_built(device=device, dtype=dtype, blocked=False)
    ids_a, ids_b = chip_smoke.landmark_ids(aa), chip_smoke.landmark_ids(ab)
    _, rows_a, rows_b = np.intersect1d(ids_a, ids_b, return_indices=True)
    matches = [(0, int(i), 1, int(j)) for i, j in zip(rows_a, rows_b)]
    pre = tms.merge_sessions([pa, pb], point_matches=matches)
    bm, n_key = chip_smoke.base_map(port_full_session(), aa, ids_a, pre.point_map, device,
                                    dtype)
    return [pa, pb], matches, bm, n_key


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)
