"""Accuracy of the port's card paths against their own references, on the
card: the twin of tests/test_tpu_accuracy.py, whose tests run only on the
JAX package's TPU.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX (run it with the suite's conftest.py left out, as
tests/test_torch_kernels_cuda.py):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_accuracy_cuda.py -q

  * `test_bf16_matvec_step_agreement`: the reference's problem (a 60 s
    session at 10 Hz, 200 Hz IMU, 300 points, seed 9, pixel noise 0.3,
    build noise 0.005 / 0.03 / 0.03; tests/test_tpu_accuracy.py:30-46),
    built by the port's builder on the card in float32 and blocked; one LM
    step at lambda 1e-4, 40 PCG iterations, tol 1e-10, with
    rcs.MATVEC_BF16 on against off, held to the reference's bounds (:49-97):
    the linearized costs within 1e-6, step cosine > 0.999, relative step
    difference < 0.05, model reduction within 2e-2 and new cost within
    1e-3;
  * the fused linearizers against the generic AD path
    (`factors.linearize_generic`, torch.func) on the same blocked batches,
    at the reference's bounds: K1 on that problem (residual 1e-5, validity
    1e-6, J 2e-4), K11 on it with the camera intrinsics and extrinsics
    estimated (J 3e-4), K7 on the tiny full-sensor session of
    tests/_torch_port_fixtures.py (the reference builds a 60 s / 2,000-point
    one through a JAX tool; residual 1e-4 on the valid slots, validity
    equal, J 3e-4). The generic path runs on the same inputs in float64:
    the port's kernels compute their primal chain in float64 registers, so
    a float32 generic path is the less exact side (its own rounding, 1.5e-5
    of the residuals' max-abs on the 60 s problem, is above the bound);
    the reference ran both sides in float32 on its TPU.

Of the reference's other tests, `test_table_kernels_pallas_vs_xla` holds
each segment kernel against its plain version, which
tests/test_torch_kernels_cuda.py does for every CUDA kernel, and
`test_windowed_rig_kernels_match_resident` has no counterpart: the windowed
mode of the rig-grid kernels is a TPU workaround (scoped VMEM) that the
port does not carry (ROADMAP, "Not carried over").
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port_fixtures import cuda_device  # noqa: F401  (fixture)
from _torch_port_fixtures import port_full_built, rel

from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.pipeline.builder import (BuildOptions,
                                                                          build_synthetic_problem)
from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as fct
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

SESSION = dict(duration=60.0, keyframe_hz=10.0, gyro_hz=200.0, accel_hz=200.0, num_points=300,
               seed=9, pixel_noise=0.3)
NOISE = dict(init_pose_noise=0.005, init_point_noise=0.03, init_vel_noise=0.03)


def _blocked_problem(dev, **options):
    """The reference's ~60 s session on the card in float32, blocked (its
    visual batch holds >= 16,384 observations, the blocking threshold)."""
    p = build_synthetic_problem(SyntheticSession(**SESSION), BuildOptions(**NOISE, **options),
                                device=dev, dtype=torch.float32)
    p._build()
    assert any(c.block_info is not None for c in p.cfgs)
    return p


def _one_step(problem, lam=1e-4, iters=40, tol=1e-10):
    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    lg = ks[0](datas, v, masks, None)
    asm = ks[6](datas, lg, v, masks)
    out = ks[7](asm, datas, lg, v, masks, lam, iters, tol)
    torch.cuda.synchronize()
    return lg, asm, out


def _flat_step(out):
    x_r, x_l = out[0], out[1]
    parts = [getattr(x_r, f).double().reshape(-1) for f in x_r._fields]
    return torch.cat(parts + [x_l.double().reshape(-1)]).cpu().numpy()


@pytest.mark.cuda
def test_bf16_matvec_step_agreement(cuda_device, monkeypatch):
    """One LM step with bf16 J storage in the PCG loop against float32 J:
    the PCG solves a consistently rounded operator, so the step agrees in
    direction, model reduction and achieved cost within the reference's
    bounds; the bf16 instantiations of K3, K4 and K5 ran."""
    problem = _blocked_problem(cuda_device)
    monkeypatch.setattr(rcs, "MATVEC_BF16", True)
    _kernels.reset_launch_counts()
    lg_a, asm_a, out_a = _one_step(problem)
    bf16 = _kernels.launch_counts(bf16=True)
    monkeypatch.setattr(rcs, "MATVEC_BF16", False)
    lg_b, asm_b, out_b = _one_step(problem)
    (b_a,), (b_b,) = asm_a.vis, asm_b.vis
    assert rcs._rig_only_fast(b_a) and b_a.J_mv is not None and b_b.J_mv is None
    assert all(bf16[k] > 0 for k in ("precond_rig", "schur_pcg", "schur_up")), bf16

    # linearization (float32 both ways) must agree tightly
    np.testing.assert_allclose(float(lg_a.cost), float(lg_b.cost), rtol=1e-6)
    sa, sb = _flat_step(out_a), _flat_step(out_b)
    cos = float(sa @ sb / (np.linalg.norm(sa) * np.linalg.norm(sb)))
    assert cos > 0.999, f"step direction cosine {cos}"
    rel_step = float(np.linalg.norm(sa - sb) / np.linalg.norm(sb))
    assert rel_step < 0.05, f"step relative L2 difference {rel_step}"
    # model reduction and achieved new cost agree
    np.testing.assert_allclose(float(out_a[2]), float(out_b[2]), rtol=2e-2)
    np.testing.assert_allclose(float(out_a[9].cost), float(out_b[9].cost), rtol=1e-3)


def _fused_vs_generic(problem, kind, groups, tol_res, tol_j, valid_equal=False):
    """linearize_batch (the fused kernel) against linearize_generic on each
    blocked batch of `kind` with `groups` active; returns how many."""
    v, masks = problem.variables, problem.masks
    checked = 0
    for cfg, data in zip(problem.cfgs, problem.datas):
        if cfg.kind != kind or cfg.block_info is None:
            continue
        cfg = dataclasses.replace(cfg, active_groups=groups)
        assert fct.fused_linearizer(cfg)
        _kernels.reset_launch_counts()
        lin_f = fct.linearize_batch(cfg, data, v, masks)
        assert sum(_kernels.launch_counts().values()) == 1
        lin_g = fct.linearize_generic(cfg, *_kernels.to_f64((data, v, masks)))
        torch.cuda.synchronize()
        assert lin_f.groups == lin_g.groups and set(lin_f.groups) == set(groups)
        real = data["_pad"].cpu().numpy() < 0.5
        vf, vg = lin_f.valid.cpu().numpy(), lin_g.valid.cpu().numpy()
        ok = real & (vg > 0.5) if valid_equal else real
        if valid_equal:
            np.testing.assert_array_equal(vf[real], vg[real])
        else:
            assert rel(vf[real], vg[real]) < 1e-6
        assert rel(lin_f.res.cpu().numpy()[:, ok], lin_g.res.cpu().numpy()[:, ok]) < tol_res
        for g, Jf, Jg in zip(lin_f.groups, lin_f.jac, lin_g.jac):
            assert rel(Jf.cpu().numpy()[..., ok], Jg.cpu().numpy()[..., ok]) < tol_j, g
        checked += 1
    return checked


@pytest.mark.cuda
def test_fused_visual_linearizer_matches_generic(cuda_device):
    """K1 (ops/visual_fused.py) against the generic AD path."""
    problem = _blocked_problem(cuda_device)
    assert _fused_vs_generic(problem, "visual", (fct.POINTS, fct.RIG), 1e-5, 2e-4)


@pytest.mark.cuda
def test_fused_visual_cal_linearizer_matches_generic(cuda_device):
    """K11 (the calibration-coupled visual kernel: point, pose, camera
    extrinsics and intrinsics) against the generic AD path, with the camera
    calibration estimated."""
    problem = _blocked_problem(cuda_device, estimate_cam_intr=True, estimate_cam_extr=True)
    groups = (fct.POINTS, fct.RIG, fct.CAM_EXTR, fct.CAM_INTR)
    assert _fused_vs_generic(problem, "visual", groups, 1e-5, 3e-4)


@pytest.mark.cuda
def test_fused_rs_linearizer_matches_generic(cuda_device):
    """K7 (ops/rs_fused.py) against the generic AD path on the tiny
    full-sensor session (rolling shutter, readout and time offset
    estimated), every tangent of the batch active."""
    problem, _ = port_full_built(device=cuda_device, dtype=torch.float32)
    problem._build()
    groups = tuple(g for g, _ in fct.REGISTRY["rs_visual"]["tangents"])
    assert _fused_vs_generic(problem, "rs_visual", groups, 1e-4, 3e-4, valid_equal=True)
