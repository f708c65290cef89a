"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it runs on a GPU machine that has none; the suite's
conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Inputs: the port's own tiny blocked problem (the 6 s / 60-landmark session
of tests/_torch_port_fixtures.py, blocked by rcs.finalize_blocks(rb=8,
prb=16, ts=64)) on the card in float32, its real J blocks from one
linearization, and rig/landmark tables from a numpy seed. Each kernel is
held against its plain version evaluated in float64 on the same inputs,
within the JAX package's on-chip bounds (tests/test_tpu_accuracy.py):
K1 residual 1e-5 and J 2e-4, segment kernels 1e-5, relative to max-abs.
"""

import math

import numpy as np
import pytest
import torch
from _torch_port_fixtures import cuda_device  # noqa: F401  (fixture)
from _torch_port_fixtures import port_blocked_problem, rel

from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.ops import visual_fused
from visual_inertial_bundle_adjustment_tpu_torch.problem import optimizer as topt
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

SEGMENT_KERNELS = ("assemble_rig", "precond_rig", "schur_down", "schur_up", "schur_pcg")


def _card_problem(dev):
    p = port_blocked_problem(device=dev, dtype=torch.float32)
    ks = p._build()
    (vi,) = [i for i, c in enumerate(p.active_cfgs) if c.block_info is not None]
    return p, ks, vi


def _segment_inputs(dev):
    p, ks, _ = _card_problem(dev)
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    (b, lin), = trcs._vis_batches(p.active_cfgs, datas, lg)
    R, L = p.variables.pose_q.shape[0], p.variables.points.shape[0]
    rng = np.random.default_rng(41)
    A = rng.normal(size=(L, 3, 3))

    def f32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    return b.plan, dict(J=b.J, J_pt=b.J_pt, res=lin.res, w=b.w, x=f32(rng.normal(size=(R, 6))),
                        z=f32(rng.normal(size=(L, 3))),
                        hinv=f32(A @ np.swapaxes(A, -1, -2) + np.eye(3)))


def _segment(name, a, plan):
    J, J_pt, w = a["J"], a["J_pt"], a["w"]
    if name == "assemble_rig":
        return tseg.seg_assemble_rig(J, J_pt, a["res"], w, plan)
    if name == "precond_rig":
        return (tseg.seg_precond_rig(J, J_pt, w, a["hinv"], plan),)
    if name == "schur_down":
        return tseg.seg_schur_down(J, J_pt, w, a["x"], plan)
    if name == "schur_up":
        return (tseg.seg_schur_up(J, J_pt, w, a["z"], plan),)
    return (tseg.seg_schur_pcg(J, J_pt, w, a["x"], a["hinv"], plan),)


@pytest.mark.cuda
@pytest.mark.parametrize("with_jac", [True, False])
def test_visual_linearize_kernel_matches_plain(with_jac, cuda_device):
    p, _, vi = _card_problem(cuda_device)
    cfg, data = p.active_cfgs[vi], p.datas[vi]
    masks = p.masks if with_jac else None
    _kernels.reset_launch_counts()
    out = visual_fused.visual_linearize(cfg.camera_kind, data, p.variables, masks, with_jac)
    with _kernels.plain_reference():
        f64 = _kernels.to_f64
        ref = visual_fused.visual_linearize(cfg.camera_kind, f64(data), f64(p.variables), f64(masks),
                                            with_jac)
    torch.cuda.synchronize()
    assert visual_fused.visual_linearize.launches == 1
    for o, r, tol in zip(out, ref, (1e-5, 0.0, 2e-4, 2e-4)):
        assert o.dtype == torch.float32 and o.device.type == "cuda"
        assert rel(o.cpu().numpy(), r.cpu().numpy()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEGMENT_KERNELS)
def test_segment_kernel_matches_plain(name, cuda_device):
    plan, a = _segment_inputs(cuda_device)
    _kernels.reset_launch_counts()
    out = _segment(name, a, plan)
    with _kernels.plain_reference():
        ref = _segment(name, _kernels.to_f64(a), plan)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    if name == "schur_pcg":
        assert counts["schur_down"] == counts["schur_up"] == 1
    else:
        assert counts[name] == 1
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        if o is None:
            continue
        assert rel(o.cpu().numpy(), r.cpu().numpy()) < 1e-5


@pytest.mark.cuda
def test_optimize_on_card_runs_every_kernel(cuda_device):
    """Three LM iterations through the kernels: the cost falls, every kernel
    launched, and the costs follow those of the same run through the plain
    versions on the card (both float32, summed in different orders)."""
    settings = dict(max_iterations=3, direct_mode=False, pcg_max_iterations=40)
    _kernels.reset_launch_counts()
    s_k = topt.optimize(_card_problem(cuda_device)[0], topt.LMSettings(**settings))
    counts = _kernels.launch_counts()
    with _kernels.plain_reference():
        s_p = topt.optimize(_card_problem(cuda_device)[0], topt.LMSettings(**settings))
    assert all(n > 0 for n in counts.values()), counts
    assert math.isfinite(s_k.final_cost) and s_k.final_cost < 1e-2 * s_k.initial_cost
    assert abs(s_k.initial_cost - s_p.initial_cost) <= 1e-5 * s_p.initial_cost
    assert abs(s_k.final_cost - s_p.final_cost) <= 1e-3 * s_p.final_cost
