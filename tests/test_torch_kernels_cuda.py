"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it runs on a GPU machine that has none; the suite's
conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Inputs: the port's own tiny blocked problems of tests/_torch_port_fixtures.py
on the card in float32 — the bias-only 6 s / 60-landmark session (K1-K6; the
same one blocked without landmark windows for the table kernels K12, K13 of
the general path), the full-sensor 8 s / 80-landmark session built by the
session adapter (K7-K10, K3 at rig_k = 9) and the same session with a
global-shutter camera (K11; K8-K10 at rig_k = 6; with the detector bias
estimated, the general path's chunked few-row groups) — their real J blocks
from one linearization, and rig/window/landmark tables from a numpy seed.
Each kernel is held against its plain version evaluated in float64 on the
same inputs, within the JAX package's on-chip bounds
(tests/test_tpu_accuracy.py): K1 residual 1e-5 and J 2e-4, K7 residual 1e-4
and J 3e-4, K11 residual 1e-5 and J 3e-4, segment kernels 1e-5, relative to
max-abs. The tile kernels K14a-e run on the two-grid problem's rig-sorted
and point-sorted grids, on a grid of random, unsorted local indices (rows
no slot addresses, locals outside the window) and on an edge grid of tiles
of 1,031 slots (a tile that addresses nothing, one row holding all of a
tile's slots, a row of one slot; K14a at D 1, 3, 9 and 12, K14b at D 1, 3
and 6, K14c and K14e at k 3, 6 and 9; K14a and K14c also against the
designs they replaced), and K14a, K14c and K14e at the largest window
their shared memory allows and one row past it (refused before any
launch); K8-K10 also at the window
widths kc = 17 and 6 (the extrinsics or the intrinsics held constant). An
LM attempt of the full-sensor problem and of an unblocked problem calls no
scattering operator that sums with float atomics (index_add_ and kin, seen
through a TorchFunctionMode) and repeats bit for bit. K9 also runs at every
rig and window width on the full-sensor plans and on a made-up plan with an
empty rig, rigs on three window rows, a landmark of one slot and one of
none; K13c on landmark rows of 0, 1 and 2,000 slots, through the slot-major
copy and, on a family not marked scattered, the walk. K4 runs at rig widths 6
and 9 on the bias-only plan and on that made-up plan, also against K6's
down and K5's up around the 3x3 solve; K2 and K6 (with y and without) at
rig widths 6 and 9 on the bias-only plan and on that made-up plan; K4 and
K9 give the bits they gave before K6 shared their landmark pass (digests
of fixed inputs); K13a on the landmark
rows of the two-grid batch and
of the made-up plan through the slot-major copy, also against the walk. Each
repeats bit for bit. K8 runs at rig widths 6 and 9 and window widths 6, 17
and 23 on the full-sensor plans and on the made-up plan cut into chunks of
1, 0, 300 and the rest of a window row's slots, with a window row of none;
K7 in each of its instantiations (camera model, Jacobian, calibration
columns, masked or not); K1 (camera model, Jacobian, masked or not) and K11
(camera model, masked or not) in each of theirs. Each repeats bit for bit.
K4 and K9 on C right-hand sides (the covariance columns) run at 1, 8, 37,
48 and 256 columns, at rig widths 6 and 9 (K9 also at window widths 6, 17
and 23), on the bias-only and full-sensor plans and on the made-up plan,
against their plain versions and the single-column kernels on every
column; each repeats bit for bit; rig rows of 3,000 and 9,000 slots on one window row
and a landmark of 3,000 slots (the rig passes' chunks of their
shared-memory tiles, a lane class split across chunks). The tiny rolling-shutter and global-shutter recordings
merged by pipeline/multi_session.py (chip_smoke's multi path at the tiny
size): the merge on the card equals the merge of float64 CPU copies (tables
exact, landmarks 1e-6), and one LM attempt of the merged problem with its
base map runs K10's down and up in the two-pass PCG, repeats bit for bit
and agrees with the plain versions within 1e-3 in new cost and |step|.
K10's down pass (with y and t alone) and up pass, and K5, on the
full-sensor, global-shutter and merged batches' plans (the merged ones
with a third of each batch's slots moved to the next window row, so that
rigs span two): within 1e-5 of their plain versions, the same bits every
call, at most 3 / 2 / 2 / 1 device operations a call (torch.profiler); K5
also on the made-up plan, zeros for its rig without slots.
"""

import functools
import math

import numpy as np
import pytest
import torch
from _torch_port_fixtures import cuda_device  # noqa: F401  (fixture)
from _torch_port_fixtures import (BUILD, TWO_GRID_BLOCKS, port_blocked_problem, port_full_built,
                                  port_gs_built, port_merge_inputs, port_session, rel)
from torch.overrides import TorchFunctionMode

from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import rs_fused
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.ops import visual_fused
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import multi_session as tms
from visual_inertial_bundle_adjustment_tpu_torch.problem import optimizer as topt
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

SEGMENT_KERNELS = ("assemble_rig", "precond_rig", "schur_down", "schur_up", "schur_pcg")
CAL_KERNELS = ("assemble_cal", "schur_down_cal", "schur_up_cal", "schur_pcg_cal", "precond_rig")
TABLE_KERNELS = ("mv_fused_table", "mv_scatter_table", "mv_gather_table", "reduce_table")


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
    assert counts[name] == 1 and sum(counts.values()) == 1
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
    assert all(counts[k] > 0 for k in ("visual_linearize", *SEGMENT_KERNELS)), counts
    assert math.isfinite(s_k.final_cost) and s_k.final_cost < 1e-2 * s_k.initial_cost
    assert abs(s_k.initial_cost - s_p.initial_cost) <= 1e-5 * s_p.initial_cost
    assert abs(s_k.final_cost - s_p.final_cost) <= 1e-3 * s_p.final_cost


# ---------------------------------------------------------------------------
# full-sensor path: K7-K10, K3 at rig_k = 9
# ---------------------------------------------------------------------------


def _full_card(dev):
    p, _ = port_full_built(device=dev, dtype=torch.float32)
    ks = p._build()
    (vi,) = [i for i, c in enumerate(p.active_cfgs) if c.block_info is not None]
    return p, ks, vi


def _check(out, ref, tols):
    torch.cuda.synchronize()
    for o, r, tol in zip(out, ref, tols):
        assert o.dtype == torch.float32 and o.device.type == "cuda"
        assert rel(o.cpu().numpy(), r.cpu().numpy()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("with_jac,with_cal", [(True, True), (True, False), (False, False)])
def test_rs_linearize_kernel_matches_plain(with_jac, with_cal, cuda_device):
    p, _, vi = _full_card(cuda_device)
    cfg, data = p.active_cfgs[vi], p.datas[vi]
    masks = p.masks if with_jac else None
    _kernels.reset_launch_counts()
    out = rs_fused.rs_linearize(cfg.camera_kind, data, p.variables, masks, with_jac, with_cal)
    f64 = _kernels.to_f64
    with _kernels.plain_reference():
        ref = rs_fused.rs_linearize(cfg.camera_kind, f64(data), f64(p.variables), f64(masks),
                                    with_jac, with_cal)
    assert rs_fused.rs_linearize.launches == 1
    _check(out, ref, (1e-4, 0.0, 3e-4, 3e-4, 3e-4))


def _cal_inputs(dev):
    p, ks, _ = _full_card(dev)
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    (b, lin), = trcs._vis_batches(p.active_cfgs, datas, lg)
    v = p.variables
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    rng = np.random.default_rng(43)
    A = rng.normal(size=(L, 3, 3))

    def f32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    return b, dict(J=b.J, J_cal=b.J_cal, J_pt=b.J_pt, res=lin.res, w=b.w,
                   x=f32(rng.normal(size=(R, 9))), x_c=f32(rng.normal(size=(n_c, 23))),
                   z=f32(rng.normal(size=(L, 3))), hinv=f32(A @ np.swapaxes(A, -1, -2) + np.eye(3)))


def _cal_segment(name, a, b):
    J, Jc, Jp, w = a["J"], a["J_cal"], a["J_pt"], a["w"]
    if name == "assemble_cal":
        g_r, d_r, g_c, d_c, blocks, g_l, H = tseg.seg_assemble_cal(J, Jc, Jp, a["res"], w, b.plan,
                                                                   b.cplan)
        return (g_r, d_r, g_c, d_c, *blocks, g_l, H)
    if name == "schur_down_cal":
        return tseg.seg_schur_down_cal(J, Jc, Jp, w, a["x"], a["x_c"], b.plan, b.cplan)
    if name == "schur_up_cal":
        return tseg.seg_schur_up_cal(J, Jc, Jp, w, a["z"], b.plan, b.cplan)
    if name == "schur_pcg_cal":
        return tseg.seg_schur_pcg_cal(J, Jc, Jp, w, a["x"], a["x_c"], a["hinv"], b.plan, b.cplan)
    return (tseg.seg_precond_rig(J, Jp, w, a["hinv"], b.plan),)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CAL_KERNELS)
def test_cal_segment_kernel_matches_plain(name, cuda_device):
    b, a = _cal_inputs(cuda_device)
    assert b.rig_k == 9 and trcs._cal_fast(b)
    _kernels.reset_launch_counts()
    out = _cal_segment(name, a, b)
    with _kernels.plain_reference():
        ref = _cal_segment(name, _kernels.to_f64(a), b)
    counts = _kernels.launch_counts()
    assert counts[name] == 1 and sum(counts.values()) == 1
    _check(out, ref, (1e-5,) * len(out))


@pytest.mark.cuda
def test_full_sensor_optimize_on_card_runs_every_kernel(cuda_device):
    """Three LM iterations of the full-sensor problem through the kernels:
    the cost falls, K3 and K7-K10 launched, and the costs follow those of
    the same run through the plain versions (float32, other summation
    orders, K7's float64 registers)."""
    settings = dict(max_iterations=3, direct_mode=False, pcg_max_iterations=40)
    _kernels.reset_launch_counts()
    s_k = topt.optimize(_full_card(cuda_device)[0], topt.LMSettings(**settings))
    counts = _kernels.launch_counts()
    with _kernels.plain_reference():
        s_p = topt.optimize(_full_card(cuda_device)[0], topt.LMSettings(**settings))
    assert all(counts[k] > 0 for k in ("rs_linearize", *CAL_KERNELS)), counts
    assert math.isfinite(s_k.final_cost) and s_k.final_cost < 1e-2 * s_k.initial_cost
    assert abs(s_k.initial_cost - s_p.initial_cost) <= 1e-5 * s_p.initial_cost
    assert abs(s_k.final_cost - s_p.final_cost) <= 1e-3 * s_p.final_cost


# ---------------------------------------------------------------------------
# global-shutter calibration path: K11, K8-K10 and K3 at rig_k = 6
# ---------------------------------------------------------------------------


def _gs_card(dev, use_detector_bias=False):
    p, _ = port_gs_built(use_detector_bias, device=dev, dtype=torch.float32)
    ks = p._build()
    (vi,) = [i for i, c in enumerate(p.active_cfgs) if c.block_info is not None]
    return p, ks, vi


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_visual_cal_linearize_kernel_matches_plain(masked, cuda_device):
    p, _, vi = _gs_card(cuda_device)
    cfg, data = p.active_cfgs[vi], p.datas[vi]
    assert cfg.kind == "visual"
    masks = p.masks if masked else None
    _kernels.reset_launch_counts()
    out = visual_fused.visual_cal_linearize(cfg.camera_kind, data, p.variables, masks)
    f64 = _kernels.to_f64
    with _kernels.plain_reference():
        ref = visual_fused.visual_cal_linearize(cfg.camera_kind, f64(data), f64(p.variables),
                                                f64(masks))
    counts = _kernels.launch_counts()
    assert counts["visual_cal_linearize"] == 1 and sum(counts.values()) == 1
    assert out[4].shape[1] == 23 and float(out[3][:, 6:].abs().max()) == 0.0
    _check(out, ref, (1e-5, 0.0, 3e-4, 3e-4, 3e-4))


@pytest.mark.cuda
def test_gs_cal_optimize_on_card_runs_every_kernel(cuda_device):
    """Three LM iterations of the global-shutter calibration problem through
    the kernels (K11 linearizes, K1 gives the cost, K8-K10 and K3 run at
    rig_k = 6): the cost falls and follows the plain versions' run."""
    settings = dict(max_iterations=3, direct_mode=False, pcg_max_iterations=40)
    _kernels.reset_launch_counts()
    s_k = topt.optimize(_gs_card(cuda_device)[0], topt.LMSettings(**settings))
    counts = _kernels.launch_counts()
    with _kernels.plain_reference():
        s_p = topt.optimize(_gs_card(cuda_device)[0], topt.LMSettings(**settings))
    assert all(counts[k] > 0 for k in ("visual_cal_linearize", "visual_linearize",
                                       *CAL_KERNELS)), counts
    assert counts["rs_linearize"] == 0
    assert math.isfinite(s_k.final_cost) and s_k.final_cost < 1e-2 * s_k.initial_cost
    assert abs(s_k.initial_cost - s_p.initial_cost) <= 1e-5 * s_p.initial_cost
    assert abs(s_k.final_cost - s_p.final_cost) <= 1e-3 * s_p.final_cost


# ---------------------------------------------------------------------------
# general (two-grid) path: K12, K13
# ---------------------------------------------------------------------------


def _two_grid_card(dev):
    p = port_blocked_problem(device=dev, dtype=torch.float32, blocks=TWO_GRID_BLOCKS)
    ks = p._build()
    (vi,) = [i for i, c in enumerate(p.active_cfgs) if c.block_info is not None]
    return p, ks, vi


def _table_inputs(dev):
    p, ks, vi = _two_grid_card(dev)
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    (b, _), = trcs._vis_batches(p.active_cfgs, datas, lg)
    assert not trcs._single_pass(b) and b.groups == ("rig",)
    R, L = p.variables.pose_q.shape[0], p.variables.points.shape[0]
    N = b.w.shape[0]
    rng = np.random.default_rng(47)
    real = (1.0 - p.datas[vi]["_pad"])[None]

    def f32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    # a family of three long rows cut into 16-slot chunks, as the camera and
    # detector-bias rows of the general path are
    row = rng.integers(0, 3, size=N)
    pad = p.datas[vi]["_pad"].cpu().numpy()
    chunked = tseg.chunked_rows(
        torch.from_numpy(row.astype(np.int32)).to(dev),
        {k: torch.from_numpy(a).to(dev) for k, a in
         tseg.cal_plan_arrays(row, pad, 3, chunk=16).items()})
    rows = dict(rig=tseg.rig_rows(b.plan), point=tseg.point_rows(b.plan), chunked=chunked)
    return rows, dict(
        J=dict(rig=b.J, point=b.J_pt, chunked=b.J), w=b.w,
        x=dict(rig=f32(rng.normal(size=(R, 6))), point=f32(rng.normal(size=(L, 3))),
               chunked=f32(rng.normal(size=(3, 6)))),
        u=f32(rng.normal(size=(2, N))) * real,
        contrib={D: f32(rng.normal(size=(D, N))) * real for D in (3, 6, 9, 36)})


def _table(name, family, a, rows, D):
    J, r = a["J"][family], rows[family]
    if name == "mv_fused_table":
        return tseg.seg_mv_fused_table(J, a["w"], a["x"][family], r)
    if name == "mv_scatter_table":
        return (tseg.seg_mv_scatter_table(J, a["u"], r),)
    if name == "mv_gather_table":
        return (tseg.seg_mv_gather_table(J, a["x"][family], r),)
    return (tseg.seg_reduce_table(a["contrib"][D], r),)


@pytest.mark.cuda
@pytest.mark.parametrize("name,family,D", [
    ("mv_fused_table", "rig", 0), ("mv_fused_table", "chunked", 0),
    ("mv_scatter_table", "rig", 0), ("mv_scatter_table", "point", 0),
    ("mv_scatter_table", "chunked", 0), ("mv_gather_table", "rig", 0),
    ("mv_gather_table", "point", 0), ("reduce_table", "rig", 6), ("reduce_table", "rig", 36),
    ("reduce_table", "point", 3), ("reduce_table", "point", 9), ("reduce_table", "chunked", 36)])
def test_table_kernel_matches_plain(name, family, D, cuda_device):
    rows, a = _table_inputs(cuda_device)
    _kernels.reset_launch_counts()
    out = _table(name, family, a, rows, D)
    again = _table(name, family, a, rows, D)
    with _kernels.plain_reference():
        ref = _table(name, family, _kernels.to_f64(a), rows, D)
    counts = _kernels.launch_counts()
    assert counts[name] == 2 and sum(counts.values()) == 2
    _check(out, ref, (1e-5,) * len(out))
    for o, o2 in zip(out, again):  # row-owned ordered sums: the same bits every call
        assert torch.equal(o, o2)


@pytest.mark.cuda
def test_two_grid_optimize_on_card_runs_every_kernel(cuda_device):
    """Three LM iterations of the two-grid problem through the kernels: the
    cost falls, K1, K12 and K13a-c launched and none of the single-pass
    segment kernels, and the costs follow the plain versions' run."""
    settings = dict(max_iterations=3, direct_mode=False, pcg_max_iterations=40)
    _kernels.reset_launch_counts()
    s_k = topt.optimize(_two_grid_card(cuda_device)[0], topt.LMSettings(**settings))
    counts = _kernels.launch_counts()
    with _kernels.plain_reference():
        s_p = topt.optimize(_two_grid_card(cuda_device)[0], topt.LMSettings(**settings))
    assert all(counts[k] > 0 for k in ("visual_linearize", *TABLE_KERNELS)), counts
    assert all(counts[k] == 0 for k in SEGMENT_KERNELS), counts
    assert math.isfinite(s_k.final_cost) and s_k.final_cost < 1e-2 * s_k.initial_cost
    assert abs(s_k.initial_cost - s_p.initial_cost) <= 1e-5 * s_p.initial_cost
    assert abs(s_k.final_cost - s_p.final_cost) <= 1e-3 * s_p.final_cost


@pytest.mark.cuda
def test_general_groups_on_card_are_repeatable(cuda_device):
    """With the detector bias estimated the batch carries rig, cam_extr,
    cam_intr and det_bias and takes the general path: the camera and bias
    rows reduce through chunked plans (K13c), so the damped matvec gives the
    same bits on every call and agrees with the plain versions."""
    p, ks, _ = _gs_card(cuda_device, use_detector_bias=True)
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    asm = ks[6](datas, lg, p.variables, p.masks)
    (b,) = asm.vis
    assert not trcs._single_pass(b)
    assert b.groups == ("rig", "cam_extr", "cam_intr", "det_bias")
    assert all(r.row_chunk is not None for r in b.rows[1:])
    rs = trcs.with_damping(asm, p.variables, p.masks, 1e-4)
    rng = np.random.default_rng(53)
    zt = tst.zero_tangent(p.variables)
    x = tst.Tangent(**{f: torch.from_numpy(rng.normal(size=tuple(getattr(zt, f).shape))).to(
        device=cuda_device, dtype=torch.float32) for f in zt._fields})
    _kernels.reset_launch_counts()
    y1 = trcs.matvec(rs, p.variables, x)
    y2 = trcs.matvec(rs, p.variables, x)
    counts = _kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("mv_scatter_table", "mv_gather_table", "reduce_table"))
    f64 = _kernels.to_f64
    with _kernels.plain_reference():
        asm64 = ks[6](f64(datas), f64(lg), f64(p.variables), f64(p.masks))
        rs64 = trcs.with_damping(asm64, f64(p.variables), f64(p.masks), 1e-4)
        ref = trcs.matvec(rs64, f64(p.variables), f64(x))
    torch.cuda.synchronize()
    for f in y1._fields:
        assert torch.equal(getattr(y1, f), getattr(y2, f)), f
        # float32 sums of up to a few thousand terms against float64
        assert rel(getattr(y1, f).cpu().numpy(), getattr(ref, f).cpu().numpy()) <= 1e-4, f


# ---------------------------------------------------------------------------
# tile-partials kernels K14a-e
# ---------------------------------------------------------------------------


EDGE_TS = 1031  # not a multiple of 4 (nor of 32): N D has a tail at D 1, 3 and 6


def _edge_locals(rng):
    """Three tiles of EDGE_TS slots in a 64-row window: tile 0 addresses
    nothing (-1 and 64); tile 1 puts all its slots in row 5 (the longest
    row, cut into the most pieces); tile 2 holds row 63 in one slot and
    unsorted locals in [-1, 40] elsewhere (more runs than K14e caches)."""
    ts = EDGE_TS
    none = np.where(np.arange(ts) % 2 == 0, -1, 64)
    one_row = np.full(ts, 5)
    mixed = rng.integers(-1, 41, size=ts)
    mixed[500] = 63
    return np.concatenate([none, one_row, mixed]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _tile_grids(dev):
    """(local, nt, ts, rb) of the two-grid problem's rig and point grids, of
    a random grid: unsorted locals in [-1, 40] of a 64-row window (rows
    41-63 empty, -1 addresses nothing), and of the edge grid (_edge_locals)."""
    p, _, vi = _two_grid_card(dev)
    d, info = p.datas[vi], p.cfgs[vi].block_info
    rng = np.random.default_rng(59)
    rand = torch.from_numpy(rng.integers(-1, 41, size=5 * 300).astype(np.int32)).to(dev)
    edge = torch.from_numpy(_edge_locals(rng)).to(dev)
    return {"rig": (d["_rb_local"], info.nt, info.ts, info.rb),
            "point": (d["_pt_local"], info.pnt, info.pts, info.prb),
            "random": (rand, 5, 300, 64), "edge": (edge, 3, EDGE_TS, 64)}


def _tile(name, a, local, nt, ts, rb):
    if name == "reduce_partials":
        return (tseg.seg_reduce_partials(a["contrib"], local, nt, ts, rb),)
    if name == "gather_from_tiles":
        return (tseg.seg_gather_from_tiles(a["xt"], local, nt, ts, rb),)
    if name == "mv_fused":
        return tseg.seg_mv_fused(a["J"], a["w"], a["xt"], local, nt, ts, rb)
    if name == "mv_gather":
        return (tseg.seg_mv_gather(a["J"], a["xt"], local, nt, ts, rb),)
    return (tseg.seg_mv_scatter(a["J"], a["u"], local, nt, ts, rb),)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["rig", "point", "random", "edge"])
@pytest.mark.parametrize("name,k", [
    ("reduce_partials", 9), ("reduce_partials", 3), ("reduce_partials", 1),
    ("reduce_partials", 12), ("gather_from_tiles", 3), ("gather_from_tiles", 6),
    ("gather_from_tiles", 1), ("mv_fused", 6), ("mv_fused", 3), ("mv_fused", 9),
    ("mv_gather", 3), ("mv_gather", 6), ("mv_scatter", 3), ("mv_scatter", 6),
    ("mv_scatter", 9)])
def test_tile_kernel_matches_plain(name, k, grid, cuda_device):
    """Each K14 kernel within 1e-5 of its plain version in float64, one
    launch a call, the same bits on every call; on the edge grid the tile that
    addresses nothing gives zeros (its partials, its slots' rows, K14c's wu
    of its slots, which no memset clears)."""
    local, nt, ts, rb = _tile_grids(cuda_device)[grid]
    n = nt * ts
    rng = np.random.default_rng(61)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape)).to(device=cuda_device,
                                                           dtype=torch.float32)

    a = dict(contrib=f32(k, n), J=f32(2, k, n), w=f32(n), u=f32(2, n), xt=f32(nt, rb, k))
    _kernels.reset_launch_counts()
    out = _tile(name, a, local, nt, ts, rb)
    again = _tile(name, a, local, nt, ts, rb)
    with _kernels.plain_reference():
        ref = _tile(name, _kernels.to_f64(a), local, nt, ts, rb)
    counts = _kernels.launch_counts()
    assert counts[name] == 2 and sum(counts.values()) == 2
    _check(out, ref, (1e-5,) * len(out))
    for o, o2 in zip(out, again):  # ordered sums: the same bits every call
        assert torch.equal(o, o2)
    if grid == "edge":  # tile 0: its partials, or its slots' rows
        empty = {"gather_from_tiles": out[0][:ts], "mv_gather": out[0][:, :ts]}.get(name,
                                                                                  out[-1][0])
        assert float(empty.abs().max()) == 0.0
        if name == "mv_fused":
            assert float(out[0][:, :ts].abs().max()) == 0.0


# The reduce side's largest window at ts 4,096: the tile's shared memory
# (tile_segments.cu tile_smem) reaches 227 KB one row later. K14e and K14c
# stage a chunk (k 9: 1,344 slots) beside 8 warp partials of each row; K14a
# (D 9) holds the warp partials alone.
SMEM_MAX_RB = {"mv_scatter": 618, "mv_fused": 618, "reduce_partials": 781}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMEM_MAX_RB))
def test_tile_kernel_refuses_a_window_past_shared_memory(name, cuda_device):
    """One tile of 4,096 slots at k 9 (K14a: D 9): at the largest window the
    tile's shared memory allows, the kernel runs and matches its plain
    version; one row more, the C entry refuses it and the wrapper raises
    before any launch (no launch counted, nothing left to fault)."""
    ts, k = 4096, 9
    rng = np.random.default_rng(97)
    for rb in (SMEM_MAX_RB[name], SMEM_MAX_RB[name] + 1):
        local = torch.from_numpy(rng.integers(0, rb, size=ts).astype(np.int32)).to(cuda_device)

        def f32(*shape):
            return torch.from_numpy(rng.normal(size=shape)).to(device=cuda_device,
                                                               dtype=torch.float32)

        a = dict(contrib=f32(k, ts), J=f32(2, k, ts), w=f32(ts), u=f32(2, ts), xt=f32(1, rb, k))
        _kernels.reset_launch_counts()
        if rb == SMEM_MAX_RB[name]:
            out = _tile(name, a, local, 1, ts, rb)
            with _kernels.plain_reference():
                ref = _tile(name, _kernels.to_f64(a), local, 1, ts, rb)
            _check(out, ref, (1e-5,) * len(out))
            assert _kernels.launch_counts()[name] == 1
        else:
            with pytest.raises(RuntimeError, match="invalid argument"):
                _tile(name, a, local, 1, ts, rb)
            torch.cuda.synchronize()
            assert sum(_kernels.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# K8-K10 at the other window widths
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("constant,kc", [("cam_extr", 17), ("cam_intr", 6)])
@pytest.mark.parametrize("name", CAL_KERNELS[:4])
def test_cal_segment_kernel_any_column_split(name, constant, kc, cuda_device):
    p, _ = port_gs_built(device=cuda_device, dtype=torch.float32)
    p.masks = p.masks._replace(**{constant: torch.zeros_like(getattr(p.masks, constant))})
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    (b, lin), = trcs._vis_batches(p.active_cfgs, datas, lg)
    assert trcs._cal_fast(b) and b.J_cal.shape[1] == kc
    v = p.variables
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    rng = np.random.default_rng(67)
    A = rng.normal(size=(L, 3, 3))

    def f32(a):
        return torch.from_numpy(a).to(device=cuda_device, dtype=torch.float32)

    a = dict(J=b.J, J_cal=b.J_cal, J_pt=b.J_pt, res=lin.res, w=b.w,
             x=f32(rng.normal(size=(R, b.rig_k))), x_c=f32(rng.normal(size=(n_c, kc))),
             z=f32(rng.normal(size=(L, 3))), hinv=f32(A @ np.swapaxes(A, -1, -2) + np.eye(3)))
    _kernels.reset_launch_counts()
    out = _cal_segment(name, a, b)
    with _kernels.plain_reference():
        ref = _cal_segment(name, _kernels.to_f64(a), b)
    counts = _kernels.launch_counts()
    assert counts[name] == 1 and sum(counts.values()) == 1
    _check(out, ref, (1e-5,) * len(out))


# ---------------------------------------------------------------------------
# no float atomics on the card path; attempts repeat bit for bit
# ---------------------------------------------------------------------------


class _AtomicScatters(TorchFunctionMode):
    """Records every call of a PyTorch operator that sums into rows with
    float atomics on the card."""

    NAMES = {"index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_reduce", "index_reduce_"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        accumulate = kwargs.get("accumulate", len(args) > 3 and bool(args[3]))
        if name in self.NAMES or (name in ("index_put", "index_put_", "put", "put_")
                                  and accumulate):
            self.calls.append(name)
        return func(*args, **kwargs)


def _attempt(p):
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    asm = ks[6](datas, lg, p.variables, p.masks)
    out = ks[7](asm, datas, lg, p.variables, p.masks, 1e-4, 40, 1e-10)
    return out[9].cost, out[0], out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["full_sensor", "unblocked"])
def test_lm_attempt_uses_no_float_atomics_and_repeats(problem, cuda_device):
    if problem == "full_sensor":
        p = _full_card(cuda_device)[0]
    else:  # the tiny session's visual batch below the blocking threshold: the generic engine
        from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tb

        p = tb.build_synthetic_problem(port_session(), tb.BuildOptions(**BUILD),
                                       device=cuda_device, dtype=torch.float32)
        p._build()
        assert not any(c.block_info is not None for c in p.cfgs)
    guard = _AtomicScatters()
    with guard:
        cost, x_r, x_l = _attempt(p)
    torch.cuda.synchronize()
    assert not guard.calls, guard.calls
    cost2, x_r2, x_l2 = _attempt(p)
    assert torch.equal(cost, cost2) and torch.equal(x_l, x_l2)
    for a, b in zip(x_r, x_r2):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the point-sorted routes: K9 in four launches, K13c on landmark rows
# ---------------------------------------------------------------------------


def _recording_launches(monkeypatch):
    """The names of the C entry points launched, in order."""
    names, launch = [], _kernels.launch

    def record(name, *args):
        names.append(name)
        return launch(name, *args)

    monkeypatch.setattr(_kernels, "launch", record)
    return names


def _pcg_cal_args(w, plan, cplan, k, kc, dev, seed):
    """K9's inputs: weights w, random J blocks of rig width k and window
    width kc, tables and SPD landmark-block inverses over the plans."""
    n = w.shape[0]
    rng = np.random.default_rng(seed)
    L, R, n_c = plan.n_pts, plan.n_rows, cplan.n_rows
    A = rng.normal(size=(L, 3, 3))

    def f32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    return (f32(rng.normal(size=(2, k, n))), f32(rng.normal(size=(2, kc, n))),
            f32(rng.normal(size=(2, 3, n))), w, f32(rng.normal(size=(R, k))),
            f32(rng.normal(size=(n_c, kc))), f32(A @ np.swapaxes(A, -1, -2) + np.eye(3)))


def _pcg_cal_twice_vs_plain(args, plan, cplan, monkeypatch):
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_schur_pcg_cal(*args, plan, cplan)
    again = tseg.seg_schur_pcg_cal(*args, plan, cplan)
    with _kernels.plain_reference():
        ref = tseg.seg_schur_pcg_cal(*_kernels.to_f64(args), plan, cplan)
    counts = _kernels.launch_counts()
    assert counts["schur_pcg_cal"] == 2 and sum(counts.values()) == 2
    assert names == ["viba_schur_pcg_cal"] * 2
    _check(out, ref, (1e-5, 1e-5))
    for o, o2 in zip(out, again):  # ordered sums: the same bits every call
        assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [6, 17, 23])
@pytest.mark.parametrize("k", [6, 9])
def test_pcg_cal_kernel_every_width(k, kc, cuda_device, monkeypatch):
    """K9 on the full-sensor batch's plans at every rig and window width."""
    b, _ = _cal_inputs(cuda_device)
    args = _pcg_cal_args(b.w, b.plan, b.cplan, k, kc, cuda_device, 83 + k + kc)
    _pcg_cal_twice_vs_plain(args, b.plan, b.cplan, monkeypatch)


def _edge_plans(dev):
    """Plans of a made-up batch of 2,000 slots in four 500-slot tiles whose
    last 40 slots are pads: rig 2 has no slot, every rig's slots fall on
    three window rows, landmark 6 has one slot and landmark 7 none."""
    rng = np.random.default_rng(89)
    R, L, n_c, n = 6, 8, 3, 2000
    pad = np.zeros(n)
    pad.reshape(4, 500)[:, 460:] = 1.0
    real = np.nonzero(pad < 0.5)[0]
    rig = np.zeros(n, np.int64)
    rig[real] = np.sort(rng.choice([0, 1, 3, 4, 5], size=len(real)))
    rig[pad > 0.5] = np.maximum.accumulate(rig)[pad > 0.5]
    point = rng.integers(0, 6, size=n)
    point[real[777]] = 6
    win = rng.integers(0, n_c, size=n)
    arrays = trcs.segment_plan(rig, point, pad, R, L)
    cal = {**tseg.cal_plan_arrays(win, pad, n_c), **tseg.pair_plan_arrays(rig, win, pad, R, n_c)}

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    plan = tseg.SegPlan(i32(rig), i32(point), *(i32(arrays[k]) for k in (
        "_rig_ptr", "_rig_obs", "_pt_ptr", "_pt_obs", "_pt_pos")))
    cplan = tseg.CalPlan(i32(win), *(i32(cal["_cal_" + f]) for f in tseg.CalPlan._fields[1:]))
    assert np.diff(arrays["_pt_ptr"])[6:].tolist() == [1, 0]
    assert np.diff(arrays["_rig_ptr"])[2] == 0 and np.diff(cal["_cal_rig_pair"]).max() > 1
    return plan, cplan, pad


@pytest.mark.cuda
@pytest.mark.parametrize("k,kc", [(6, 17), (9, 23)])
def test_pcg_cal_kernel_edge_plan(k, kc, cuda_device, monkeypatch):
    plan, cplan, pad = _edge_plans(cuda_device)
    rng = np.random.default_rng(97)
    w = torch.from_numpy(rng.random(pad.shape[0]) * (1.0 - pad)).to(cuda_device, torch.float32)
    args = _pcg_cal_args(w, plan, cplan, k, kc, cuda_device, 101)
    _pcg_cal_twice_vs_plain(args, plan, cplan, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3, 9, 13])
@pytest.mark.parametrize("scattered", [True, False])
def test_landmark_reduce_rows_of_every_length(D, scattered, cuda_device, monkeypatch):
    """K13c on a landmark family with rows of 0, 1 and 2,000 slots: through
    the slot-major copy when the RowPlan is marked scattered, else the walk;
    at the widths of the landmark blocks (9) and gradient (3), and of point
    refinement's tables (13, 1)."""
    rng = np.random.default_rng(103)
    n, R, L = 6000, 4, 40
    pad = (rng.random(n) < 0.1).astype(np.float64)
    real = np.nonzero(pad < 0.5)[0]
    point = rng.integers(3, L, size=n)
    point[real[:2000]] = 2
    point[real[2000]] = 1
    rig = np.sort(rng.integers(0, R, size=n))
    arrays = trcs.segment_plan(rig, point, pad, R, L)
    assert np.diff(arrays["_pt_ptr"])[:3].tolist() == [0, 1, 2000]

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(cuda_device)

    rows = tseg.RowPlan(i32(point), i32(arrays["_pt_ptr"]), i32(arrays["_pt_obs"]),
                        scattered=scattered)
    contrib = torch.from_numpy(rng.normal(size=(D, n)) * (1.0 - pad)[None]).to(
        cuda_device, torch.float32)
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_reduce_table(contrib, rows)
    again = tseg.seg_reduce_table(contrib, rows)
    with _kernels.plain_reference():
        ref = tseg.seg_reduce_table(contrib.double(), rows)
    assert _kernels.launch_counts()["reduce_table"] == 2
    assert names == ["viba_seg_reduce_slot_major" if scattered else "viba_seg_reduce"] * 2
    _check((out,), (ref,), (1e-5,))
    assert torch.equal(out, again) and float(out[0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K4 in three launches, K13a on landmark rows through the slot-major copy
# ---------------------------------------------------------------------------


def _schur_pcg_args(w, plan, k, dev, seed):
    """K4's inputs: weights w, random J blocks of rig width k, a rig table
    and SPD landmark-block inverses over the plan."""
    n = w.shape[0]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(plan.n_pts, 3, 3))

    def f32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    return (f32(rng.normal(size=(2, k, n))), f32(rng.normal(size=(2, 3, n))), w,
            f32(rng.normal(size=(plan.n_rows, k))), f32(A @ np.swapaxes(A, -1, -2) + np.eye(3)))


@pytest.mark.cuda
@pytest.mark.parametrize("plan_kind", ["bias", "edge"])
@pytest.mark.parametrize("k", [6, 9])
def test_schur_pcg_kernel_every_width(k, plan_kind, cuda_device, monkeypatch):
    """K4 on the bias-only batch's plan and on the made-up plan (pads, an
    empty rig, landmarks of one slot and of none) at rig widths 6 and 9:
    one C entry a call, within 1e-5 of its plain version in float64 and of
    K6's down minus K5's up around the 3x3 solve, the same bits every
    call."""
    if plan_kind == "bias":
        plan, a = _segment_inputs(cuda_device)
        w = a["w"]
    else:
        plan, _, pad = _edge_plans(cuda_device)
        rng = np.random.default_rng(127)
        w = torch.from_numpy(rng.random(pad.shape[0]) * (1.0 - pad)).to(cuda_device,
                                                                         torch.float32)
    args = _schur_pcg_args(w, plan, k, cuda_device, 131 + k)
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_schur_pcg(*args, plan)
    again = tseg.seg_schur_pcg(*args, plan)
    with _kernels.plain_reference():
        ref = tseg.seg_schur_pcg(*_kernels.to_f64(args), plan)
    counts = _kernels.launch_counts()
    assert counts["schur_pcg"] == 2 and sum(counts.values()) == 2
    assert names == ["viba_schur_pcg"] * 2
    J_r, J_p, _, x, hinv = args
    y_down, t = tseg._launch_schur_down(J_r, J_p, w, x, plan, True)
    old = y_down - tseg._launch_schur_up(J_r, J_p, w, (hinv * t[:, None, :]).sum(-1), plan)
    _check((out, out), (ref, old), (1e-5, 1e-5))
    assert torch.equal(out, again)
    if plan_kind == "edge":
        assert float(out[2].abs().max()) == 0.0  # rig 2 has no slot


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["two_grid", "edge"])
def test_landmark_mv_scatter_slot_major(problem, cuda_device, monkeypatch):
    """K13a on landmark rows through the slot-major copy (the two-grid
    batch's rows; the made-up plan's, with landmarks of one slot and of none):
    within 1e-5 of its plain version in float64 and of the walk on the same
    rows, the same bits every call."""
    if problem == "two_grid":
        rows_by, a = _table_inputs(cuda_device)
        rows, J, u = rows_by["point"], a["J"]["point"], a["u"]
    else:
        plan, _, pad = _edge_plans(cuda_device)
        rows = tseg.point_rows(plan)
        rng = np.random.default_rng(137)
        J = torch.from_numpy(rng.normal(size=(2, 3, pad.shape[0]))).to(cuda_device,
                                                                        torch.float32)
        u = torch.from_numpy(rng.normal(size=(2, pad.shape[0])) * (1.0 - pad)[None]).to(
            cuda_device, torch.float32)
    assert rows.scattered
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_mv_scatter_table(J, u, rows)
    again = tseg.seg_mv_scatter_table(J, u, rows)
    walk = tseg.seg_mv_scatter_table(J, u, rows._replace(scattered=False))
    with _kernels.plain_reference():
        ref = tseg.seg_mv_scatter_table(J.double(), u.double(), rows)
    assert _kernels.launch_counts()["mv_scatter_table"] == 3
    assert names == ["viba_seg_mv_scatter_slot_major"] * 2 + ["viba_seg_mv_scatter"]
    _check((out, out), (ref, walk), (1e-5, 1e-5))
    assert torch.equal(out, again)
    if problem == "edge":
        assert float(out[7].abs().max()) == 0.0  # landmark 7 has no slot


# ---------------------------------------------------------------------------
# K2 and K6 in two launches each, against their old designs
# ---------------------------------------------------------------------------


def _two_launch_inputs(plan_kind, k, dev, seed):
    """A plan (the bias-only batch's, or the made-up one with pads, an empty
    rig and landmarks of one slot and of none), its weights and random J
    blocks of rig width k, residual and rig table."""
    if plan_kind == "bias":
        p, _, vi = _card_problem(dev)
        plan, pad = trcs.plan_of(p.datas[vi]), p.datas[vi]["_pad"].cpu().numpy()
    else:
        plan, _, pad = _edge_plans(dev)
    rng = np.random.default_rng(seed)
    n = pad.shape[0]

    def f32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    return plan, dict(J_r=f32(rng.normal(size=(2, k, n))), J_p=f32(rng.normal(size=(2, 3, n))),
                      res=f32(rng.normal(size=(2, n))), w=f32(rng.random(n) * (1.0 - pad)),
                      x=f32(rng.normal(size=(plan.n_rows, k))))


@pytest.mark.cuda
@pytest.mark.parametrize("plan_kind", ["bias", "edge"])
@pytest.mark.parametrize("k", [6, 9])
def test_assemble_rig_kernel_every_width(k, plan_kind, cuda_device, monkeypatch):
    """K2 at rig widths 6 and 9: one C entry a call, within 1e-5 of its plain
    version in float64, full symmetric H_ll0 blocks, zeros for a rig and a
    landmark without slots, the same bits every call."""
    plan, a = _two_launch_inputs(plan_kind, k, cuda_device, 191 + k)
    args = (a["J_r"], a["J_p"], a["res"], a["w"], plan)
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_assemble_rig(*args)
    again = tseg.seg_assemble_rig(*args)
    with _kernels.plain_reference():
        ref = tseg.seg_assemble_rig(*_kernels.to_f64(args))
    counts = _kernels.launch_counts()
    assert counts["assemble_rig"] == 2 and sum(counts.values()) == 2
    assert names == ["viba_assemble_rig"] * 2
    _check(out, ref, (1e-5,) * 4)
    for o, o2 in zip(out, again):
        assert torch.equal(o, o2)
    assert torch.equal(out[3], out[3].transpose(-1, -2))
    if plan_kind == "edge":
        assert float(out[0][2].abs().max()) == float(out[1][2].abs().max()) == 0.0
        assert float(out[2][7].abs().max()) == float(out[3][7].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("want_y", [True, False])
@pytest.mark.parametrize("plan_kind", ["bias", "edge"])
@pytest.mark.parametrize("k", [6, 9])
def test_schur_down_kernel_every_width(k, plan_kind, want_y, cuda_device, monkeypatch):
    """K6 at rig widths 6 and 9, with y and without (the Schur right-hand
    side): one C entry a call, within 1e-5 of its plain version in float64,
    zeros for a landmark without slots, the same bits every call."""
    plan, a = _two_launch_inputs(plan_kind, k, cuda_device, 197 + k)
    args = (a["J_r"], a["J_p"], a["w"], a["x"], plan, want_y)
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_schur_down(*args)
    again = tseg.seg_schur_down(*args)
    with _kernels.plain_reference():
        ref = tseg.seg_schur_down(*_kernels.to_f64(args))
    counts = _kernels.launch_counts()
    assert counts["schur_down"] == 2 and sum(counts.values()) == 2
    assert names == ["viba_schur_down"] * 2
    assert len(out) == 2 and (out[0] is None) == (not want_y)
    pick = (lambda o: o) if want_y else (lambda o: o[1:])  # noqa: E731
    _check(pick(out), pick(ref), (1e-5, 1e-5))
    for o, o2 in zip(pick(out), pick(again)):
        assert torch.equal(o, o2)
    if plan_kind == "edge":
        assert float(out[1][7].abs().max()) == 0.0  # landmark 7 has no slot
        if want_y:
            assert float(out[0][2].abs().max()) == 0.0  # rig 2 has no slot


# ---------------------------------------------------------------------------
# K8 in three launches, K7 one instantiation per mode
# ---------------------------------------------------------------------------


def _odd_chunks(cplan, n_rows, dev):
    """The window rows' slot lists of `cplan` cut again into chunks of 1, 0
    and 300 slots, then the rest, in `n_rows` rows (rows past the plan's
    have no slot)."""
    ptr, obs = cplan.chunk_ptr.cpu().numpy(), cplan.chunk_obs.cpu().numpy()
    rc = cplan.row_chunk.cpu().numpy()
    starts, row_chunk = [], [0]
    for r in range(n_rows):
        if r < cplan.n_rows:
            beg, end = int(ptr[rc[r]]), int(ptr[rc[r + 1]])
            cuts = [beg, min(beg + 1, end), min(beg + 1, end)]
            cuts += list(range(cuts[-1] + 300, end, 300))
            starts += cuts
        row_chunk.append(len(starts))

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    return cplan._replace(chunk_ptr=i32(starts + [len(obs)]), row_chunk=i32(row_chunk))


def _flat(outs):
    """K8's outputs with the list of split blocks expanded."""
    return [x for o in outs for x in (o if isinstance(o, list) else [o])]


def _assemble_cal_args(w, plan, cplan, k, kc, dev, seed):
    """K8's inputs: random J blocks of rig width k and window width kc, a
    random residual, the weights w."""
    n = w.shape[0]
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    return (f32(rng.normal(size=(2, k, n))), f32(rng.normal(size=(2, kc, n))),
            f32(rng.normal(size=(2, 3, n))), f32(rng.normal(size=(2, n))), w)


@pytest.mark.cuda
@pytest.mark.parametrize("plan_kind", ["full", "edge"])
@pytest.mark.parametrize("kc", [6, 17, 23])
@pytest.mark.parametrize("k", [6, 9])
def test_assemble_cal_kernel_every_width(k, kc, plan_kind, cuda_device, monkeypatch):
    """K8 on the full-sensor batch's plans, and on the made-up plan with
    chunks of 1, 0 and 300 slots and a window row without a slot, at every
    rig and window width: one C entry a call, within 1e-5 of its plain
    version in float64, the same bits every call."""
    if plan_kind == "full":
        b, _ = _cal_inputs(cuda_device)
        plan, cplan, w = b.plan, b.cplan, b.w
    else:
        plan, cplan, pad = _edge_plans(cuda_device)
        cplan = _odd_chunks(cplan, cplan.n_rows + 1, cuda_device)
        assert (np.diff(cplan.chunk_ptr.cpu().numpy())[:3] == [1, 0, 300]).all()
        rng = np.random.default_rng(139)
        w = torch.from_numpy(rng.random(pad.shape[0]) * (1.0 - pad)).to(cuda_device,
                                                                         torch.float32)
    args = _assemble_cal_args(w, plan, cplan, k, kc, cuda_device, 149 + k + kc)
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_assemble_cal(*args, plan, cplan)
    again = tseg.seg_assemble_cal(*args, plan, cplan)
    with _kernels.plain_reference():
        ref = tseg.seg_assemble_cal(*_kernels.to_f64(args), plan, cplan)
    counts = _kernels.launch_counts()
    assert counts["assemble_cal"] == 2 and sum(counts.values()) == 2
    assert names == ["viba_assemble_cal"] * 2
    out, again, ref = (_flat(o) for o in (out, again, ref))
    assert [tuple(o.shape) for o in out] == [tuple(r.shape) for r in ref]
    _check(out, ref, (1e-5,) * len(out))
    for o, o2 in zip(out, again):
        assert torch.equal(o, o2)
    for blk in out[4:-2]:  # the split blocks come out symmetric
        assert torch.equal(blk, blk.transpose(-1, -2))
    if plan_kind == "edge":
        assert all(float(o[-1].abs().max()) == 0.0 for o in out[2:-2])  # the empty window row


@pytest.mark.cuda
@pytest.mark.parametrize("with_jac,with_cal,masked", [
    (True, True, True), (True, True, False), (True, False, True), (True, False, False),
    (False, False, False)])
@pytest.mark.parametrize("camera_kind", [0, 1])
def test_rs_linearize_every_instantiation(camera_kind, with_jac, with_cal, masked, cuda_device,
                                          monkeypatch):
    """K7 in each mode against its plain version in float64 (residual 1e-4,
    Jacobians 3e-4; unmasked against the plain version with all-ones masks),
    the same bits every call."""
    p, _, vi = _full_card(cuda_device)
    data, v = p.datas[vi], p.variables
    masks = p.masks if masked else None
    ones = p.masks._replace(**{f: torch.ones_like(getattr(p.masks, f))
                               for f in p.masks._fields})
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = rs_fused.rs_linearize(camera_kind, data, v, masks, with_jac, with_cal)
    again = rs_fused.rs_linearize(camera_kind, data, v, masks, with_jac, with_cal)
    f64 = _kernels.to_f64
    with _kernels.plain_reference():
        ref = rs_fused.rs_linearize(camera_kind, f64(data), f64(v),
                                    f64(masks if masked or not with_jac else ones), with_jac,
                                    with_cal)
    assert rs_fused.rs_linearize.launches == 2 and names == ["viba_rs_linearize"] * 2
    assert len(out) == (2 + 2 * with_jac + with_cal)
    _check(out, ref, (1e-4, 0.0, 3e-4, 3e-4, 3e-4))
    for o, o2 in zip(out, again):
        assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("with_jac,masked", [(True, True), (True, False), (False, True),
                                             (False, False)])
@pytest.mark.parametrize("camera_kind", [0, 1])
def test_visual_linearize_every_instantiation(camera_kind, with_jac, masked, cuda_device,
                                              monkeypatch):
    """K1 in each instantiation (camera model x Jacobian; masks passed or
    not: the residual-only mode reads none) against its plain version in
    float64 (residual 1e-5, Jacobians 2e-4), one launch of its C entry a
    call, J_r's columns 6-11 exactly zero, the same bits every call."""
    p, _, vi = _card_problem(cuda_device)
    data, v = p.datas[vi], p.variables
    masks = p.masks if masked else None
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = visual_fused.visual_linearize(camera_kind, data, v, masks, with_jac)
    again = visual_fused.visual_linearize(camera_kind, data, v, masks, with_jac)
    counts = _kernels.launch_counts()
    assert counts["visual_linearize"] == 2 and sum(counts.values()) == 2
    f64 = _kernels.to_f64
    with _kernels.plain_reference():
        ref = visual_fused.visual_linearize(camera_kind, f64(data), f64(v),
                                            f64(masks if with_jac else None), with_jac)
    assert names == ["viba_visual_linearize"] * 2
    assert len(out) == 2 + 2 * with_jac
    _check(out, ref, (1e-5, 0.0, 2e-4, 2e-4))
    for o, o2 in zip(out, again):
        assert torch.equal(o, o2)
    if with_jac:
        assert float(out[3][:, 6:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("camera_kind", [0, 1])
def test_visual_cal_linearize_every_instantiation(camera_kind, masked, cuda_device, monkeypatch):
    """K11 in each instantiation (camera model; masked or not) against its
    plain version in float64 (residual 1e-5, Jacobians 3e-4), one launch of
    its C entry a call, J_r's columns 6-11,
    J_cal's readout and time-offset columns (and a pinhole's model columns
    4-14) exactly zero, the same bits every call."""
    p, _, vi = _gs_card(cuda_device)
    data, v = p.datas[vi], p.variables
    masks = p.masks if masked else None
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = visual_fused.visual_cal_linearize(camera_kind, data, v, masks)
    again = visual_fused.visual_cal_linearize(camera_kind, data, v, masks)
    counts = _kernels.launch_counts()
    assert counts["visual_cal_linearize"] == 2 and sum(counts.values()) == 2
    f64 = _kernels.to_f64
    with _kernels.plain_reference():
        ref = visual_fused.visual_cal_linearize(camera_kind, f64(data), f64(v), f64(masks))
    assert names == ["viba_visual_cal_linearize"] * 2
    _check(out, ref, (1e-5, 0.0, 3e-4, 3e-4, 3e-4))
    for o, o2 in zip(out, again):
        assert torch.equal(o, o2)
    assert float(out[3][:, 6:].abs().max()) == 0.0
    assert float(out[4][:, 21:].abs().max()) == 0.0
    if camera_kind == 0:
        assert float(out[4][:, 10:21].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K4 and K9 keep their bits while K6 shares their landmark pass
# ---------------------------------------------------------------------------

# sha256 (first 16 hex digits) of K4's and K9's outputs on the fixed inputs of
# _pcg_digests, as the kernels gave them before point_range_sum
# (csrc/pt_segments.cuh) also took K6's landmark sums without a 3x3 solve, on
# an NVIDIA H100 80GB HBM3
PCG_DIGESTS = {"K4 bias k6": "3465139199dea47d", "K4 bias k9": "10ac810f84bb22a3",
               "K4 edge k6": "5353072a6306658a", "K4 edge k9": "7a449354957f5bfd",
               "K9 edge k6 kc17": "e94f1c746249c4ef 441161003e3c6538",
               "K9 edge k9 kc23": "4caca05ba2455b96 129d4da4f22a4eb5"}


def _pcg_digests(dev):
    """K4 at rig widths 6 and 9 on the bias-only batch's plan and on the
    made-up plan, K9 at (6, 17) and (9, 23) on the made-up plan, with random
    J blocks, weights and tables from a numpy seed: the digest of each
    output's bytes."""
    import hashlib

    def digest(x):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]

    p, _, vi = _card_problem(dev)
    data = p.datas[vi]
    edge, cplan, pad_e = _edge_plans(dev)
    out = {}
    for name, plan, pad in (("bias", trcs.plan_of(data), data["_pad"].cpu().numpy()),
                            ("edge", edge, pad_e)):
        w = torch.from_numpy(np.random.default_rng(163).random(pad.shape[0]) * (1.0 - pad)).to(
            dev, torch.float32)
        for k in (6, 9):
            y = tseg.seg_schur_pcg(*_schur_pcg_args(w, plan, k, dev, 167 + k), plan)
            out[f"K4 {name} k{k}"] = digest(y)
        if name == "edge":
            for k, kc in ((6, 17), (9, 23)):
                y_r, y_c = tseg.seg_schur_pcg_cal(
                    *_pcg_cal_args(w, plan, cplan, k, kc, dev, 173 + k + kc), plan, cplan)
                out[f"K9 {name} k{k} kc{kc}"] = digest(y_r) + " " + digest(y_c)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_schur_pcg_bits_unchanged(cuda_device):
    """K4 and K9 give the same bits as before K6 shared their landmark pass."""
    assert _pcg_digests(cuda_device) == PCG_DIGESTS


# ---------------------------------------------------------------------------
# K4 and K9 on C right-hand sides (the covariance columns)
# ---------------------------------------------------------------------------

# one column; a tile of the tiled design; a ragged tile of 32 columns; the
# full-sensor covariance chunk (two tiles, the second half used); the chunk
COLS = (1, 8, 37, 48, 256)


def _cols(shape, C, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape + (C,))).to(device=dev, dtype=torch.float32)


def _edge_w(pad, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(pad.shape[0]) * (1.0 - pad)).to(dev, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("C", COLS)
@pytest.mark.parametrize("plan_kind", ["bias", "edge"])
@pytest.mark.parametrize("k", [6, 9])
def test_schur_pcg_cols_kernel(k, plan_kind, C, cuda_device, monkeypatch):
    """Column K4 on the bias-only plan and on the made-up plan at rig widths
    6 and 9 and 1, 8, 37, 48 and 256 columns, over records made once: one C
    entry a call, within 1e-5 of its plain version in float64 and of the
    single-column K4 on every column, the same bits every call and without
    the records handed in."""
    if plan_kind == "bias":
        plan, a = _segment_inputs(cuda_device)
        w = a["w"]
    else:
        plan, _, pad = _edge_plans(cuda_device)
        w = _edge_w(pad, cuda_device, 149)
    J_r, J_p, _, _, hinv = _schur_pcg_args(w, plan, k, cuda_device, 151 + k)
    x = _cols((plan.n_rows, k), C, cuda_device, 157 + C)
    rec = tseg.point_sorted_records(J_r, J_p, w, plan)
    names = _recording_launches(monkeypatch)
    _kernels.reset_launch_counts()
    out = tseg.seg_schur_pcg_cols(J_r, J_p, w, x, hinv, plan, rec)
    again = tseg.seg_schur_pcg_cols(J_r, J_p, w, x, hinv, plan)
    with _kernels.plain_reference():
        ref = tseg.seg_schur_pcg_cols(*_kernels.to_f64((J_r, J_p, w, x, hinv)), plan)
    counts = _kernels.launch_counts()
    assert counts["schur_pcg_cols"] == 2 and sum(counts.values()) == 2
    assert names == ["viba_schur_pcg_cols"] * 2
    assert out.shape == x.shape
    single = torch.stack([tseg.seg_schur_pcg(J_r, J_p, w, x[..., c].contiguous(), hinv, plan)
                          for c in range(C)], dim=-1)
    _check((out, out), (ref, single), (1e-5, 1e-5))
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("C", COLS)
@pytest.mark.parametrize("kc", [6, 17, 23])
@pytest.mark.parametrize("k", [6, 9])
def test_schur_pcg_cal_cols_kernel(k, kc, C, cuda_device, monkeypatch):
    """Column K9 on the full-sensor batch's plans at every rig and window
    width and 1, 8, 37, 48 and 256 columns (and on the made-up plan, rigs on
    three window rows, at k 9, kc 23), over records made once: one C entry a
    call, within 1e-5 of its plain version in float64 and of the
    single-column K9 on every column, the same bits every call and without
    the records handed in."""
    b, _ = _cal_inputs(cuda_device)
    plans = [(b.w, b.plan, b.cplan)]
    if (k, kc) == (9, 23) and C in (8, 48):
        plan, cplan, pad = _edge_plans(cuda_device)
        plans.append((_edge_w(pad, cuda_device, 163), plan, cplan))
    for w, plan, cplan in plans:
        J_r, J_c, J_p, _, _, _, hinv = _pcg_cal_args(w, plan, cplan, k, kc, cuda_device,
                                                     167 + k + kc)
        x_r = _cols((plan.n_rows, k), C, cuda_device, 173 + C)
        x_c = _cols((cplan.n_rows, kc), C, cuda_device, 179 + C)
        args = (J_r, J_c, J_p, w, x_r, x_c, hinv)
        rec = tseg.point_sorted_records(J_r, J_p, w, plan, J_c, cplan)
        names = _recording_launches(monkeypatch)
        _kernels.reset_launch_counts()
        out = tseg.seg_schur_pcg_cal_cols(*args, plan, cplan, rec)
        again = tseg.seg_schur_pcg_cal_cols(*args, plan, cplan)
        with _kernels.plain_reference():
            ref = tseg.seg_schur_pcg_cal_cols(*_kernels.to_f64(args), plan, cplan)
        counts = _kernels.launch_counts()
        assert counts["schur_pcg_cal_cols"] == 2 and sum(counts.values()) == 2
        assert names == ["viba_schur_pcg_cal_cols"] * 2
        singles = [tseg.seg_schur_pcg_cal(J_r, J_c, J_p, w, x_r[..., c].contiguous(),
                                          x_c[..., c].contiguous(), hinv, plan, cplan)
                   for c in range(C)]
        single = tuple(torch.stack(s, dim=-1) for s in zip(*singles))
        _check(out + out, ref + single, (1e-5,) * 4)
        for o, o2 in zip(out, again):
            assert torch.equal(o, o2)


def _long_plans(dev, pair_slots):
    """Plans of a made-up batch whose rig 1 holds `pair_slots` slots on one
    window row (many chunks of the fused column kernels' rig-pass tiles:
    96 to 512 entries) and whose landmark 0 holds 3,000 slots, beside short
    rigs and landmarks; tiles of 1,000 slots, the last 10 of each pads."""
    rng = np.random.default_rng(227)
    R, L, n_c = 4, 50, 2
    n_real = pair_slots + 1500
    n_tiles = -(-n_real // 990)
    n = 1000 * n_tiles
    pad = np.zeros(n)
    pad.reshape(n_tiles, 1000)[:, 990:] = 1.0
    real = np.nonzero(pad < 0.5)[0]
    rig = np.zeros(n, np.int64)
    rig_real = np.concatenate([np.zeros(500, np.int64), np.ones(pair_slots, np.int64),
                               rng.integers(2, R, size=len(real) - 500 - pair_slots)])
    rig[real] = np.sort(rig_real)
    rig[pad > 0.5] = np.maximum.accumulate(rig)[pad > 0.5]
    point = rng.integers(1, L, size=n)
    point[real[rng.permutation(len(real))[:3000]]] = 0
    win = np.where(rig == 1, 1, rng.integers(0, n_c, size=n))
    arrays = trcs.segment_plan(rig, point, pad, R, L)
    cal = {**tseg.cal_plan_arrays(win, pad, n_c), **tseg.pair_plan_arrays(rig, win, pad, R, n_c)}

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    plan = tseg.SegPlan(i32(rig), i32(point), *(i32(arrays[k]) for k in (
        "_rig_ptr", "_rig_obs", "_pt_ptr", "_pt_obs", "_pt_pos")))
    cplan = tseg.CalPlan(i32(win), *(i32(cal["_cal_" + f]) for f in tseg.CalPlan._fields[1:]))
    assert np.diff(cal["_cal_pair_ptr"]).max() == pair_slots
    assert np.diff(arrays["_pt_ptr"])[0] == 3000
    return plan, cplan, pad


@pytest.mark.cuda
@pytest.mark.parametrize("pair_slots", [3000, 9000])
@pytest.mark.parametrize("C", [1, 8, 48])
def test_cols_long_rows(C, pair_slots, cuda_device):
    """A rig row of 3,000 or 9,000 slots on one window row (many chunks of
    the rig passes' shared-memory tiles, a lane class's slots split across
    them) and a landmark of 3,000 slots: the fused column K9 and K4 within
    1e-5 of the single-column kernels on every column, the same bits every
    call."""
    plan, cplan, pad = _long_plans(cuda_device, pair_slots)
    w = _edge_w(pad, cuda_device, 229)
    J_r, J_c, J_p, _, _, _, hinv = _pcg_cal_args(w, plan, cplan, 9, 23, cuda_device, 233)
    x_r = _cols((plan.n_rows, 9), C, cuda_device, 239)
    x_c = _cols((cplan.n_rows, 23), C, cuda_device, 241)
    args9 = (J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan)
    out = tseg.seg_schur_pcg_cal_cols(*args9)
    y4 = tseg.seg_schur_pcg_cols(J_r, J_p, w, x_r, hinv, plan)
    for o, o2 in zip(out + (y4,), tseg.seg_schur_pcg_cal_cols(*args9)
                     + (tseg.seg_schur_pcg_cols(J_r, J_p, w, x_r, hinv, plan),)):
        assert torch.equal(o, o2)
    for c in range(C):
        one = tseg.seg_schur_pcg_cal(J_r, J_c, J_p, w, x_r[..., c].contiguous(),
                                     x_c[..., c].contiguous(), hinv, plan, cplan)
        _check((out[0][..., c], out[1][..., c]), one, (1e-5, 1e-5))
        _check((y4[..., c],), (tseg.seg_schur_pcg(J_r, J_p, w, x_r[..., c].contiguous(), hinv,
                                                   plan),), (1e-5,))


# ---------------------------------------------------------------------------
# multi-session: the tiny rolling- and global-shutter recordings merged
# (chip_smoke's multi path at the tiny size): K10 in the two-pass PCG
# ---------------------------------------------------------------------------


def _on_cpu_f64(p):
    """A float64 CPU copy of a problem (the original untouched)."""
    q = topt.Problem(p.variables, p.masks)
    q.cfgs, q.datas = list(p.cfgs), list(p.datas)
    return q.to("cpu", torch.float64)


@pytest.mark.cuda
def test_merge_on_card_equals_the_cpu_merge(cuda_device):
    """merge_sessions of the card problems (float32) against the same merge
    of their float64 CPU copies: every table and index array exact (the
    float32 values), the merged landmarks within 1e-6 (both average on the
    host in float64; the card's result is rounded to float32)."""
    problems, matches, (cfg, bm), _ = port_merge_inputs(cuda_device, torch.float32)
    card = tms.merge_sessions(problems, point_matches=matches, extra_batches=[(cfg, bm)])
    cpu = tms.merge_sessions(
        [_on_cpu_f64(p) for p in problems], point_matches=matches, extra_batches=[(cfg, {
            k: a.to("cpu", torch.float64) if a.is_floating_point() else a.cpu()
            for k, a in bm.items()})])
    pc, pp = card.problem, cpu.problem
    assert len(matches) == pp.variables.points.shape[0]
    np.testing.assert_array_equal(card.point_map, cpu.point_map)
    assert card.rig_offset == cpu.rig_offset and card.point_offset == cpu.point_offset
    for tables in ("variables", "masks"):
        for f in getattr(pp, tables)._fields:
            a, b = getattr(getattr(pc, tables), f), getattr(getattr(pp, tables), f)
            assert a.device.type == "cuda" and a.dtype == torch.float32, (tables, f)
            if (tables, f) == ("variables", "points"):
                assert rel(a.cpu().double().numpy(), b.numpy()) <= 1e-6
            else:
                assert torch.equal(a.cpu(), b.float()), (tables, f)
    assert [c.kind for c in pc.cfgs] == [c.kind for c in pp.cfgs]
    for c, dc, dp in zip(pc.cfgs, pc.datas, pp.datas):
        assert set(dc) == set(dp), c.kind
        for k, a in dp.items():
            if isinstance(a, torch.Tensor):
                b = dc[k].cpu()
                assert torch.equal(b, a.float() if a.is_floating_point() else a), (c.kind, k)


@pytest.mark.cuda
def test_merged_two_pass_attempt_kernels_match_plain(cuda_device):
    """The merged problem with its base map, blocked with ts = 64 (both
    batches calibration-coupled single-pass, so the PCG takes the two-pass
    route): one LM attempt through the kernels twice, bit-equal, with K10's
    down and up launched 2 x 40 times in the PCG and K9 never, and within
    1e-3 of the plain versions' attempt in new cost and |step|."""
    import chip_smoke

    problems, matches, bm, _ = port_merge_inputs(cuda_device, torch.float32)
    p = tms.merge_sessions(problems, point_matches=matches, extra_batches=[bm]).problem
    trcs.finalize_blocks(p, ts=64)
    settings = chip_smoke.lm_settings()
    _kernels.reset_launch_counts()
    one = chip_smoke.lm_iteration(p, settings)
    counts = _kernels.launch_counts()
    two = chip_smoke.lm_iteration(p, settings)
    with _kernels.plain_reference():
        ref = chip_smoke.lm_iteration(p, settings)
    assert sum(c.block_info is not None for c in p.cfgs) == 2
    assert counts["schur_pcg_cal"] == 0 and counts["schur_pcg"] == 0
    # per batch: 40 PCG matvecs, and the right-hand side (up) or the
    # back-substitution (down, t alone)
    assert counts["schur_down_cal"] == counts["schur_up_cal"] == 2 * (40 + 1)
    assert counts["rs_linearize"] and counts["visual_cal_linearize"]
    assert one[0] == two[0] and one[1] == two[1] and torch.equal(one[4], two[4])
    assert all(torch.equal(a, b) for a, b in zip(one[3], two[3]))
    assert math.isfinite(one[0])
    assert abs(one[0] - ref[0]) <= 1e-3 * abs(ref[0])
    assert abs(one[1] - ref[1]) <= 1e-3 * abs(ref[1])


# ---------------------------------------------------------------------------
# K10 on the rig-pair plans, K5 batched: every calibration-coupled plan
# ---------------------------------------------------------------------------

# device operations a call at most: K10's down pass with y and with t
# alone, its up pass, K5
K10_K5_OPS = {"down": 3, "down_t": 2, "up": 2, "k5": 1}
K10_K5_ENTRIES = {"down": ("schur_down_cal", "viba_schur_down_cal"),
                  "down_t": ("schur_down_cal", "viba_schur_down_cal"),
                  "up": ("schur_up_cal", "viba_schur_up_cal"), "k5": ("schur_up", "viba_schur_up")}


def _spanning(cplan, plan, dev):
    """cplan with a third of the batch's real slots moved to the next window
    row, its chunk and pair plans built again: rigs span two window rows."""
    n_c = cplan.n_rows
    rig, win = plan.rig.cpu().numpy(), cplan.win.cpu().numpy().copy()
    pad = np.ones(rig.shape[0])
    pad[plan.pt_obs.cpu().numpy()] = 0.0
    moved = np.nonzero(pad < 0.5)[0][::3]
    win[moved] = (win[moved] + 1) % n_c
    cal = {**tseg.cal_plan_arrays(win, pad, n_c),
           **tseg.pair_plan_arrays(rig, win, pad, plan.n_rows, n_c)}
    assert np.diff(cal["_cal_rig_pair"]).max() > 1

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    return tseg.CalPlan(i32(win), *(i32(cal["_cal_" + f]) for f in tseg.CalPlan._fields[1:]))


def _cal_plans(kind, dev):
    """[(w, plan, cplan, k, kc)] of the blocked calibration-coupled batches
    of the full-sensor problem, the global-shutter one, or the merged
    recordings with their base map (blocked with ts = 64), the last with
    rigs spanning two window rows."""
    if kind == "merged":
        problems, matches, bm, _ = port_merge_inputs(dev, torch.float32)
        p = tms.merge_sessions(problems, point_matches=matches, extra_batches=[bm]).problem
        trcs.finalize_blocks(p, ts=64)
    else:
        p = (port_full_built if kind == "full" else port_gs_built)(device=dev,
                                                                  dtype=torch.float32)[0]
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    out = []
    for b, _ in trcs._vis_batches(p.active_cfgs, datas, lg):
        assert trcs._cal_fast(b)
        cplan = _spanning(b.cplan, b.plan, dev) if kind == "merged" else b.cplan
        out.append((b.w, b.plan, cplan, b.rig_k, b.J_cal.shape[1]))
    assert len(out) == (2 if kind == "merged" else 1)
    return out


def _k10_k5(which, J_r, J_c, J_p, w, x_r, x_c, z, plan, cplan):
    if which == "k5":
        return (tseg.seg_schur_up(J_r, J_p, w, z, plan),)
    if which == "up":
        return tseg.seg_schur_up_cal(J_r, J_c, J_p, w, z, plan, cplan)
    return tseg.seg_schur_down_cal(J_r, J_c, J_p, w, x_r, x_c, plan, cplan, which == "down")


def _device_ops(fn):
    """Device operations a call of fn (torch.profiler, two sessions)."""
    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm

    return pm.in_turns([fn])[0][1]


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(K10_K5_OPS))
@pytest.mark.parametrize("plan_kind", ["full", "gs_cal", "merged"])
def test_k10_k5_kernels_every_plan(plan_kind, which, cuda_device, monkeypatch):
    """K10's down pass (with y, "down"; t alone, "down_t"), its up pass and
    K5 on the full-sensor, global-shutter and merged batches' plans: one C
    entry a call, within 1e-5 of the plain version in float64, the same
    bits every call, at most K10_K5_OPS device operations a call."""
    wrapper, entry = K10_K5_ENTRIES[which]
    names = _recording_launches(monkeypatch)
    for w, plan, cplan, k, kc in _cal_plans(plan_kind, cuda_device):
        J_r, J_c, J_p, _, x_r, x_c, _ = _pcg_cal_args(w, plan, cplan, k, kc, cuda_device,
                                                      257 + k + kc)
        z = _cols((plan.n_pts,), 3, cuda_device, 263)
        args = (J_r, J_c, J_p, w, x_r, x_c, z, plan, cplan)
        names.clear()
        _kernels.reset_launch_counts()
        out = [o for o in _k10_k5(which, *args) if o is not None]
        again = [o for o in _k10_k5(which, *args) if o is not None]
        with _kernels.plain_reference():
            ref = [o for o in _k10_k5(which, *_kernels.to_f64(args)) if o is not None]
        counts = _kernels.launch_counts()
        assert counts[wrapper] == 2 and sum(counts.values()) == 2
        assert names == [entry] * 2
        assert len(out) == len(ref) == {"down": 3, "down_t": 1, "up": 2, "k5": 1}[which]
        _check(out, ref, (1e-5,) * len(out))
        for o, o2 in zip(out, again):
            assert torch.equal(o, o2)
        assert _device_ops(lambda: _k10_k5(which, *args)) <= K10_K5_OPS[which]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 9])
def test_schur_up_kernel_edge_plan(k, cuda_device, monkeypatch):
    """K5 on the made-up plan (pads, an empty rig, landmarks of one slot and
    of none) at rig widths 6 and 9: within 1e-5 of its plain version in
    float64, zeros for the rig without slots, the same bits every call."""
    plan, _, pad = _edge_plans(cuda_device)
    w = _edge_w(pad, cuda_device, 269)
    J_r, J_p, _, _, _ = _schur_pcg_args(w, plan, k, cuda_device, 271 + k)
    z = _cols((plan.n_pts,), 3, cuda_device, 277)
    out = tseg.seg_schur_up(J_r, J_p, w, z, plan)
    again = tseg.seg_schur_up(J_r, J_p, w, z, plan)
    with _kernels.plain_reference():
        ref = tseg.seg_schur_up(*_kernels.to_f64((J_r, J_p, w, z)), plan)
    _check((out,), (ref,), (1e-5,))
    assert torch.equal(out, again) and float(out[2].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# bf16 Jacobians (rcs.MATVEC_BF16): the eight kernels of the PCG loop
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def _rig_bf16_call(name, J_r, J_p, w, x, z, hinv, plan):
    """K3-K6 (K6 with y, "schur_down"; t alone, "schur_down_t") on one set
    of inputs, as a tuple of outputs."""
    if name == "precond_rig":
        return (tseg.seg_precond_rig(J_r, J_p, w, hinv, plan),)
    if name in ("schur_down", "schur_down_t"):
        return tseg.seg_schur_down(J_r, J_p, w, x, plan, name == "schur_down")
    if name == "schur_up":
        return (tseg.seg_schur_up(J_r, J_p, w, z, plan),)
    return (tseg.seg_schur_pcg(J_r, J_p, w, x, hinv, plan),)


def _cal_bf16_call(name, J_r, J_c, J_p, w, x_r, x_c, z, hinv, plan, cplan):
    """K9 and K10 (down with y, "schur_down_cal"; t alone, "schur_down_cal_t";
    up) on one set of inputs, as a tuple of outputs."""
    if name == "schur_pcg_cal":
        return tseg.seg_schur_pcg_cal(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan)
    if name == "schur_up_cal":
        return tseg.seg_schur_up_cal(J_r, J_c, J_p, w, z, plan, cplan)
    return tseg.seg_schur_down_cal(J_r, J_c, J_p, w, x_r, x_c, plan, cplan,
                                   name == "schur_down_cal")


def _bf16_against_plain_and_f32(call, wrapper, J, rest):
    """call(*J, *rest) with the Jacobians J rounded to bf16: one launch of
    the bf16 instantiation, within 1e-5 of the plain version evaluated in
    float64 on the same bf16 values, the same bits every call, and the
    bits of the float32 instantiation on those values upcast."""
    Jb = tuple(a.to(BF16) for a in J)
    _kernels.reset_launch_counts()
    out = [o for o in call(*Jb, *rest) if o is not None]
    assert _kernels.launch_counts(bf16=True)[wrapper] == 1
    again = [o for o in call(*Jb, *rest) if o is not None]
    f32 = [o for o in call(*(a.float() for a in Jb), *rest) if o is not None]
    counts = _kernels.launch_counts()
    assert counts[wrapper] == 3 and sum(counts.values()) == 3
    assert _kernels.launch_counts(bf16=True)[wrapper] == 2
    with _kernels.plain_reference():
        ref = [o for o in call(*_kernels.to_f64(Jb), *_kernels.to_f64(rest)) if o is not None]
    assert len(out) == len(ref) == len(f32)
    _check(out, ref, (1e-5,) * len(out))
    for o, o2, o3 in zip(out, again, f32):
        assert torch.equal(o, o2) and torch.equal(o, o3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["precond_rig", "schur_down", "schur_down_t", "schur_up",
                                  "schur_pcg"])
@pytest.mark.parametrize("k", [6, 9])
def test_rig_kernels_bf16(name, k, cuda_device):
    """K3, K6 (pcg_down, schur_down_rows), K5 (schur_up_rows) and K4
    (pcg_down, pcg_up) on bf16 J on the bias-only batch's plan at rig widths
    6 and 9: against the plain version on the bf16 values and, bit for bit,
    the float32 instantiation on them upcast."""
    plan, a = _segment_inputs(cuda_device)
    J_r, J_p, w, x, hinv = _schur_pcg_args(a["w"], plan, k, cuda_device, 281 + k)
    wrapper = "schur_down" if name == "schur_down_t" else name
    _bf16_against_plain_and_f32(lambda Jr, Jp, *r: _rig_bf16_call(name, Jr, Jp, *r), wrapper,
                                (J_r, J_p), (w, x, a["z"], hinv, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["schur_pcg_cal", "schur_down_cal", "schur_down_cal_t",
                                  "schur_up_cal"])
@pytest.mark.parametrize("kc", [6, 17, 23])
@pytest.mark.parametrize("k", [6, 9])
def test_cal_kernels_bf16(name, k, kc, cuda_device):
    """K9 (pcg_cal_down, pcg_cal_up) and K10 (cal_pair_pass down with y and
    up; pcg_cal_down for t alone) on bf16 J on the full-sensor batch's plans
    at every rig and window width: against the plain version on the bf16
    values and, bit for bit, the float32 instantiation on them upcast."""
    b, _ = _cal_inputs(cuda_device)
    J_r, J_c, J_p, w, x_r, x_c, hinv = _pcg_cal_args(b.w, b.plan, b.cplan, k, kc, cuda_device,
                                                     283 + k + kc)
    z = _cols((b.plan.n_pts,), 3, cuda_device, 293)
    wrapper = "schur_down_cal" if name == "schur_down_cal_t" else name
    _bf16_against_plain_and_f32(lambda Jr, Jc, Jp, *r: _cal_bf16_call(name, Jr, Jc, Jp, *r),
                                wrapper, (J_r, J_c, J_p),
                                (w, x_r, x_c, z, hinv, b.plan, b.cplan))


@pytest.mark.cuda
def test_bf16_wrappers_refuse_mixed_jacobians(cuda_device):
    """One J type a call: bf16 J_r with float32 J_p (or J_c) is refused
    before any launch, and assembly (K2, K8) takes float32 J only."""
    b, a = _cal_inputs(cuda_device)
    _kernels.reset_launch_counts()
    with pytest.raises(ValueError):
        tseg.seg_schur_pcg_cal(b.J.to(BF16), b.J_cal, b.J_pt.to(BF16), b.w, a["x"], a["x_c"],
                               a["hinv"], b.plan, b.cplan)
    with pytest.raises(ValueError):
        tseg.seg_precond_rig(b.J.to(BF16), b.J_pt, b.w, a["hinv"], b.plan)
    with pytest.raises(ValueError):
        tseg.seg_assemble_cal(b.J.to(BF16), b.J_cal.to(BF16), b.J_pt.to(BF16), a["res"], b.w,
                              b.plan, b.cplan)
    assert sum(_kernels.launch_counts().values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["bias", "full_sensor"])
def test_flagged_lm_attempt_runs_bf16_kernels(problem, cuda_device, monkeypatch):
    """One LM attempt with rcs.MATVEC_BF16 on: K3, K4 / K9 and K5 / K10's up
    pass launch their bf16 instantiations (the back-substitution its float32
    one), the attempt repeats bit for bit, and it agrees with the same
    attempt through the plain versions within 1e-3 in new cost and |step|."""
    monkeypatch.setattr(trcs, "MATVEC_BF16", True)
    make = _card_problem if problem == "bias" else _full_card
    _kernels.reset_launch_counts()
    cost, x_r, x_l = _attempt(make(cuda_device)[0])
    bf16 = _kernels.launch_counts(bf16=True)
    counts = _kernels.launch_counts()
    cost2, x_r2, x_l2 = _attempt(make(cuda_device)[0])
    with _kernels.plain_reference():
        cost_p, x_r_p, x_l_p = _attempt(make(cuda_device)[0])
    mv = (("precond_rig", "schur_pcg", "schur_up") if problem == "bias"
          else ("precond_rig", "schur_pcg_cal", "schur_up_cal"))
    assert all(bf16[k] > 0 for k in mv), bf16
    back = "schur_down" if problem == "bias" else "schur_down_cal"
    assert counts[back] > 0 and bf16[back] == 0
    assert float(cost) == float(cost2) and torch.equal(x_l, x_l2)
    assert all(torch.equal(a, c) for a, c in zip(x_r, x_r2))
    step = lambda xr, xl: float(torch.sqrt(tst.t_dot(xr, xr) + (xl * xl).sum()))  # noqa: E731
    assert abs(float(cost) - float(cost_p)) <= 1e-3 * abs(float(cost_p))
    assert abs(step(x_r, x_l) - step(x_r_p, x_l_p)) <= 1e-3 * step(x_r_p, x_l_p)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bias", "full_sensor"])
def test_column_kernels_on_the_copies_match_bf16_single_column(route, cuda_device,
                                                              monkeypatch):
    """With the flag on, the point-sorted records of a system hold the bf16
    copies upcast (rcs.with_column_records), so the column K4 / K9 at 8
    columns give, column by column, the bits of the single-column bf16
    kernel."""
    monkeypatch.setattr(trcs, "MATVEC_BF16", True)
    p = (_card_problem if route == "bias" else _full_card)(cuda_device)[0]
    ks = p._build()
    datas, v = tuple(p.datas), p.variables
    lg = ks[0](datas, v, p.masks, None)
    rs = trcs.with_column_records(trcs.with_damping(ks[6](datas, lg, v, p.masks), v, p.masks,
                                                    1e-4))
    (b,) = rs.vis
    assert b.J_mv.dtype == BF16 and b.rec is not None
    C = 8
    x_r = _cols((v.pose_q.shape[0], b.rig_k), C, cuda_device, 307)
    if route == "bias":
        out = (tseg.seg_schur_pcg_cols(b.J_mv, b.J_pt_mv, b.w, x_r, rs.H_ll_inv, b.plan, b.rec),)
        single = [(tseg.seg_schur_pcg(b.J_mv, b.J_pt_mv, b.w, x_r[..., c].contiguous(),
                                      rs.H_ll_inv, b.plan),) for c in range(C)]
    else:
        x_c = _cols((b.cplan.n_rows, b.J_cal.shape[1]), C, cuda_device, 311)
        out = tseg.seg_schur_pcg_cal_cols(b.J_mv, b.J_cal_mv, b.J_pt_mv, b.w, x_r, x_c,
                                          rs.H_ll_inv, b.plan, b.cplan, b.rec)
        single = [tseg.seg_schur_pcg_cal(b.J_mv, b.J_cal_mv, b.J_pt_mv, b.w,
                                         x_r[..., c].contiguous(), x_c[..., c].contiguous(),
                                         rs.H_ll_inv, b.plan, b.cplan) for c in range(C)]
    for c in range(C):
        assert all(torch.equal(o[..., c], s) for o, s in zip(out, single[c])), c
