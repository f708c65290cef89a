"""The plans and the data flow of the redesigned K2, K3, K4, K5, K6, K8, K9,
K10, K13a and K13c, on the CPU.

K4 (the bias-only PCG matvec) and K9 (the calibration PCG matvec) go on the
card through each slot's point-sorted position `_pt_pos`
(rcs.segment_plan), K9's up pass also through the (rig, window row) pairs
of segments.pair_plan_arrays; K13a and K13c on landmark rows (a scattered
family) through a slot-major copy of J^T u and of their input. The CUDA
kernels run only on the card (tests/test_torch_kernels_cuda.py holds them
against their plain versions); here:

  * `_pt_pos` inverts `_pt_obs` with -1 on the pads, as the port's own
    finalize_blocks builds it (the tiny bias-only problem, its two-grid
    blocking, the tiny full-sensor one) and as interop.problem_from_numpy
    rebuilds it;
  * the pair plan lists every real slot once, in rig order, a pair's slots
    of one rig and one window row, each window row's partials in rig order
    (also where a rig spans two window rows);
  * the kernels' data flow, written below as torch ops (K9: p written at
    the point-sorted positions, contiguous segment sums, the 3x3 solve
    applied to the landmark sums, wu recomputed in the up pass, one window
    partial per pair summed in pair order; K13c: the slot-major copy, each
    row's slots gathered in list order), equals the JAX entries on their XLA
    branches in float64 within 1e-9 relative to max-abs:
    seg_reduce_table over the landmark rows of the two-grid problem at D 3
    and 9, and seg_schur_pcg_cal on the full-sensor batch at window widths
    kc 6, 17 and 23, with random J, weights and tables from a numpy seed and
    a third of the slots moved to the other window row, so that rigs span
    two; K4's (p at the point-sorted positions, contiguous sums, the 3x3
    solve, w J_r x recomputed in the up pass, each rig's contiguous run
    summed) equals seg_schur_pcg on the bias-only batch at rig widths 6 and
    9, with two rigs and two landmarks left without slots; K13a's on the
    landmark rows (J^T u copied slot-major, each row's slots gathered in
    list order) equals seg_mv_scatter_table on the two-grid problem's
    point-sorted grid;
  * on CPU tensors the K4 and K13a wrappers take their plain versions and
    count no launch;
  * profile_matvec.per_call, which turns the profiler's records into device
    time per call, counts a launch the profiler missed;
  * K8's window flow (cal_assemble.cu: a chunk's slots in 128-slot steps,
    the outputs cut into 3x3 items each owned by one warp, a lane's 4 slots
    of each step summed in order, the warp's butterfly, the chunks' partial
    rows summed in chunk order into g_c, diag_c and the full split blocks)
    equals the JAX
    package's seg_assemble_cal on its XLA branch at kc 6, 17 and 23 (chunks
    of 1,024 and of 300 slots) within 1e-9;
  * the full blocks that K2, K3 and K8's sum pass write from their upper
    triangles (the index arithmetic of each kernel, written out) equal
    segments._tri_to_full at k 3, 6, 9 and 17;
  * K2's flow (the rig rows' 128-thread group sums; each slot's sqrt(w) J_p
    and sqrt(w) res written as one sector at its point-sorted position, a
    16-lane group per landmark summing its range in lane-stride order with
    its butterfly) equals seg_assemble_rig, and K6's (p at the point-sorted positions, the
    16-thread groups' range sums without the 3x3 solve; with y, the rig
    rows' group sums) equals seg_schur_down, both JAX entries on their XLA
    branches in float64 within 1e-10, on the bias-only batch at rig widths
    6 and 9 with two rigs and two landmarks left without slots;
  * K10's (the down pass with y and with t alone, the up pass: wu in
    registers, p at the point-sorted positions and the 16-lane landmark
    sums; the rig-pair pass's y_r in the order of a rig row's 128-thread
    group across its pairs, one window partial per pair, each window row's
    partials summed in rig order) equals seg_schur_down_cal / seg_schur_up_cal on the
    full-sensor batch at kc 6, 17 and 23 with rigs spanning both window
    rows, and K5's (each rig row's 128-thread group sums) equals
    seg_schur_up on the bias-only batch at rig widths 6 and 9 with two
    rigs and two landmarks left without slots, in float64 within 1e-9;
  * K3's (precond_rig.cu: per slot A = w J_r^T J_p and the triangle of
    w J_r J_r^T - A H A^T, each rig row's slot range walked by a warp,
    pads included, the butterfly's sums, each entry written at tri_entry
    and its mirror) equals seg_precond_rig on the bias-only batch at rig
    widths 6 and 9 with a symmetric positive-definite H_ll^-1 table, in
    float64 within 1e-9; its reduce-scatter tail leaves each entry of the
    triangle with one lane and the butterfly's float32 bits; on the port's
    bias-only and full-sensor batches each rig row's slot range holds only
    the row's real slots and pads of weight 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import (TWO_GRID_BLOCKS, jax_full, jax_problem, jax_two_grid_problem,
                                  port_blocked_problem, port_full_built, port_full_from_jax,
                                  port_two_grid_problem, rel, t)

from visual_inertial_bundle_adjustment_tpu.ops import segments as jseg
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

TOL = 1e-9


def _blocked(p):
    (i,) = [i for i, c in enumerate(p.cfgs) if c.block_info is not None]
    return p.datas[i], p.cfgs[i].block_info


def _check_positions(data):
    pos, obs = data["_pt_pos"].numpy(), data["_pt_obs"].numpy()
    pad = data["_pad"].numpy() > 0.5
    assert pos.dtype == np.int32 and pos.shape == pad.shape
    np.testing.assert_array_equal(pos[obs], np.arange(len(obs)))
    assert np.all(pos[pad] == -1) and np.all(pos[~pad] >= 0)


@pytest.mark.parametrize("problem", ["bias", "full_sensor", "two_grid"])
def test_pt_pos_inverts_pt_obs(problem):
    p = (port_full_built()[0] if problem == "full_sensor"
         else port_blocked_problem(blocks=TWO_GRID_BLOCKS if problem == "two_grid" else None))
    data, _ = _blocked(p)
    _check_positions(data)
    plan = trcs.plan_of(data)
    assert plan.pt_pos is data["_pt_pos"]
    assert tseg.point_rows(plan).scattered and not tseg.rig_rows(plan).scattered


@functools.lru_cache(maxsize=None)
def _full_pair():
    return port_full_from_jax(), port_full_built()[0]


def test_interop_carries_pt_pos_and_pairs():
    """The handoff of the JAX package's blocked layout gets the same
    positions and pairs as the port's own blocking of the same session."""
    (d_i, info_i), (d_b, info_b) = (_blocked(p) for p in _full_pair())
    assert info_i.wb > 0
    np.testing.assert_array_equal(d_i["rig"].numpy(), d_b["rig"].numpy())
    _check_positions(d_i)
    for key in ["_pt_pos"] + [k for k in d_b if k.startswith("_cal_")]:
        np.testing.assert_array_equal(d_i[key].numpy(), d_b[key].numpy(), err_msg=key)
    cplan = trcs.cal_plan_of(d_i, info_i)
    assert cplan.n_pairs == len(d_i["_cal_pair_part"])


def _check_pairs(rig, win, pad, arrays, n_rig, n_win):
    rig_pair, ptr, obs = arrays["_cal_rig_pair"], arrays["_cal_pair_ptr"], arrays["_cal_pair_obs"]
    part, win_pair = arrays["_cal_pair_part"], arrays["_cal_win_pair"]
    real = np.nonzero(pad < 0.5)[0]
    np.testing.assert_array_equal(np.sort(obs), real)  # every real slot once
    assert np.all(np.diff(rig[obs]) >= 0)  # in rig order
    n_pairs = len(ptr) - 1
    assert rig_pair[0] == 0 and rig_pair[-1] == n_pairs and len(rig_pair) == n_rig + 1
    assert np.all(np.diff(ptr) > 0)
    pair_rig, pair_win = np.empty(n_pairs, int), np.empty(n_pairs, int)
    for q in range(n_pairs):
        s = obs[ptr[q]:ptr[q + 1]]
        assert len(set(rig[s])) == 1 and len(set(win[s])) == 1
        assert np.all(np.diff(s) > 0)  # slot order inside a pair
        pair_rig[q], pair_win[q] = rig[s[0]], win[s[0]]
    for r in range(n_rig):
        np.testing.assert_array_equal(pair_rig[rig_pair[r]:rig_pair[r + 1]], r)
    np.testing.assert_array_equal(np.sort(part), np.arange(n_pairs))
    assert len(win_pair) == n_win + 1 and win_pair[-1] == n_pairs
    inv = np.argsort(part)  # the pair whose partial is at each row of the table
    for c in range(n_win):
        mine = inv[win_pair[c]:win_pair[c + 1]]
        np.testing.assert_array_equal(pair_win[mine], c)
        assert np.all(np.diff(mine) > 0)  # each window row's partials in rig order
    return pair_rig


def test_pair_plan_covers_every_real_slot_in_rig_order():
    p, _ = port_full_built()
    data, info = _blocked(p)
    n_rig, n_win = p.variables.pose_q.shape[0], p.variables.cam_intr.shape[0]
    cplan = trcs.cal_plan_of(data, info)
    arrays = {"_cal_" + f: getattr(cplan, f).numpy() for f in tseg.CalPlan._fields[4:]}
    rig, win, pad = data["rig"].numpy(), cplan.win.numpy(), data["_pad"].numpy()
    _check_pairs(rig, win, pad, arrays, n_rig, n_win)
    # the same batch with a third of its slots moved to the other window row,
    # and a random unsorted case: rigs that span two or more window rows
    rng = np.random.default_rng(71)
    win2 = win.copy()
    win2[::3] = 1 - win2[::3]
    pair_rig = _check_pairs(rig, win2, pad, tseg.pair_plan_arrays(rig, win2, pad, n_rig, n_win),
                            n_rig, n_win)
    assert np.any(np.bincount(pair_rig) > 1)
    rig3 = np.sort(rng.integers(0, 9, size=300))
    win3 = rng.integers(0, 4, size=300)
    pad3 = (rng.random(300) < 0.2).astype(np.float64)
    pair_rig = _check_pairs(rig3, win3, pad3, tseg.pair_plan_arrays(rig3, win3, pad3, 10, 5),
                            10, 5)
    assert np.any(np.bincount(pair_rig) > 1)


# ---------------------------------------------------------------------------
# the kernels' data flow, as torch ops, vs the JAX entries
# ---------------------------------------------------------------------------


def _segment_sums(vals, ptr):
    """(rows, D): the sum of each row's contiguous range of vals (n_real, D)."""
    return torch.stack([vals[a:b].sum(0) for a, b in zip(ptr[:-1].tolist(), ptr[1:].tolist())])


def _to_sorted(vals, plan):
    """K9's down pass: vals (D, N) written slot-major at each real slot's
    point-sorted position."""
    real = plan.pt_obs.long()
    out = vals.new_zeros((real.shape[0], vals.shape[0]))
    out[plan.pt_pos.long()[real]] = vals[:, real].T
    return out


def _reduce_flow(contrib, rows):
    """K13c on a scattered family: the slot-major copy, then each row's
    slots gathered from it in list order and summed."""
    slot_major = contrib.T.contiguous()
    return _segment_sums(slot_major[rows.obs.long()], rows.ptr)


@pytest.mark.parametrize("D", [3, 9])
def test_landmark_row_reduce_flow_matches_jax(D):
    pj = jax_two_grid_problem()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if getattr(c, "block_info", None)]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    L = pj.variables.points.shape[0]
    pad = np.asarray(dj["_pad"])
    c = np.random.default_rng(73).normal(size=(D, pad.shape[0])) * (1.0 - pad)[None]
    want = jseg.seg_reduce_table(
        jrcs.permute_cols(jnp.asarray(c), dj["_pt_perm"]) * dj["_pt_w"][None], dj["_pt_local"],
        dj["_pt_base"], info.pnt, info.pts, info.prb, L)
    data, _ = _blocked(port_two_grid_problem())
    rows = tseg.point_rows(trcs.plan_of(data))
    assert rows.scattered and np.abs(np.asarray(want)).max() > 0
    assert rel(_reduce_flow(t(c), rows).numpy(), want) < TOL
    assert rel(tseg.seg_reduce_table(t(c), rows).numpy(), want) < TOL  # the plain version


def _pcg_cal_flow(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan):
    """K9's four launches as torch ops."""
    def wu_of():  # down and up: w (J_r x_r[rig] + J_c x_c[win]) per slot
        u = (J_r * x_r[plan.rig.long()].T[None]).sum(1)
        return (u + (J_c * x_c[cplan.win.long()].T[None]).sum(1)) * w[None]

    p = _to_sorted((J_p * wu_of()[:, None]).sum(0), plan)  # J_p^T wu, point-sorted
    t_l = _segment_sums(p, plan.pt_ptr)  # landmark sums
    z = (hinv * t_l[:, None, :]).sum(-1)
    du = wu_of() - (J_p * z[plan.point.long()].T[None]).sum(1) * w[None]
    R, kc = x_r.shape[0], J_c.shape[1]
    y_r = x_r.new_zeros(x_r.shape)
    part = x_c.new_zeros((cplan.n_pairs, kc))
    rp, ptr = cplan.rig_pair.tolist(), cplan.pair_ptr.tolist()
    for r in range(R):
        for q in range(rp[r], rp[r + 1]):
            s = cplan.pair_obs[ptr[q]:ptr[q + 1]].long()
            y_r[r] += (J_r[:, :, s] * du[:, None, s]).sum((0, 2))
            part[cplan.pair_part[q]] = (J_c[:, :, s] * du[:, None, s]).sum((0, 2))
    return y_r, _segment_sums(part, cplan.win_pair)


def _full_cal_case(kc, seed):
    """The full-sensor batch with a third of its slots moved to the other
    window row (rigs spanning both): the JAX entries' layout arguments, the
    port's plan and pair plan over the moved rows, and random J blocks (rig
    width 9, window width kc), weights, tables x_r, x_c, z and SPD
    landmark-block inverses from a numpy seed."""
    pj, _ = jax_full()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if c.kind == "rs_visual"]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    v = pj.variables
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    pad = np.asarray(dj["_pad"])
    N = pad.shape[0]
    cal_local = np.asarray(dj["_cb_local"]).copy()
    assert n_c == 2 and not np.asarray(dj["_cb_base"]).any()
    cal_local[::3] = 1 - cal_local[::3]  # rigs spanning both window rows
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(L, 3, 3))
    a = dict(J_r=rng.normal(size=(2, 9, N)), J_c=rng.normal(size=(2, kc, N)),
             J_p=rng.normal(size=(2, 3, N)), w=rng.random(N) * (1.0 - pad),
             x_r=rng.normal(size=(R, 9)), x_c=rng.normal(size=(n_c, kc)),
             hinv=A @ np.swapaxes(A, -1, -2) + np.eye(3), z=rng.normal(size=(L, 3)))
    p, _ = _full_pair()
    data, _ = _blocked(p)
    plan = trcs.plan_of(data)
    win = cal_local.astype(np.int64)
    arrays = {**tseg.cal_plan_arrays(win, pad, n_c),
              **tseg.pair_plan_arrays(np.asarray(dj["rig"]), win, pad, R, n_c)}
    cplan = tseg.CalPlan(torch.from_numpy(win.astype(np.int32)),
                         *(torch.from_numpy(arrays["_cal_" + f]) for f in tseg.CalPlan._fields[1:]))
    assert np.any(np.diff(cplan.rig_pair.numpy()) > 1)
    j = dict(loc=(dj["_rb_local"], jnp.asarray(cal_local), dj["_rg_pt_local"], dj["_rg_hib"]),
             bases=(dj["_rb_base"], dj["_cb_base"]),
             geo=(info.nt, info.ts, info.rb, info.wb, info.prb2 // 128, info.nhg), R=R, L=L,
             n_c=n_c)
    return j, plan, cplan, a


@pytest.mark.parametrize("kc", [6, 17, 23])
def test_pcg_cal_flow_matches_jax(kc):
    j, plan, cplan, a = _full_cal_case(kc, 79)
    names = ("J_r", "J_c", "J_p", "w", "x_r", "x_c", "hinv")
    J = {k: jnp.asarray(a[k]) for k in names}
    want = jseg.seg_schur_pcg_cal(
        J["J_r"], J["J_c"], J["J_p"], J["w"], *j["loc"], J["x_r"], J["x_c"], J["hinv"],
        *j["bases"], j["L"], *j["geo"])
    args = [t(a[k]) for k in names]
    got = _pcg_cal_flow(*args, plan, cplan)
    plain = tseg.seg_schur_pcg_cal(*args, plan, cplan)
    for g, pl, wj in zip(got, plain, want):
        assert np.abs(np.asarray(wj)).max() > 0
        assert rel(g.numpy(), wj) < TOL
        assert rel(pl.numpy(), wj) < TOL


def _win_pair_sums(part, win_pair):
    """Each window row's pair partials (rows of part, D) summed in rig
    order (tile_reduce.cuh sum_partials)."""
    wp = win_pair.tolist()
    out = []
    for a, b in zip(wp[:-1], wp[1:]):
        total = part.new_zeros(part.shape[1])
        for q in range(a, b):
            total = total + part[q]
        out.append(total)
    return torch.stack(out)


def _pair_pass_sums(J_r, J_c, wu, cplan):
    """K10's rig-pair pass (csrc/cal_pcg.cu cal_pair_pass: a 128-thread
    group a rig row) on a per-slot wu (2, N): each rig row's slots in
    (rig, window row) pair order, J_r^T wu summed in the group's order
    across the row's pairs (y_r) and J_c^T wu per pair (its partial row),
    then each window row's partials summed in rig order (y_c)."""
    s = cplan.pair_obs.long()
    c_r = (J_r * wu[:, None]).sum(0).T[s]
    c_c = (J_c * wu[:, None]).sum(0).T[s]
    y_r = _pair_lane_sums(c_r, cplan.rig_pair.tolist(), cplan.pair_ptr.tolist(), 128)
    part = c_c.new_zeros((cplan.n_pairs, c_c.shape[1]))
    part[cplan.pair_part.long()] = _group_sums(c_c, cplan.pair_ptr, 128)
    return y_r, _win_pair_sums(part, cplan.win_pair)


def _schur_down_cal_flow(J_r, J_c, J_p, w, x_r, x_c, plan, cplan, want_y):
    """K10's down pass as torch ops: wu = w (J_r x_r[rig] + J_c x_c[win]),
    p = J_p^T wu at each real slot's point-sorted position, each landmark's
    contiguous range summed by a 16-lane group (t); with y, the rig-pair
    pass's sums of the same wu (y_r, y_c)."""
    wu = ((J_r * x_r[plan.rig.long()].T[None]).sum(1)
          + (J_c * x_c[cplan.win.long()].T[None]).sum(1)) * w[None]
    t_l = _group_sums(_to_sorted((J_p * wu[:, None]).sum(0), plan), plan.pt_ptr, 16)
    if not want_y:
        return None, None, t_l
    return (*_pair_pass_sums(J_r, J_c, wu, cplan), t_l)


@pytest.mark.parametrize("want_y", [True, False])
@pytest.mark.parametrize("kc", [6, 17, 23])
def test_schur_down_cal_flow_matches_jax(kc, want_y):
    """K10's down flow and its plain version, (y_r, y_c, t) or (None, None,
    t), equal the JAX entry seg_schur_down_cal on its XLA branch (f64, 1e-9)
    with rigs spanning both window rows."""
    j, plan, cplan, a = _full_cal_case(kc, 229 + kc)
    names = ("J_r", "J_c", "J_p", "w", "x_r", "x_c")
    J = {k: jnp.asarray(a[k]) for k in names}
    want = jseg.seg_schur_down_cal(J["J_r"], J["J_c"], J["J_p"], J["w"], *j["loc"], J["x_r"],
                                   J["x_c"], *j["bases"], j["L"], *j["geo"])
    args = [t(a[k]) for k in names]
    got = _schur_down_cal_flow(*args, plan, cplan, want_y)
    plain = tseg.seg_schur_down_cal(*args, plan, cplan, want_y)
    assert len(got) == len(plain) == 3
    assert (got[0] is None) == (plain[1] is None) == (not want_y)
    for g, pl, wj in list(zip(got, plain, want))[0 if want_y else 2:]:
        assert np.abs(np.asarray(wj)).max() > 0
        assert rel(g.numpy(), wj) < TOL and rel(pl.numpy(), wj) < TOL


@pytest.mark.parametrize("kc", [6, 17, 23])
def test_schur_up_cal_flow_matches_jax(kc):
    """K10's up flow (w J_p z[point] a slot, the rig-pair pass's sums) and
    its plain version equal the JAX entry seg_schur_up_cal on its XLA
    branch (f64, 1e-9) with rigs spanning both window rows."""
    j, plan, cplan, a = _full_cal_case(kc, 233 + kc)
    names = ("J_r", "J_c", "J_p", "w", "z")
    J = {k: jnp.asarray(a[k]) for k in names}
    want = jseg.seg_schur_up_cal(J["J_r"], J["J_c"], J["J_p"], J["w"], *j["loc"], J["z"],
                                 *j["bases"], *j["geo"], j["R"], j["n_c"])
    J_r, J_c, J_p, w, z = (t(a[k]) for k in names)
    wu = (J_p * z[plan.point.long()].T[None]).sum(1) * w[None]
    got = _pair_pass_sums(J_r, J_c, wu, cplan)
    plain = tseg.seg_schur_up_cal(J_r, J_c, J_p, w, z, plan, cplan)
    for g, pl, wj in zip(got, plain, want):
        assert np.abs(np.asarray(wj)).max() > 0
        assert rel(g.numpy(), wj) < TOL and rel(pl.numpy(), wj) < TOL


def test_per_call_counts_missed_launches():
    """Two sessions of 20 calls: kernel a recorded 19 and 20 times (one
    launch a call), b twice a call, c once in all; the second session lost
    every launch of d."""
    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm

    got = pm.per_call([[("a", 19, 1900.0), ("b", 40, 800.0), ("c", 1, 5.0), ("d", 20, 400.0)],
                       [("a", 20, 2100.0), ("b", 40, 800.0)]], 20)
    assert got == {"a": (1, 4000.0 / 39 / 1e3), "b": (2, 0.04), "c": (0.05, 0.005 * 0.05),
                   "d": (1, 0.02)}


def test_device_kernels_leave_out_the_operators_rows():
    """A PyTorch operator's profiler row carries the device time of the
    kernel it launched, which the kernel's own row counts: only the
    device-side rows are summed (on an H100, aten::index 12.80 ms beside
    its index_elementwise_kernel 12.74 ms doubled the attempt's device time
    of that work)."""
    from types import SimpleNamespace as Row

    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    rows = [Row(key="aten::index", device_type=cpu, count=684, self_device_time_total=12800.0),
            Row(key="index_elementwise_kernel", device_type=cuda, count=669,
                self_device_time_total=12740.0),
            Row(key="aten::empty", device_type=cpu, count=9, self_device_time_total=0.0),
            Row(key="Memset (Device)", device_type=cuda, count=2, self_device_time_total=3.0)]
    assert pm.device_kernels(rows) == [("index_elementwise_kernel", 669, 12740.0),
                                       ("Memset (Device)", 2, 3.0)]
    with pytest.raises(RuntimeError):
        pm.per_call([[], []], 20)


# ---------------------------------------------------------------------------
# K4 through the positions, K13a on landmark rows through the slot-major copy
# ---------------------------------------------------------------------------


def _schur_pcg_flow(J_r, J_p, w, x, hinv, plan):
    """K4's three launches as torch ops."""
    def wu_of():  # down and up: w J_r x[rig] per slot
        return (J_r * x[plan.rig.long()].T[None]).sum(1) * w[None]

    p = _to_sorted((J_p * wu_of()[:, None]).sum(0), plan)  # J_p^T wu, point-sorted
    z = (hinv * _segment_sums(p, plan.pt_ptr)[:, None, :]).sum(-1)
    du = wu_of() - (J_p * z[plan.point.long()].T[None]).sum(1) * w[None]
    contrib = (J_r * du[:, None]).sum(0)  # (k, N)
    return _segment_sums(contrib.T[plan.rig_obs.long()], plan.rig_ptr)


def _schur_pcg_case(k, cols=None):
    """K4's inputs on the bias-only batch (two rigs and two observed
    landmarks left without slots: zero weights for the JAX entry, pads for
    the port's plan), x (R, k) or, with `cols`, (R, k, cols); and the JAX
    entry on one (R, k) table."""
    pj = jax_problem()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if getattr(c, "block_info", None)]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    R, L = pj.variables.pose_q.shape[0], pj.variables.points.shape[0]
    rig, point = np.asarray(dj["rig"]), np.asarray(dj["point"])
    pad = np.asarray(dj["_pad"]).copy()
    N = pad.shape[0]
    empty_rigs = np.unique(rig[pad < 0.5])[[1, -2]]
    empty_pts = np.unique(point[pad < 0.5])[[2, 7]]
    pad[np.isin(rig, empty_rigs) | np.isin(point, empty_pts)] = 1.0
    rng = np.random.default_rng(107 + k)
    A = rng.normal(size=(L, 3, 3))
    a = dict(J_r=rng.normal(size=(2, k, N)), J_p=rng.normal(size=(2, 3, N)),
             w=rng.random(N) * (1.0 - pad),
             x=rng.normal(size=(R, k) if cols is None else (R, k, cols)),
             hinv=A @ np.swapaxes(A, -1, -2) + np.eye(3))

    def jax_entry(x):
        J = {key: jnp.asarray(v) for key, v in a.items()}
        return np.asarray(jseg.seg_schur_pcg(
            J["J_r"], J["J_p"], J["w"], dj["_rb_local"], dj["_rg_pt_local"], dj["_rg_hib"],
            jnp.asarray(x), J["hinv"], dj["_rb_base"], L, info.nt, info.ts, info.rb,
            info.prb2 // 128, info.nhg))

    arrays = trcs.segment_plan(rig, point, pad, R, L)
    plan = tseg.SegPlan(t(rig.astype(np.int32)), t(point.astype(np.int32)),
                        *(t(arrays[key]) for key in ("_rig_ptr", "_rig_obs", "_pt_ptr",
                                                     "_pt_obs", "_pt_pos")))
    assert np.all(np.diff(arrays["_rig_ptr"])[empty_rigs] == 0)
    assert np.all(np.diff(arrays["_pt_ptr"])[empty_pts] == 0)
    return a, plan, jax_entry, empty_rigs


@pytest.mark.parametrize("k", [6, 9])
def test_schur_pcg_flow_matches_jax(k):
    a, plan, jax_entry, empty_rigs = _schur_pcg_case(k)
    want = jax_entry(a["x"])
    args = [t(v) for v in a.values()]
    assert np.abs(want).max() > 0 and np.all(want[empty_rigs] == 0)
    assert rel(_schur_pcg_flow(*args, plan).numpy(), want) < TOL
    assert rel(tseg.seg_schur_pcg(*args, plan).numpy(), want) < TOL  # the plain version


def test_landmark_mv_scatter_flow_matches_jax():
    pj = jax_two_grid_problem()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if getattr(c, "block_info", None)]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    L = pj.variables.points.shape[0]
    pad = np.asarray(dj["_pad"])
    rng = np.random.default_rng(109)
    J = rng.normal(size=(2, 3, pad.shape[0]))
    u = rng.normal(size=(2, pad.shape[0])) * (1.0 - pad)[None]
    perm = dj["_pt_perm"]
    J_po = jrcs.permute_cols(jnp.asarray(J), perm) * dj["_pt_w"][None, None]
    want = jseg.seg_mv_scatter_table(J_po, jrcs.permute_cols(jnp.asarray(u), perm),
                                     dj["_pt_local"], dj["_pt_base"], info.pnt, info.pts,
                                     info.prb, L)
    data, _ = _blocked(port_two_grid_problem())
    rows = tseg.point_rows(trcs.plan_of(data))
    assert rows.scattered and np.abs(np.asarray(want)).max() > 0
    # K13a's flow: K13c's on the per-slot J^T u
    assert rel(_reduce_flow((t(J) * t(u)[:, None]).sum(0), rows).numpy(), want) < TOL
    assert rel(tseg.seg_mv_scatter_table(t(J), t(u), rows).numpy(), want) < TOL  # the plain


# ---------------------------------------------------------------------------
# K2 through the slot-major table, K6 through the positions
# ---------------------------------------------------------------------------


def _group_sums(vals, ptr, lanes):
    """Each row's sum of vals (n_real, D) over its range [ptr[r], ptr[r+1])
    as a group of `lanes` threads takes it (tile_reduce.cuh group_sum): lane
    i sums the entries i, i + lanes, ... in order, a xor butterfly inside
    each warp, then the warps' totals in warp order."""
    warp = min(lanes, 32)
    out = []
    for a, b in zip(ptr[:-1].tolist(), ptr[1:].tolist()):
        acc = vals.new_zeros((lanes, vals.shape[1]))
        for j in range(a, b):
            acc[(j - a) % lanes] += vals[j]
        acc = acc.reshape(lanes // warp, warp, -1)
        off = warp // 2
        while off:
            acc = acc + acc[:, torch.arange(warp) ^ off]
            off //= 2
        total = acc[0, 0]
        for wi in range(1, lanes // warp):
            total = total + acc[wi, 0]
        out.append(total)
    return torch.stack(out)


def _assemble_rig_flow(J_r, J_p, res, w, plan):
    """K2's two launches as torch ops: the 128-thread group's sums of
    J_r^T w res and diag(J_r^T w J_r) per rig row, and each real slot's
    sector sqrt(w) (J_p row 0, res 0 | J_p row 1, res 1) written at its
    point-sorted position; then a 16-lane group per landmark summing its
    contiguous range of sectors into g_l and the upper triangle of H_ll0
    (the full 3x3 block through kTri)."""
    wr = res * w[None]
    rows = torch.cat([(J_r * wr[:, None]).sum(0), (J_r * J_r * w[None, None]).sum(0)])
    per_rig = _group_sums(rows.T[plan.rig_obs.long()], plan.rig_ptr, 128)
    k = J_r.shape[1]
    sw = w.sqrt()
    sectors = torch.cat([J_p[0], res[:1], J_p[1], res[1:]]) * sw[None]  # (8, N)
    a, b = _to_sorted(sectors, plan).reshape(-1, 2, 4).unbind(1)  # the two float4, point-sorted
    tri = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    vals = torch.stack([a[:, c] * a[:, 3] + b[:, c] * b[:, 3] for c in range(3)]
                       + [a[:, p] * a[:, q] + b[:, p] * b[:, q] for p, q in tri], dim=1)
    pt = _group_sums(vals, plan.pt_ptr, 16)
    H = pt[:, 3:][:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(-1, 3, 3)
    return per_rig[:, :k], per_rig[:, k:], pt[:, :3], H


def _schur_down_flow(J_r, J_p, w, x, plan, want_y):
    """K6's two launches as torch ops: p = J_p^T w J_r x written at each
    real slot's point-sorted position (with y, the 128-thread group's sums
    of J_r^T w J_r x per rig row beside it), then each landmark's
    contiguous range of p summed by a 16-thread group, no 3x3 solve."""
    wu = (J_r * x[plan.rig.long()].T[None]).sum(1) * w[None]
    t_l = _group_sums(_to_sorted((J_p * wu[:, None]).sum(0), plan), plan.pt_ptr, 16)
    if not want_y:
        return None, t_l
    contrib = (J_r * wu[:, None]).sum(0)  # (k, N)
    return _group_sums(contrib.T[plan.rig_obs.long()], plan.rig_ptr, 128), t_l


def _bias_case(seed, k, names):
    """The tiny bias-only batch with two rigs and two observed landmarks left
    without slots (zero weights for the JAX entries, pads for the port's
    plan): the JAX entries' layout arguments, the port's plan, and random
    arrays `names` from a numpy seed (J_r at rig width k)."""
    pj = jax_problem()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if getattr(c, "block_info", None)]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    R, L = pj.variables.pose_q.shape[0], pj.variables.points.shape[0]
    rig, point = np.asarray(dj["rig"]), np.asarray(dj["point"])
    pad = np.asarray(dj["_pad"]).copy()
    N = pad.shape[0]
    empty_rigs = np.unique(rig[pad < 0.5])[[1, -2]]
    empty_pts = np.unique(point[pad < 0.5])[[2, 7]]
    pad[np.isin(rig, empty_rigs) | np.isin(point, empty_pts)] = 1.0
    rng = np.random.default_rng(seed)
    shapes = dict(J_r=(2, k, N), J_p=(2, 3, N), res=(2, N), x=(R, k), z=(L, 3))
    a = {nm: rng.random(N) * (1.0 - pad) if nm == "w" else rng.normal(size=shapes[nm])
         for nm in names}
    arrays = trcs.segment_plan(rig, point, pad, R, L)
    plan = tseg.SegPlan(t(rig.astype(np.int32)), t(point.astype(np.int32)),
                        *(t(arrays[key]) for key in ("_rig_ptr", "_rig_obs", "_pt_ptr",
                                                     "_pt_obs", "_pt_pos")))
    loc = (dj["_rb_local"], dj["_rg_pt_local"], dj["_rg_hib"])
    geo = (info.nt, info.ts, info.rb, info.prb2 // 128, info.nhg)
    return dict(loc=loc, base=dj["_rb_base"], geo=geo, R=R, L=L), plan, a, empty_rigs, empty_pts


@pytest.mark.parametrize("k", [6, 9])
def test_assemble_rig_flow_matches_jax(k):
    """K2's flow and its plain version equal the JAX entry on its XLA branch
    (f64, 1e-10); the rigs and landmarks without slots come out zero."""
    j, plan, a, empty_rigs, empty_pts = _bias_case(211 + k, k, ("J_r", "J_p", "res", "w"))
    J = {key: jnp.asarray(v) for key, v in a.items()}
    want = [np.asarray(x) for x in jseg.seg_assemble_rig(
        J["J_r"], J["J_p"], J["res"], J["w"], *j["loc"], j["base"], j["L"], *j["geo"], j["R"])]
    args = [t(v) for v in a.values()]
    got = _assemble_rig_flow(*args, plan)
    plain = tseg.seg_assemble_rig(*args, plan)
    assert len(got) == len(plain) == len(want) == 4
    for g, pl, wj in zip(got, plain, want):
        assert np.abs(wj).max() > 0
        assert rel(g.numpy(), wj) < 1e-10 and rel(pl.numpy(), wj) < 1e-10
    assert np.all(got[0].numpy()[empty_rigs] == 0) and np.all(got[3].numpy()[empty_pts] == 0)


@pytest.mark.parametrize("want_y", [True, False])
@pytest.mark.parametrize("k", [6, 9])
def test_schur_down_flow_matches_jax(k, want_y):
    """K6's flow and its plain version, (y, t) or (None, t), equal the JAX
    entry's (y, t) on its XLA branch (f64, 1e-10)."""
    j, plan, a, empty_rigs, empty_pts = _bias_case(223 + k, k, ("J_r", "J_p", "w", "x"))
    J = {key: jnp.asarray(v) for key, v in a.items()}
    want = [np.asarray(x) for x in jseg.seg_schur_down(
        J["J_r"], J["J_p"], J["w"], *j["loc"], J["x"], j["base"], j["L"], *j["geo"])]
    args = [t(v) for v in a.values()]
    got = _schur_down_flow(*args, plan, want_y)
    plain = tseg.seg_schur_down(*args, plan, want_y)
    assert len(got) == len(plain) == 2 and (got[0] is None) == (plain[0] is None) == (not want_y)
    for g, pl, wj in list(zip(got, plain, want))[1 - want_y:]:
        assert np.abs(wj).max() > 0
        assert rel(g.numpy(), wj) < 1e-10 and rel(pl.numpy(), wj) < 1e-10
    assert np.all(got[1].numpy()[empty_pts] == 0)


def _schur_up_flow(J_r, J_p, w, z, plan):
    """K5 as torch ops: d = w J_p z[point] a slot, J_r^T d summed per rig
    row in the 128-thread group's order (thread i takes the row's slots i,
    i + 128, ... in order, its batches of loads changing nothing in it)."""
    d = (J_p * z[plan.point.long()].T[None]).sum(1) * w[None]
    return _group_sums((J_r * d[:, None]).sum(0).T[plan.rig_obs.long()], plan.rig_ptr, 128)


@pytest.mark.parametrize("k", [6, 9])
def test_schur_up_flow_matches_jax(k):
    """K5's flow and its plain version equal the JAX entry seg_schur_up on
    its XLA branch (f64, 1e-9); the rigs without slots come out zero."""
    j, plan, a, empty_rigs, _ = _bias_case(227 + k, k, ("J_r", "J_p", "w", "z"))
    J = {key: jnp.asarray(v) for key, v in a.items()}
    want = np.asarray(jseg.seg_schur_up(J["J_r"], J["J_p"], J["w"], *j["loc"], J["z"], j["base"],
                                        *j["geo"], j["R"]))
    args = [t(v) for v in a.values()]
    got = _schur_up_flow(*args, plan)
    plain = tseg.seg_schur_up(*args, plan)
    assert np.abs(want).max() > 0 and np.all(want[empty_rigs] == 0)
    assert rel(got.numpy(), want) < TOL and rel(plain.numpy(), want) < TOL
    assert np.all(got.numpy()[empty_rigs] == 0)


# ---------------------------------------------------------------------------
# K3: A H A^T a slot, a warp a rig row, a reduce-scatter tail
# ---------------------------------------------------------------------------


def _k3_tri_entry(e, k):
    """precond_rig.cu tri_entry: (a, b), a <= b, of entry e of the upper
    triangle row by row."""
    row = start = 0
    for i in range(k - 1):
        if row == i and e >= start + (k - i):
            start += k - i
            row = i + 1
    return row, row + e - start


def _precond_rig_flow(J_r, J_p, w, hinv, plan):
    """K3 as torch ops: per slot A = w J_r^T J_p (k x 3) and the upper
    triangle of w J_r J_r^T - A H A^T (H = H_ll^-1[point]) row by row
    (entry (a, b) = w J_r[:, a] . J_r[:, b] - (A_a H) . A_b); each rig row's
    sum over its slot range [rig_obs[beg], rig_obs[end-1]] (pads included)
    in the order of its warp (lane i takes the range's slots i, i + 32, ...
    in order, its batches of loads changing nothing in it; then the
    butterfly); entry e written at tri_entry(e) and its mirror. Rows
    without slots are zero."""
    k = J_r.shape[1]
    H = hinv[plan.point.long()]
    Jp, Jr = J_p.permute(2, 0, 1), J_r.permute(2, 0, 1)  # (N, 2, 3), (N, 2, k)
    A = w[:, None, None] * Jr.transpose(1, 2) @ Jp  # (N, k, 3)
    E = w[:, None, None] * Jr.transpose(1, 2) @ Jr - (A @ H) @ A.transpose(1, 2)
    entries = [_k3_tri_entry(e, k) for e in range(k * (k + 1) // 2)]
    tri = torch.stack([E[:, a, b] for a, b in entries], dim=1)
    out = tri.new_zeros((plan.n_rows, k, k))
    ptr, obs = plan.rig_ptr.tolist(), plan.rig_obs.tolist()
    for r in range(plan.n_rows):
        if ptr[r] == ptr[r + 1]:
            continue
        first, last = obs[ptr[r]], obs[ptr[r + 1] - 1]
        sums = _group_sums(tri[first:last + 1], torch.tensor([0, last + 1 - first]), 32)[0]
        for e, (a, b) in enumerate(entries):
            out[r, a, b] = out[r, b, a] = sums[e]
    return out


@pytest.mark.parametrize("k", [6, 9])
def test_precond_rig_flow_matches_jax(k):
    """K3's flow (a warp a rig row) and its plain version equal the JAX entry seg_precond_rig on its XLA branch (f64, 1e-9), with a
    symmetric positive-definite H_ll^-1 table; the rigs without slots come
    out exactly zero."""
    j, plan, a, empty_rigs, _ = _bias_case(233 + k, k, ("J_r", "J_p", "w"))
    A = np.random.default_rng(239 + k).normal(size=(j["L"], 3, 3))
    hinv = A @ np.swapaxes(A, -1, -2) + np.eye(3)
    J = {key: jnp.asarray(v) for key, v in a.items()}
    want = np.asarray(jseg.seg_precond_rig(J["J_r"], J["J_p"], J["w"], *j["loc"],
                                           jnp.asarray(hinv), j["base"], *j["geo"], j["R"]))
    args = [t(v) for v in a.values()] + [t(hinv)]
    plain = tseg.seg_precond_rig(*args, plan)
    assert np.abs(want).max() > 0 and np.all(want[empty_rigs] == 0)
    assert rel(plain.numpy(), want) < TOL
    got = _precond_rig_flow(*args, plan)
    assert rel(got.numpy(), want) < TOL
    assert torch.equal(got, got.transpose(1, 2))
    assert np.all(got.numpy()[empty_rigs] == 0)


@pytest.mark.parametrize("problem", ["bias", "full_sensor"])
def test_precond_rig_row_ranges_hold_the_rows_slots_and_zero_weight_pads(problem):
    """K3 walks each rig row's slot range [rig_obs[beg], rig_obs[end-1]]: on
    the port's blocked batches the real slots there are the row's list, in
    order, every other slot is a pad, and a pad's weight in the batch is 0
    (so it adds nothing)."""
    p = port_full_built()[0] if problem == "full_sensor" else port_blocked_problem()
    ks, datas = p._build(), tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    (b, _), = trcs._vis_batches(p.active_cfgs, datas, lg)
    pad = _blocked(p)[0]["_pad"].numpy() > 0.5
    assert pad.any() and np.all(b.w.numpy()[pad] == 0)
    ptr, obs = b.plan.rig_ptr.numpy(), b.plan.rig_obs.numpy()
    for r in range(b.plan.n_rows):
        if ptr[r] < ptr[r + 1]:
            span = np.arange(obs[ptr[r]], obs[ptr[r + 1] - 1] + 1)
            np.testing.assert_array_equal(span[~pad[span]], obs[ptr[r]:ptr[r + 1]])


def _reduce_scatter(parts):
    """precond_rig.cu ReduceScatter over a warp's 32 lanes in float32:
    parts (32, T) -> {entry: [(lane, value)]} of what each lane ends owning."""
    held = [list(parts[lane]) for lane in range(32)]
    base, cnt = [0] * 32, [parts.shape[1]] * 32
    off = 16
    while off:
        n = len(held[0])
        half = (n + 1) // 2
        pad = [np.float32(0.0)] * (2 * half - n)
        lo = [x[:half] for x in held]
        hi = [x[half:] + pad for x in held]
        nxt = []
        for lane in range(32):
            upper, other = bool(lane & off), lane ^ off
            keep, recv = (hi[lane], hi[other]) if upper else (lo[lane], lo[other])
            nxt.append([np.float32(x + y) for x, y in zip(keep, recv)])
            if upper:
                base[lane] += half
                cnt[lane] = max(cnt[lane] - half, 0)
            else:
                cnt[lane] = min(cnt[lane], half)
        held = nxt
        off //= 2
    owned = {}
    for lane in range(32):
        for i in range(cnt[lane]):
            owned.setdefault(base[lane] + i, []).append((lane, held[lane][i]))
    return owned


@pytest.mark.parametrize("T", [21, 45])
def test_reduce_scatter_owns_each_entry_once_with_the_butterfly_bits(T):
    """K3's tail at K 6 (T 21) and 9 (T 45): every entry of the triangle
    ends with exactly one lane, ceil(T / 32) at most a lane, holding the
    bits of group_sum's xor butterfly over the warp's lanes."""
    parts = np.random.default_rng(241 + T).normal(size=(32, T)).astype(np.float32)
    owned = _reduce_scatter(parts)
    assert sorted(owned) == list(range(T))
    per_lane = {}
    for e, holders in owned.items():
        assert len(holders) == 1
        lane, value = holders[0]
        per_lane[lane] = per_lane.get(lane, 0) + 1
        assert value == _butterfly(list(parts[:, e]))
    assert max(per_lane.values()) == -(-T // 32)


@pytest.mark.parametrize("kernel", ["schur_pcg", "mv_scatter_table"])
def test_cpu_tensors_take_the_plain_versions(kernel):
    """On CPU tensors the wrappers compute their plain versions and count no
    launch."""
    data, _ = _blocked(port_blocked_problem())
    plan = trcs.plan_of(data)
    n, R, L = data["_pad"].shape[0], plan.n_rows, plan.n_pts
    rng = np.random.default_rng(113)
    w = t(rng.random(n) * (1.0 - data["_pad"].numpy()))
    _kernels.reset_launch_counts()
    if kernel == "schur_pcg":
        A = rng.normal(size=(L, 3, 3))
        args = (t(rng.normal(size=(2, 6, n))), t(rng.normal(size=(2, 3, n))), w,
                t(rng.normal(size=(R, 6))), t(A @ np.swapaxes(A, -1, -2) + np.eye(3)))
        got, want = tseg.seg_schur_pcg(*args, plan), _schur_pcg_flow(*args, plan)
    else:
        rows = tseg.point_rows(plan)
        J, u = t(rng.normal(size=(2, 3, n))), t(rng.normal(size=(2, n))) * w[None]
        got = tseg.seg_mv_scatter_table(J, u, rows)
        want = _reduce_flow((J * u[:, None]).sum(0), rows)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert rel(got.numpy(), want.numpy()) < TOL
    assert sum(_kernels.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# K8: one window pass over the chunk lists, then the sums in chunk order
# ---------------------------------------------------------------------------

STEP, LANES = 128, 32  # K8: the slots a warp takes per step, its lanes (4 slots each)


def _tri_index(a, b, dim):
    """cal_assemble.cu tri_index: (a, b), a <= b, in a row-major upper triangle."""
    return a * dim - a * (a - 1) // 2 + (b - a)


def _cal_tiles(splits):
    """CalTiles: the split widths KE, KI, the shared-memory column of the
    residual KP, and the items (kind 0 a 3x3 tile, 1 a diagonal tile, 2
    three gradient entries; first columns a0, b0) in kernel order."""
    KE, KI = (6 if 6 in splits else 0), (17 if 17 in splits else 0)
    KIP = -(-KI // 3) * 3
    KP = KE + KIP
    items = [(int(i == j), 3 * i, 3 * j) for i in range(KE // 3) for j in range(i, KE // 3)]
    items += [(int(i == j), KE + 3 * i, KE + 3 * j) for i in range(KIP // 3)
              for j in range(i, KIP // 3)]
    items += [(2, 3 * g, KP) for g in range(-(-(KE + KI) // 3))]
    return KE, KI, KP, items


def _out_index(KE, KI, item, e):
    """CalTiles::out_index: the partial-row position of entry e of an item."""
    kind, a0, b0 = item
    a, b, kc = a0 + e // 3, b0 + e % 3, KE + KI
    if kind == 2:
        return a if e % 3 == 0 and a < kc else -1
    if a > b:
        return -1
    if b < KE:
        return kc + _tri_index(a, b, KE)
    return kc + KE * (KE + 1) // 2 + _tri_index(a - KE, b - KE, KI) if b - KE < KI else -1


def _assemble_cal_flow(J_c, res, w, cplan, splits):
    """K8's window and sum passes as torch ops: (g_c, diag_c, [blocks])."""
    KE, KI, KP, items = _cal_tiles(splits)
    kc = KE + KI
    ptr, obs = cplan.chunk_ptr.tolist(), cplan.chunk_obs.long()
    part = J_c.new_zeros((cplan.n_chunks, tseg.n_cal_out(splits)))
    xor = [torch.arange(LANES) ^ off for off in (16, 8, 4, 2, 1)]
    for ch in range(cplan.n_chunks):  # a block per chunk
        acc = J_c.new_zeros((len(items), LANES, 9))  # each lane's tile of each item
        for t0 in range(ptr[ch], ptr[ch + 1], STEP):  # the stages' 128-slot steps, in order
            s = obs[t0:min(t0 + STEP, ptr[ch + 1])]
            X = J_c.new_zeros((2, KP + 3, STEP))  # J_c's columns, padded, the residual
            X[:, :kc, :len(s)] = J_c[:, :, s]
            X[:, KP, :len(s)] = res[:, s]
            sw = J_c.new_zeros(STEP)
            sw[:len(s)] = w[s]
            X, sw = X.reshape(2, KP + 3, LANES, 4), sw.reshape(LANES, 4)
            for i, (kind, a0, b0) in enumerate(items):
                for q in range(4):  # a lane's slots in order
                    wa = X[:, a0:a0 + 3, :, q] * sw[:, q]
                    b = X[:, b0:b0 + 3, :, q]  # a gradient item's: [res, 0, 0]
                    acc[i] += (wa[:, :, None] * b[:, None]).sum(0).reshape(9, LANES).T
        for perm in xor:  # the warp's butterfly
            acc = acc + acc[:, perm]
        for i, item in enumerate(items):
            for e in range(9):
                o = _out_index(KE, KI, item, e)
                if o >= 0:
                    part[ch, o] = acc[i, 0, e]
    rc = cplan.row_chunk.tolist()
    rows = []
    for r in range(cplan.n_rows):  # the sum pass: chunk order
        total = part.new_zeros(part.shape[1])
        for ch in range(rc[r], rc[r + 1]):
            total = total + part[ch]
        rows.append(total)
    sums = torch.stack(rows)
    blocks, diag, off = [], [], 0
    for dim in splits:
        tri0 = kc + (KE * (KE + 1) // 2 if off else 0)
        idx = torch.tensor([[tri0 + _tri_index(min(a, b), max(a, b), dim) for b in range(dim)]
                            for a in range(dim)])
        blocks.append(sums[:, idx])
        diag.append(sums[:, idx.diagonal()])
        off += dim
    return sums[:, :kc], torch.cat(diag, dim=1), blocks


@pytest.mark.parametrize("kc", [6, 17, 23])
def test_assemble_cal_flow_matches_jax(kc):
    pj, _ = jax_full()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if c.kind == "rs_visual"]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    v = pj.variables
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    pad = np.asarray(dj["_pad"])
    N = pad.shape[0]
    win = np.asarray(dj["_cb_local"]).astype(np.int64)
    assert n_c == 2 and not np.asarray(dj["_cb_base"]).any()
    splits = tseg.CAL_SPLITS[kc]
    rng = np.random.default_rng(151 + kc)
    a = dict(J_r=rng.normal(size=(2, 9, N)), J_c=rng.normal(size=(2, kc, N)),
             J_p=rng.normal(size=(2, 3, N)), res=rng.normal(size=(2, N)),
             w=rng.random(N) * (1.0 - pad))
    J = {k: jnp.asarray(x) for k, x in a.items()}
    want = jseg.seg_assemble_cal(
        J["J_r"], J["J_c"], J["J_p"], J["res"], J["w"], dj["_rb_local"], jnp.asarray(win),
        dj["_rg_pt_local"], dj["_rg_hib"], dj["_rb_base"], dj["_cb_base"], L, info.nt, info.ts,
        info.rb, info.wb, info.prb2 // 128, info.nhg, R, n_c, splits)
    want = [np.asarray(x) for x in (*want[:4], *want[4], *want[5:])]
    p, _ = _full_pair()
    data, _ = _blocked(p)
    plan = trcs.plan_of(data)
    args = {k: t(x) for k, x in a.items()}
    for chunk in (tseg.CHUNK, 300):
        arrays = {**tseg.cal_plan_arrays(win, pad, n_c, chunk=chunk),
                  **tseg.pair_plan_arrays(np.asarray(dj["rig"]), win, pad, R, n_c)}
        cplan = tseg.CalPlan(torch.from_numpy(win.astype(np.int32)),
                             *(torch.from_numpy(arrays["_cal_" + f])
                               for f in tseg.CalPlan._fields[1:]))
        g_c, diag_c, blocks = _assemble_cal_flow(args["J_c"], args["res"], args["w"], cplan,
                                                 splits)
        for got, wj in zip((g_c, diag_c, *blocks), want[2:-2]):
            assert np.abs(wj).max() > 0 and rel(got.numpy(), wj) < TOL
        plain = tseg.seg_assemble_cal(args["J_r"], args["J_c"], args["J_p"], args["res"],
                                      args["w"], plan, cplan)
        plain = [*plain[:4], *plain[4], *plain[5:]]
        assert len(plain) == len(want)
        for got, wj in zip(plain, want):
            assert rel(got.numpy(), wj) < TOL


@pytest.mark.parametrize("k", [3, 6, 9, 17])
def test_full_block_layouts_match_tri_to_full(k):
    """The full symmetric blocks the kernels write from their upper
    triangles: K3's owner of entry e stores it at tri_entry(e) = (a, b) and
    at (b, a) (precond_rig.cu); K8's sum pass reads entry (a, b)
    at tri_index(min, max) (cal_assemble.cu sum_cal_points); K2 maps the 3x3
    block through kTri (assemble_rig.cuh)."""
    n = 5
    tri = torch.from_numpy(np.random.default_rng(157 + k).normal(size=(n, k * (k + 1) // 2)))
    want = tseg._tri_to_full(tri, k)
    k3 = tri.new_empty((n, k, k))
    for e in range(k * (k + 1) // 2):
        a, b = _k3_tri_entry(e, k)
        k3[:, a, b] = k3[:, b, a] = tri[:, e]
    k8 = tri[:, torch.tensor([[_tri_index(min(a, b), max(a, b), k) for b in range(k)]
                              for a in range(k)])]
    assert torch.equal(k3, want) and torch.equal(k8, want)
    if k == 3:
        assert torch.equal(tri[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(n, 3, 3), want)


# ---------------------------------------------------------------------------
# K4 and K9 on C right-hand sides (the covariance columns)
# ---------------------------------------------------------------------------

N_COLS = 11  # columns of the flow cases: one ragged tile of 32


def _records(J_r, J_p, w, plan, J_c=None, cplan=None):
    """The point-sorted copy the column kernels read (the fields of
    segments.point_sorted_records, float64): record j is real slot
    plan.pt_obs[j], pads excluded."""
    real = plan.pt_obs.long()
    rec = {"J_r": J_r[:, :, real], "J_p": J_p[:, :, real], "w": w[real],
           "rig": plan.rig.long()[real], "point": plan.point.long()[real]}
    if J_c is not None:
        rec.update(J_c=J_c[:, :, real], win=cplan.win.long()[real])
    return rec


def _at(rec, pos):
    return {key: val[..., pos] for key, val in rec.items()}


def _u_cols(rec, x_r, x_c=None):
    """(2, n, C): J_r x_r[rig] (+ J_c x_c[win]) of each record, every column."""
    u = (rec["J_r"][..., None] * x_r[rec["rig"]].permute(1, 0, 2)[None]).sum(1)
    if x_c is not None:
        u = u + (rec["J_c"][..., None] * x_c[rec["win"]].permute(1, 0, 2)[None]).sum(1)
    return u


def _point_pass_cols(rec, pt_ptr, x_r, hinv, x_c=None):
    """The landmark pass (csrc/pt_segments.cuh point_pass_cols): for every
    column, q = J_p^T w u of each record, each landmark's contiguous range of
    records summed in the 16-lane group's order (_group_sums), z (L, 3, C) =
    H_ll^-1 t. Nothing per (slot, column) is kept past the sums."""
    wu = _u_cols(rec, x_r, x_c) * rec["w"][None, :, None]
    q = (rec["J_p"][..., None] * wu[:, None]).sum(0)  # (3, n, C)
    n, C = q.shape[1], q.shape[2]
    t_l = _group_sums(q.permute(1, 0, 2).reshape(n, 3 * C), pt_ptr, 16).reshape(-1, 3, C)
    return (hinv[:, :, :, None] * t_l[:, None]).sum(2)


def _du_cols(rec, x_r, z, x_c=None):
    """(2, n, C): w u - w J_p z[point] of each record, every column."""
    zg = z[rec["point"]].permute(1, 0, 2)  # (3, n, C)
    a = (rec["J_p"][..., None] * zg[None]).sum(1)
    w = rec["w"][None, :, None]
    return _u_cols(rec, x_r, x_c) * w - a * w


def _schur_pcg_cols_flow(J_r, J_p, w, x, hinv, plan):
    """The column K4's two launches as torch ops: the landmark pass over the
    point-sorted records, then each rig row's records (through pt_pos, in
    the row's slot order) with du for every column and J_r^T du summed in
    the 128-thread group's order (csrc/schur.cu rig_pass_cols)."""
    rec = _records(J_r, J_p, w, plan)
    z = _point_pass_cols(rec, plan.pt_ptr, x, hinv)
    row = _at(rec, plan.pt_pos.long()[plan.rig_obs.long()])
    du = _du_cols(row, x, z)
    contrib = (row["J_r"][..., None] * du[:, None]).sum(0)  # (k, n, C)
    k, n, C = contrib.shape
    return _group_sums(contrib.permute(1, 0, 2).reshape(n, k * C), plan.rig_ptr,
                       128).reshape(-1, k, C)


def _pair_lane_sums(vals, rig_pair, pair_ptr, lanes=32):
    """Each rig row's sum of vals (n_real, D) in pair order, as a group of
    `lanes` threads takes it (the single-column K9's warp; K10's warp or
    128-thread group): lane i sums the entries i, i + lanes, ... of each of
    the row's pairs, carrying its partial across the pairs, then each
    warp's xor butterfly and the warps' totals in order."""
    out = []
    for r in range(len(rig_pair) - 1):
        acc = vals.new_zeros((lanes, vals.shape[1]))
        for q in range(int(rig_pair[r]), int(rig_pair[r + 1])):
            a, b = int(pair_ptr[q]), int(pair_ptr[q + 1])
            for j in range(a, b):
                acc[(j - a) % lanes] += vals[j]
        acc = acc.reshape(lanes // 32, 32, -1)
        off = 16
        while off:
            acc = acc + acc[:, torch.arange(32) ^ off]
            off //= 2
        total = acc[0, 0]
        for wi in range(1, lanes // 32):
            total = total + acc[wi, 0]
        out.append(total)
    return torch.stack(out)


def _pcg_cal_cols_flow(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan):
    """The column K9's three launches as torch ops: the landmark pass; each
    rig row's records in (rig, window row) pair order with du for every
    column, J_r^T du summed in the warp's order across the row's pairs and
    J_c^T du per pair (csrc/cal_pcg_cols.cuh cal_rig_pass_cols); each window
    row's pair partials summed in rig order (sum_partials)."""
    rec = _records(J_r, J_p, w, plan, J_c, cplan)
    z = _point_pass_cols(rec, plan.pt_ptr, x_r, hinv, x_c)
    row = _at(rec, plan.pt_pos.long()[cplan.pair_obs.long()])
    du = _du_cols(row, x_r, z, x_c)
    n, C = du.shape[1], du.shape[2]
    k, kc = J_r.shape[1], J_c.shape[1]
    c_r = (row["J_r"][..., None] * du[:, None]).sum(0).permute(1, 0, 2).reshape(n, k * C)
    c_c = (row["J_c"][..., None] * du[:, None]).sum(0).permute(1, 0, 2).reshape(n, kc * C)
    y_r = _pair_lane_sums(c_r, cplan.rig_pair.tolist(), cplan.pair_ptr.tolist())
    part = torch.empty_like(_group_sums(c_c, cplan.pair_ptr, 32))
    part[cplan.pair_part.long()] = _group_sums(c_c, cplan.pair_ptr, 32)
    return y_r.reshape(-1, k, C), _win_pair_sums(part, cplan.win_pair).reshape(-1, kc, C)


@pytest.mark.parametrize("k", [6, 9])
def test_schur_pcg_cols_flow_matches_jax(k):
    """K4 on 11 columns: the column kernel's flow (point-sorted records, the
    fused landmark pass, the rig rows' 128-thread order) and the plain
    column version against the JAX entry seg_schur_pcg on each column,
    within 1e-9; the plain column version bit-equal to the single-column
    one on each."""
    a, plan, jax_entry, empty_rigs = _schur_pcg_case(k, cols=N_COLS)
    want = np.stack([jax_entry(a["x"][..., c]) for c in range(N_COLS)], axis=-1)
    J_r, J_p, w, x, hinv = (t(v) for v in a.values())
    assert np.abs(want).max() > 0 and np.all(want[empty_rigs] == 0)
    got = _schur_pcg_cols_flow(J_r, J_p, w, x, hinv, plan)
    assert got.shape == x.shape and rel(got.numpy(), want) < TOL
    plain = tseg.seg_schur_pcg_cols(J_r, J_p, w, x, hinv, plan)
    assert plain.shape == x.shape and rel(plain.numpy(), want) < TOL
    for c in range(N_COLS):
        assert torch.equal(plain[..., c], tseg.seg_schur_pcg(J_r, J_p, w, x[..., c], hinv, plan))
    assert tseg.seg_schur_pcg_cols.launches == 0


@pytest.mark.parametrize("kc", [6, 23])
def test_pcg_cal_cols_flow_matches_jax(kc):
    """K9 on 11 columns (rigs spanning both window rows): the column
    kernel's flow (point-sorted records, the fused landmark pass, the rig
    rows' pairs in the warp's order, the window rows' sums) and the plain
    column version against the JAX entry seg_schur_pcg_cal on each column,
    within 1e-9; the plain column version bit-equal to the single-column
    one on each."""
    pj, _ = jax_full()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if c.kind == "rs_visual"]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    v = pj.variables
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    pad = np.asarray(dj["_pad"])
    N = pad.shape[0]
    cal_local = np.asarray(dj["_cb_local"]).copy()
    cal_local[::3] = 1 - cal_local[::3]
    rng = np.random.default_rng(83)
    A = rng.normal(size=(L, 3, 3))
    a = dict(J_r=rng.normal(size=(2, 9, N)), J_c=rng.normal(size=(2, kc, N)),
             J_p=rng.normal(size=(2, 3, N)), w=rng.random(N) * (1.0 - pad),
             x_r=rng.normal(size=(R, 9, N_COLS)), x_c=rng.normal(size=(n_c, kc, N_COLS)),
             hinv=A @ np.swapaxes(A, -1, -2) + np.eye(3))
    J = {k: jnp.asarray(x) for k, x in a.items()}
    want = [np.stack(w, axis=-1) for w in zip(*(
        [np.asarray(o) for o in jseg.seg_schur_pcg_cal(
            J["J_r"], J["J_c"], J["J_p"], J["w"], dj["_rb_local"], jnp.asarray(cal_local),
            dj["_rg_pt_local"], dj["_rg_hib"], J["x_r"][..., c], J["x_c"][..., c], J["hinv"],
            dj["_rb_base"], dj["_cb_base"], L, info.nt, info.ts, info.rb, info.wb,
            info.prb2 // 128, info.nhg)] for c in range(N_COLS)))]
    p, _ = _full_pair()
    data, _ = _blocked(p)
    plan = trcs.plan_of(data)
    win = cal_local.astype(np.int64)
    arrays = {**tseg.cal_plan_arrays(win, pad, n_c),
              **tseg.pair_plan_arrays(np.asarray(dj["rig"]), win, pad, R, n_c)}
    cplan = tseg.CalPlan(torch.from_numpy(win.astype(np.int32)),
                         *(torch.from_numpy(arrays["_cal_" + f]) for f in tseg.CalPlan._fields[1:]))
    J_r, J_c, J_p, w, x_r, x_c, hinv = (t(x) for x in a.values())
    assert np.any(np.diff(cplan.rig_pair.numpy()) > 1)
    got = _pcg_cal_cols_flow(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan)
    plain = tseg.seg_schur_pcg_cal_cols(J_r, J_c, J_p, w, x_r, x_c, hinv, plan, cplan)
    for g, pl, wj in zip(got, plain, want):
        assert np.abs(wj).max() > 0
        assert rel(g.numpy(), wj) < TOL
        assert rel(pl.numpy(), wj) < TOL
    for c in range(N_COLS):
        single = tseg.seg_schur_pcg_cal(J_r, J_c, J_p, w, x_r[..., c], x_c[..., c], hinv, plan,
                                        cplan)
        for pl, s1 in zip(plain, single):
            assert torch.equal(pl[..., c], s1)


@pytest.mark.parametrize("problem", ["bias", "full_sensor"])
def test_point_sorted_records_are_the_slots_in_point_order(problem):
    """segments.point_sorted_records on the tiny bias-only and full-sensor
    batches (float32, random J and weights): record j holds real slot
    pt_obs[j]'s Jacobian columns as (row 0, row 1) pairs, w, and its rig,
    window and point rows as int32 bits, in rec_layout's places, zeros in
    the padding; no pad slot appears; rig_pos names each slot's record in
    the rig pass's order (rig_obs, or pair_obs with a window plan);
    rig_sorted holds, and fails once a landmark's list is reversed."""
    p = port_full_built()[0] if problem == "full_sensor" else port_blocked_problem()
    data, info = _blocked(p)
    plan = trcs.plan_of(data)
    cplan = trcs.cal_plan_of(data, info) if problem == "full_sensor" else None
    n = data["_pad"].shape[0]
    rng = np.random.default_rng(251)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape)).float()

    k, kc = 9, (23 if cplan is not None else 0)
    J_r, J_p, w = f32(2, k, n), f32(2, 3, n), torch.from_numpy(rng.random(n)).float()
    J_c = f32(2, kc, n) if kc else None
    rec = tseg.point_sorted_records(J_r, J_p, w, plan, J_c, cplan)
    lay = tseg.rec_layout(k, kc)
    real = plan.pt_obs.long()
    pad = data["_pad"].numpy() > 0.5
    assert not pad[real.numpy()].any() and len(real) == int((~pad).sum())
    assert rec.rec.shape == (len(real), lay["floats"]) and lay["floats"] % 4 == 0
    assert (rec.k, rec.kc) == (k, kc)
    r = rec.rec
    for name, J, width in (("jr", J_r, k), ("jc", J_c, kc), ("jp", J_p, 3)):
        for a in range(width):
            for d in range(2):
                assert torch.equal(r[:, lay[name] + 2 * a + d], J[d, a, real])
    assert torch.equal(r[:, lay["w"]], w[real])
    ints = r[:, lay["rig"]:lay["point"] + 1].contiguous().view(torch.int32)
    win = cplan.win if cplan is not None else torch.zeros_like(plan.rig)
    for i, rows in enumerate((plan.rig, win, plan.point)):
        assert torch.equal(ints[:, i], rows[real])
    assert not r[:, lay["point"] + 1:].any()
    order = plan.rig_obs if cplan is None else cplan.pair_obs
    assert torch.equal(rec.rig_pos, plan.pt_pos[order.long()])
    assert torch.equal(real[rec.rig_pos.long()], order.long())
    # the blocked batches keep each landmark's slots in rig order; a plan
    # whose landmark lists run against it is flagged
    assert rec.rig_sorted
    ptr = plan.pt_ptr.tolist()
    a, b = next((a, b) for a, b in zip(ptr[:-1], ptr[1:])
                if len(set(plan.rig[plan.pt_obs[a:b].long()].tolist())) > 1)
    obs = plan.pt_obs.clone()
    obs[a:b] = obs[a:b].flip(0)
    assert not tseg.point_sorted_records(J_r, J_p, w, plan._replace(pt_obs=obs), J_c,
                                         cplan).rig_sorted
    with pytest.raises(ValueError, match="float32"):
        tseg.point_sorted_records(J_r.double(), J_p.double(), w.double(), plan)


def _butterfly(parts):
    """group_sum's xor butterfly over len(parts) lanes (float32): lane 0's
    total."""
    acc = list(parts)
    off = len(acc) // 2
    while off:
        acc = [np.float32(acc[i] + acc[i ^ off]) for i in range(len(acc))]
        off //= 2
    return acc[0]


def _rev(k, bits):
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _leaf_tree(G, P, vals, chunk):
    """The rig passes' in-thread order for a G-lane group at P physical lanes
    (csrc/pt_segments.cuh entry_slot, LeafTree): physical lane phi takes the
    classes phi + P m, m < M = G / P, depth first (m = rev(k)), each class's
    slots t = 0 .. T - 1 in order; the steps s = k T + t run in chunks of
    `chunk` steps, a class's partial carried across a chunk's end, merged
    like a binary counter when its last step is done; then the butterfly
    over the P lanes."""
    M, n = G // P, len(vals)
    bits = M.bit_length() - 1
    T = -(-n // G)
    totals = []
    for phi in range(P):
        st, acc, total = [None] * max(bits, 1), np.float32(0.0), np.float32(0.0)
        for s0 in range(0, M * T, chunk):
            s1 = min(M * T, s0 + chunk)
            for k in range(M):
                ta, tb = max(0, s0 - k * T), min(T, s1 - k * T)
                if ta >= tb:
                    continue
                cls = phi + P * _rev(k, bits)
                if ta == 0:
                    acc = np.float32(0.0)
                for t_ in range(ta, tb):
                    if cls + G * t_ < n:
                        acc = np.float32(acc + vals[cls + G * t_])
                if tb == T:
                    v, lvl = acc, 0
                    while lvl < bits and (k >> lvl) & 1:
                        v = np.float32(st[lvl] + v)
                        lvl += 1
                    if lvl < bits:
                        st[lvl] = v
                    total = v
        totals.append(total)
    return _butterfly(totals)


def _class_registers(G, P, vals):
    """The landmark pass's in-thread order (csrc/pt_segments.cuh
    point_pass_cols): physical lane phi walks its slots in order, class
    phi + P m in accumulator m; the M accumulators merge in the butterfly's
    tree (m and m + h, h = M / 2 .. 1), then the butterfly over the P
    lanes."""
    M = G // P
    totals = []
    for phi in range(P):
        acc = [np.float32(0.0)] * M
        for j in range(phi, len(vals), P):
            m = (j // P) % M
            acc[m] = np.float32(acc[m] + vals[j])
        h = M // 2
        while h:
            acc = [np.float32(acc[m] + acc[m + h]) for m in range(h)] + acc[h:]
            h //= 2
        totals.append(acc[0])
    return _butterfly(totals)


@pytest.mark.parametrize("G,P", [(16, 16), (16, 2), (16, 1), (32, 32), (32, 4), (32, 1)])
def test_in_thread_orders_keep_the_butterfly_bits(G, P):
    """The orders the column kernels sum in one thread give the bits of
    group_sum's butterfly over the same lane classes, in float32: the rig
    passes' depth-first merge (LeafTree) with the steps in one chunk or cut
    into chunks of 1, 3 and 7 steps (a class's slots split across chunks),
    and the landmark pass's class accumulators, for segments of 0 to 300
    entries."""
    rng = np.random.default_rng(G * 100 + P)
    for n in (0, 1, 5, G, 3 * G + 7, 300):
        vals = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, size=n)).astype(np.float32)
        parts = []
        for cls in range(G):
            s_ = np.float32(0.0)
            for j in range(cls, n, G):
                s_ = np.float32(s_ + vals[j])
            parts.append(s_)
        want = _butterfly(parts).tobytes()
        for chunk in (1, 3, 7, 10 ** 6):
            assert _leaf_tree(G, P, vals, chunk).tobytes() == want, (n, chunk)
        if G == 16:
            assert _class_registers(G, P, vals).tobytes() == want, n


# (the rig pass's single-column warps, entries a chunk) by kernel and
# columns a tile (csrc/schur.cu RowCols, csrc/cal_pcg_cols.cuh CalCols)
_CHUNK_SHAPES = {("K4", 32): (4, 256), ("K4", 8): (4, 256), ("K4", 1): (4, 256),
                 ("K9", 32): (1, 96), ("K9", 8): (1, 192), ("K9", 1): (1, 256)}


@pytest.mark.parametrize("kernel,W", sorted(_CHUNK_SHAPES))
def test_rig_pass_chunks_cover_each_slot_once(kernel, W):
    """The column rig passes' chunks (csrc/pt_segments.cuh entry_slot): for
    segments of 1 to 20,000 slots, each chunk's entries e = ((s - s0) NWG +
    wg) P + phi fit its tile, name every slot of the segment once over the
    chunks, and the phase-2 walk of warp-group wg and lane phi finds each of
    its class's slots t at the entry the chunk staged it in."""
    NWG, SE = _CHUNK_SHAPES[(kernel, W)]
    P, M = 32 // W, W
    bits = M.bit_length() - 1
    NS = SE // (NWG * P)
    assert NS >= 1
    for n in (1, 31, 33, 200, 291, 3000, 20000):
        T = -(-n // (32 * NWG))
        seen = {}
        for s0 in range(0, M * T, NS):
            s1 = min(M * T, s0 + NS)
            n_e = (s1 - s0) * NWG * P
            assert n_e <= SE
            for e in range(n_e):
                phi, wg, s_ = e % P, (e // P) % NWG, s0 + e // (P * NWG)
                k, t_ = divmod(s_, T)
                i = 32 * wg + phi + P * _rev(k, bits) + 32 * NWG * t_
                if i < n:
                    assert i not in seen
                    seen[i] = (s0, e)
            for wg in range(NWG):
                for phi in range(P):
                    for k in range(M):
                        cls = 32 * wg + phi + P * _rev(k, bits)
                        for t_ in range(max(0, s0 - k * T), min(T, s1 - k * T)):
                            if cls + 32 * NWG * t_ < n:
                                e = ((k * T + t_ - s0) * NWG + wg) * P + phi
                                assert seen[cls + 32 * NWG * t_] == (s0, e)
        assert sorted(seen) == list(range(n))


def _split_tree(parts):
    """The column K9's rig pass at 32 columns (csrc/cal_pcg_cols.cuh
    rig_split_pass_cols): warp w holds the classes w + 8 j, merged in the
    warp (j and j + 2, then the two), then the warps' subtrees (w and w + 4,
    w and w + 2, w and w + 1)."""
    sub = [np.float32(np.float32(parts[w] + parts[w + 16])
                      + np.float32(parts[w + 8] + parts[w + 24])) for w in range(8)]
    pair = [np.float32(sub[w] + sub[w + 4]) for w in range(4)]
    quad = [np.float32(pair[w] + pair[w + 2]) for w in range(2)]
    return np.float32(quad[0] + quad[1])


def test_split_rig_pass_keeps_the_butterfly_bits():
    """The class split of the column K9's rig pass (warp w: classes w + 8 j)
    gives the bits of the single-column warp's butterfly over the 32 class
    partials, in float32; its chunk entries e = (s - s0) 8 + w name every
    slot of a pair once for pairs of 1 to 20,000 slots and 16 steps a
    chunk."""
    rng = np.random.default_rng(263)
    for _ in range(50):
        parts = (rng.normal(size=32) * 10.0 ** rng.integers(-4, 5, size=32)).astype(np.float32)
        assert _split_tree(parts).tobytes() == _butterfly(list(parts)).tobytes()
    for n in (1, 31, 33, 291, 3000, 20000):
        T, seen = -(-n // 32), set()
        for s0 in range(0, 4 * T, 16):
            for e in range((min(4 * T, s0 + 16) - s0) * 8):
                w, s_ = e % 8, s0 + e // 8
                k, t_ = divmod(s_, T)
                i = w + 8 * _rev(k, 2) + 32 * t_
                if i < n:
                    assert i not in seen
                    seen.add(i)
        assert seen == set(range(n))
