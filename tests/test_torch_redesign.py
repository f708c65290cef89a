"""The plans and the data flow of the redesigned K4, K9, K13a and K13c, on
the CPU.

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
  * K8's window flow (cal_segments.cu: a chunk's slots in 128-slot steps,
    the outputs cut into 3x3 items each owned by one warp, a lane's 4 slots
    of each step summed in order, the warp's butterfly, the chunks' partial
    rows summed in chunk order into g_c, diag_c and the full split blocks)
    equals the JAX
    package's seg_assemble_cal on its XLA branch at kc 6, 17 and 23 (chunks
    of 1,024 and of 300 slots) within 1e-9;
  * the full blocks that K2, K3 and K8's sum pass write from their upper
    triangles (the index arithmetic of each kernel, written out) equal
    segments._tri_to_full at k 3, 6, 9 and 17.
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


@pytest.mark.parametrize("kc", [6, 17, 23])
def test_pcg_cal_flow_matches_jax(kc):
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
    rng = np.random.default_rng(79)
    A = rng.normal(size=(L, 3, 3))
    a = dict(J_r=rng.normal(size=(2, 9, N)), J_c=rng.normal(size=(2, kc, N)),
             J_p=rng.normal(size=(2, 3, N)), w=rng.random(N) * (1.0 - pad),
             x_r=rng.normal(size=(R, 9)), x_c=rng.normal(size=(n_c, kc)),
             hinv=A @ np.swapaxes(A, -1, -2) + np.eye(3))
    J = {k: jnp.asarray(x) for k, x in a.items()}
    want = jseg.seg_schur_pcg_cal(
        J["J_r"], J["J_c"], J["J_p"], J["w"], dj["_rb_local"], jnp.asarray(cal_local),
        dj["_rg_pt_local"], dj["_rg_hib"], J["x_r"], J["x_c"], J["hinv"], dj["_rb_base"],
        dj["_cb_base"], L, info.nt, info.ts, info.rb, info.wb, info.prb2 // 128, info.nhg)
    p, _ = _full_pair()
    data, _ = _blocked(p)
    plan = trcs.plan_of(data)
    win = cal_local.astype(np.int64)
    arrays = {**tseg.cal_plan_arrays(win, pad, n_c),
              **tseg.pair_plan_arrays(np.asarray(dj["rig"]), win, pad, R, n_c)}
    cplan = tseg.CalPlan(torch.from_numpy(win.astype(np.int32)),
                         *(torch.from_numpy(arrays["_cal_" + f]) for f in tseg.CalPlan._fields[1:]))
    assert np.any(np.diff(cplan.rig_pair.numpy()) > 1)
    args = {k: t(x) for k, x in a.items()}
    got = _pcg_cal_flow(*args.values(), plan, cplan)
    plain = tseg.seg_schur_pcg_cal(*args.values(), plan, cplan)
    for g, pl, wj in zip(got, plain, want):
        assert np.abs(np.asarray(wj)).max() > 0
        assert rel(g.numpy(), wj) < TOL
        assert rel(pl.numpy(), wj) < TOL


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


@pytest.mark.parametrize("k", [6, 9])
def test_schur_pcg_flow_matches_jax(k):
    pj = jax_problem()
    (vi,) = [i for i, c in enumerate(pj.cfgs) if getattr(c, "block_info", None)]
    dj, info = pj.datas[vi], pj.cfgs[vi].block_info
    R, L = pj.variables.pose_q.shape[0], pj.variables.points.shape[0]
    rig, point = np.asarray(dj["rig"]), np.asarray(dj["point"])
    pad = np.asarray(dj["_pad"]).copy()
    N = pad.shape[0]
    # two rigs and two observed landmarks lose their slots: zero weights for
    # the JAX entry, pads for the port's plan
    empty_rigs = np.unique(rig[pad < 0.5])[[1, -2]]
    empty_pts = np.unique(point[pad < 0.5])[[2, 7]]
    pad[np.isin(rig, empty_rigs) | np.isin(point, empty_pts)] = 1.0
    rng = np.random.default_rng(107 + k)
    A = rng.normal(size=(L, 3, 3))
    a = dict(J_r=rng.normal(size=(2, k, N)), J_p=rng.normal(size=(2, 3, N)),
             w=rng.random(N) * (1.0 - pad), x=rng.normal(size=(R, k)),
             hinv=A @ np.swapaxes(A, -1, -2) + np.eye(3))
    J = {key: jnp.asarray(v) for key, v in a.items()}
    want = np.asarray(jseg.seg_schur_pcg(
        J["J_r"], J["J_p"], J["w"], dj["_rb_local"], dj["_rg_pt_local"], dj["_rg_hib"], J["x"],
        J["hinv"], dj["_rb_base"], L, info.nt, info.ts, info.rb, info.prb2 // 128, info.nhg))
    arrays = trcs.segment_plan(rig, point, pad, R, L)
    plan = tseg.SegPlan(t(rig.astype(np.int32)), t(point.astype(np.int32)),
                        *(t(arrays[key]) for key in ("_rig_ptr", "_rig_obs", "_pt_ptr",
                                                     "_pt_obs", "_pt_pos")))
    assert np.all(np.diff(arrays["_rig_ptr"])[empty_rigs] == 0)
    assert np.all(np.diff(arrays["_pt_ptr"])[empty_pts] == 0)
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
    """cal_segments.cu tri_index: (a, b), a <= b, in a row-major upper triangle."""
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
    triangles: K3 walks the triangle row by row and stores each entry at
    (a, b) and (b, a) (precond_rig.cu); K8's sum pass reads entry (a, b)
    at tri_index(min, max) (cal_segments.cu sum_cal); K2 maps the 3x3
    block through kTri (assemble_rig.cu)."""
    n = 5
    tri = torch.from_numpy(np.random.default_rng(157 + k).normal(size=(n, k * (k + 1) // 2)))
    want = tseg._tri_to_full(tri, k)
    k3 = tri.new_empty((n, k, k))
    m = 0
    for a in range(k):
        for b in range(a, k):
            k3[:, a, b] = k3[:, b, a] = tri[:, m]
            m += 1
    k8 = tri[:, torch.tensor([[_tri_index(min(a, b), max(a, b), k) for b in range(k)]
                              for a in range(k)])]
    assert torch.equal(k3, want) and torch.equal(k8, want)
    if k == 3:
        assert torch.equal(tri[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(n, 3, 3), want)
