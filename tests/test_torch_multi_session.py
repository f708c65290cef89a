"""The port's multi-session layer (pipeline/multi_session.py and the factor
kind `base_map_visual`) against the JAX package, float64 on the CPU.

Two tiny sessions (tests/test_multi_session.py's `_mk` sizes: 1.6 s at
5 Hz, 30 landmarks, built once by the port's builder and given to both
packages as their own Problems), two point matches and a base map of three
constant keyrigs observing merged landmarks 0, 5 and 7:

  * `base_map_visual`'s residual and Jacobian at a moved state equal the
    JAX `factors.linearize_batch`'s within 1e-9;
  * `merge_sessions` gives the JAX merge's variable and mask tables, every
    batch's arrays (index arrays exactly), `point_map`, `rig_offset` and
    `point_offset` exactly, and the merged points within 1e-12;
  * one LM attempt on the merged problem (damping 1e-4, 40 PCG iterations,
    the identity preconditioner: the JAX block-Jacobi inverses take a minute
    to compile on the CPU): unblocked (the generic engine), and with the merged
    problem blocked by `finalize_blocks(rb=8, prb=16, ts=16)` (ts = 16: a
    `_mk` session's 68-77 observations are below 4 x 64), where both
    packages route each visual batch alike (rig-only single-pass), the PCG
    takes the two-pass route (two blocked batches beside the point-coupled
    base map) and the port runs its plain K5 / K6: new cost and step within
    1e-8 relative of the JAX package's blocked attempt (its unblocked one
    agrees with it to 1e-14);
  * an already-blocked input: the JAX merge keeps the second session's tile
    bases unshifted (its blocked rows address the first session's rigs), the
    port raises ValueError;
  * chip_smoke's multi path at the tiny size (port only): the tiny
    rolling-shutter and global-shutter recordings of one session merged,
    both batches calibration-coupled single-pass, the PCG on the two-pass
    route with K10's plain down and up once per batch and matvec.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import (BLOCKS, F64, FULL_BLOCKS, jax_active_cfgs, port_merge_inputs,
                                  rel, t, to_numpy)

from visual_inertial_bundle_adjustment_tpu.ops import camera as jcam
from visual_inertial_bundle_adjustment_tpu.pipeline import multi_session as jms
from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu.problem import optimizer as jopt
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch import interop
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tb
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import multi_session as tms
from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.problem import engine as teng
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as tfct
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

LAM = 1e-4
PCG_ITERS = 40
MATCHES = [(0, 0, 1, 0), (0, 1, 1, 1)]
# the `_mk` sessions hold 68-77 visual observations each, below the blocking
# threshold of 4 x ts at BLOCKS' ts = 64: blocked at ts = 16 (five tiles each)
TINY_BLOCKS = dict(BLOCKS, ts=16)


@functools.lru_cache(maxsize=None)
def _jax_session(seed):
    """(session, JAX Problem) of one tiny session: built by the port's
    builder (float64, the JAX builder's problem, tests/test_torch_build.py)
    and handed to the JAX package as its own tables and batches (the JAX
    builder's eager first call costs ~14 s on the CPU)."""
    s = SyntheticSession(duration=1.6, keyframe_hz=5.0, num_points=30, seed=seed,
                         pixel_noise=0.2)
    pt = tb.build_synthetic_problem(s, tb.BuildOptions(
        init_pose_noise=0.002, init_point_noise=0.01, init_vel_noise=0.02,
        estimate_gravity=False), device="cpu", dtype=F64)
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    p = jopt.Problem(jst.VariableTables(*(j(a) for a in pt.variables)),
                     jst.Masks(*(j(a) for a in pt.masks)))
    for cfg, data in zip(pt.cfgs, pt.datas):
        p.add_batch(jfct.BatchCfg(**{f: getattr(cfg, f) for f in (
            "kind", "loss", "camera_kind", "label", "image_height")}),
            {k: j(a) for k, a in data.items()})
    return s, p


def _port(p):
    return interop.problem_from_numpy(**to_numpy(p), device="cpu", dtype=F64)


def _base_map_arrays(points, s, rows, seed):
    """Constant keyrigs 3 m behind each listed landmark, looking at it, with
    the observation moved by up to 0.5 px."""
    rng = np.random.default_rng(seed)
    n = len(rows)
    q_cw = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    t_cw = -points[rows] + np.asarray([0.0, 0.0, 3.0]) + rng.normal(scale=0.2, size=(n, 3))
    intr = np.tile(np.asarray(s.camera_params), (n, 1))
    uv, ok = jcam.project(jcam.KIND_FISHEYE624, jnp.asarray(intr), jnp.asarray(
        points[rows] + t_cw))
    assert bool(np.all(ok))
    uv = np.asarray(uv) + rng.uniform(-0.5, 0.5, size=(n, 2))
    sqrt_h = np.broadcast_to(np.eye(2) * 0.7, (n, 2, 2)).copy()
    return np.asarray(rows), q_cw, t_cw, intr, uv, sqrt_h


@functools.lru_cache(maxsize=None)
def _merged():
    """(JAX merge, port merge, their inputs) of the two tiny sessions with
    the two matches and a base map of three keyrigs on merged landmarks 0,
    5 and 7."""
    s1, p1 = _jax_session(41)
    _, p2 = _jax_session(42)
    pre = jms.merge_sessions([p1, p2], point_matches=MATCHES)
    arrays = _base_map_arrays(np.asarray(pre.problem.variables.points), s1, [0, 5, 7], 11)
    mj = jms.merge_sessions([p1, p2], point_matches=MATCHES, extra_batches=[
        jms.make_base_map_batch(*arrays, jcam.KIND_FISHEYE624)])
    mt = tms.merge_sessions([_port(p1), _port(p2)], point_matches=MATCHES, extra_batches=[
        tms.make_base_map_batch(*arrays, tfct.cam_ops.KIND_FISHEYE624, device="cpu",
                                dtype=F64)])
    return mj, mt


def test_base_map_factor_matches_jax():
    s, p = _jax_session(41)
    v = p.variables
    rng = np.random.default_rng(5)
    rows = rng.integers(0, v.points.shape[0], 12)
    cfg_j, data_j = jms.make_base_map_batch(*_base_map_arrays(np.asarray(v.points), s, rows, 6),
                                            jcam.KIND_FISHEYE624)
    moved = np.asarray(v.points) + rng.normal(scale=0.05, size=v.points.shape)
    v_j = v._replace(points=jnp.asarray(moved))
    lin_j = jax.jit(lambda d, vv: jfct.linearize_batch(cfg_j, d, vv, p.masks))(data_j, v_j)
    pt = _port(p)
    v_t = pt.variables._replace(points=t(moved))
    cfg_t, data_t = tms.make_base_map_batch(*_base_map_arrays(np.asarray(v.points), s, rows, 6),
                                            tfct.cam_ops.KIND_FISHEYE624, device="cpu",
                                            dtype=F64)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    lin_t = tfct.linearize_batch(cfg_t, data_t, v_t, pt.masks)
    assert lin_t.groups == tuple(lin_j.groups) == ("points",)
    assert rel(lin_t.res.numpy(), lin_j.res) < 1e-9
    assert rel(lin_t.jac[0].numpy(), lin_j.jac[0]) < 1e-9
    np.testing.assert_array_equal(lin_t.valid.numpy(), np.asarray(lin_j.valid))
    np.testing.assert_array_equal(lin_t.idx[0].numpy(), np.asarray(lin_j.idx[0]))
    res_t, _ = tfct.residual_batch(cfg_t, data_t, v_t)
    assert rel(res_t.T.numpy(), lin_j.res) < 1e-9


def test_merge_matches_jax():
    mj, mt = _merged()
    pj, pt = mj.problem, mt.problem
    for f in pj.variables._fields:
        a, b = getattr(pt.variables, f).numpy(), np.asarray(getattr(pj.variables, f))
        if f == "points":
            assert rel(a, b) < 1e-12
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in pj.masks._fields:
        np.testing.assert_array_equal(getattr(pt.masks, f).numpy(),
                                      np.asarray(getattr(pj.masks, f)), err_msg=f)
    np.testing.assert_array_equal(mt.point_map, mj.point_map)
    assert mt.rig_offset == mj.rig_offset and mt.point_offset == mj.point_offset
    assert pt.variables.points.shape[0] == sum(
        _jax_session(s)[1].variables.points.shape[0] for s in (41, 42)) - len(MATCHES)
    assert [c.kind for c in pt.cfgs] == [c.kind for c in pj.cfgs]
    assert pt.cfgs[-1].kind == "base_map_visual"
    for ct, cj, dt, dj in zip(pt.cfgs, pj.cfgs, pt.datas, pj.datas):
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert set(dt) == set(dj), ct.kind
        for k, a in dj.items():
            np.testing.assert_array_equal(dt[k].numpy(), np.asarray(a), err_msg=f"{ct.kind}.{k}")
            if not np.issubdtype(np.asarray(a).dtype, np.floating):
                assert dt[k].dtype == torch.int32, (ct.kind, k)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """One LM attempt of the JAX package on the merged problem blocked by
    TINY_BLOCKS (new cost, x_r, x_l, (routes, rest_pt), old cost). Its
    unblocked attempt (the generic engine) gives the same cost to 1e-14, so
    this one attempt is the reference of both port attempts. The new cost is
    the jitted linearize's at the new state: the same factors are valid at
    both states, so it equals comparable_cost's (the port's), and it costs
    no second compile."""
    pj = _fresh_jax_merge()
    jrcs.finalize_blocks(pj, **TINY_BLOCKS)
    cfgs = jax_active_cfgs(pj)
    datas, v, m = tuple(pj.datas), pj.variables, pj.masks
    lin = jax.jit(lambda d, vv, mm: jeng.linearize(cfgs, d, vv, mm))
    routes = []

    def solve(d, lg, vv, mm):
        asm = jrcs.assemble(cfgs, d, lg, vv, mm)
        x_r, x_l, _, _, _, rs, _ = jrcs.solve_assembled(asm, vv, mm, LAM, PCG_ITERS, 1e-10,
                                                        "identity")
        routes.append(([_route(jrcs, b) for b in rs.vis], bool(rs.rest_pt.lins)))
        return x_r, x_l, jst.retract(vv, jst.t_scale(x_r, -1.0), -x_l, mm)

    lg = lin(datas, v, m)
    x_r, x_l, v_new = jax.jit(solve)(datas, lg, v, m)
    new = lin(datas, v_new, m)
    assert all(np.array_equal(a, b) for a, b in zip(lg.valid0, new.valid0))
    return pj, (float(new.cost), x_r, x_l, routes[0], float(lg.cost))


def _fresh_jax_merge():
    """The JAX merge of _merged() as a new Problem (finalize_blocks mutates
    its argument), its base-map batch a copy of the dict: the JAX
    Problem._build adds the transpose plans (`_ell*`) into its batches'
    dicts, and a caller that builds the fresh merge (tests/test_torch_bf16.py)
    must not add them to _merged()'s, which test_merge_matches_jax compares
    key for key."""
    mj, _ = _merged()
    return jms.merge_sessions(
        [_jax_session(41)[1], _jax_session(42)[1]], point_matches=MATCHES,
        extra_batches=[(mj.problem.cfgs[-1], dict(mj.problem.datas[-1]))]).problem


def _port_attempt(p):
    ks = p._build()
    datas, v, m = tuple(p.datas), p.variables, p.masks
    lg = ks[0](datas, v, m, None)
    asm = ks[6](datas, lg, v, m)
    out = ks[7](asm, datas, lg, v, m, LAM, PCG_ITERS, 1e-10, "identity")
    routes = None
    if asm is not None:
        rs = out[5]
        routes = [_route(trcs, b) for b in rs.vis], bool(rs.rest_pt.lins)
    return float(out[9].cost), out[0], out[1], routes, float(lg.cost)


def _route(mod, b):
    if mod._rig_only_fast(b):
        return "rig-only single-pass"
    return "calibration-coupled single-pass" if mod._cal_fast(b) else "general"


def _same_step(port, jax_, tol):
    cost_t, xr_t, xl_t = port[:3]
    cost_j, xr_j, xl_j = jax_[:3]
    assert abs(cost_t - cost_j) <= tol * abs(cost_j)
    for f in xr_j._fields:
        assert rel(getattr(xr_t, f).numpy(), np.asarray(getattr(xr_j, f))) < tol, f
    assert rel(xl_t.numpy(), xl_j) < tol


@pytest.mark.parametrize("blocked", [False, True], ids=["unblocked", "blocked"])
def test_one_lm_attempt_on_the_merged_problem_matches_jax(blocked):
    pj, want = _jax_reference()
    p = _port(_fresh_jax_merge())  # the JAX merge handed over, before any blocking
    if blocked:
        trcs.finalize_blocks(p, **TINY_BLOCKS)
        infos_j = [c.block_info for c in pj.cfgs if getattr(c, "block_info", None)]
        infos_t = [c.block_info for c in p.cfgs if c.block_info is not None]
        assert len(infos_t) == 2
        assert [dataclasses.asdict(i) for i in infos_t] == [
            {k: getattr(i, k) for k in dataclasses.asdict(infos_t[0])} for i in infos_j]
    got = _port_attempt(p)
    assert want[3] == (["rig-only single-pass"] * 2, True)  # two passes
    if blocked:
        assert got[3] == want[3]
    else:
        assert got[3] is None and not any(c.block_info is not None for c in p.cfgs)
    _same_step(got, want, 1e-8)
    assert abs(got[4] - want[4]) <= 1e-10 * want[4] and got[0] < got[4]


def test_blocked_inputs_jax_keeps_stale_tiles_port_raises():
    _, p1 = _jax_session(41)
    _, p2 = _jax_session(42)
    b1, b2 = (jms.merge_sessions([p]).problem for p in (p1, p2))  # fresh copies
    for b in (b1, b2):
        jrcs.finalize_blocks(b, **TINY_BLOCKS)
    mj = jms.merge_sessions([b1, b2], point_matches=MATCHES)
    R1 = int(p1.variables.pose_q.shape[0])
    (i1, i2) = [i for i, c in enumerate(mj.problem.cfgs) if getattr(c, "block_info", None)]
    for i, off in ((i1, 0), (i2, R1)):
        d, info = mj.problem.datas[i], mj.problem.cfgs[i].block_info
        real = np.asarray(d["_pad"]) < 0.5
        rig = np.asarray(d["rig"])[real]
        tile_row = (np.repeat(np.asarray(d["_rb_base"]), info.ts)
                    + np.asarray(d["_rb_local"]))[real]
        # the tile plan still addresses the session's own rows: right for the
        # first session, R1 rows short (the first session's rigs) for the second
        np.testing.assert_array_equal(tile_row, rig - off)
    assert R1 > 0
    pb = _port(b2)
    with pytest.raises(ValueError, match="already blocked"):
        tms.merge_sessions([_port(p1), pb])


def test_tiny_recordings_merged_take_the_two_pass_route(monkeypatch):
    """chip_smoke's multi path at the tiny size, float64 on the CPU: the
    rolling-shutter and global-shutter recordings of one session merged
    (every landmark matched by point id, a base map at every 10th rig),
    blocked with ts = 64: both batches are calibration-coupled single-pass,
    the PCG takes the two-pass route with K10's plain down and up once per
    batch and matvec (and never K9), and one LM attempt repeats bit for bit
    and lowers the cost."""
    problems, matches, bm, n_key = port_merge_inputs()
    merged = tms.merge_sessions(problems, point_matches=matches, extra_batches=[bm])
    p = merged.problem
    v = p.variables
    assert len(matches) == v.points.shape[0] > 0 and n_key == 4
    assert merged.point_offset == [0, len(matches)]
    assert (merged.point_map[len(matches):] == np.arange(len(matches))).all()
    trcs.finalize_blocks(p, **FULL_BLOCKS)
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, v, p.masks, None)
    asm = ks[6](datas, lg, v, p.masks)
    rs = trcs.with_damping(asm, v, p.masks, LAM)
    assert [_route(trcs, b) for b in rs.vis] == ["calibration-coupled single-pass"] * 2
    assert [c.kind for c in p.cfgs if c.block_info is not None] == ["rs_visual", "visual"]
    assert len(rs.rest_pt.lins) == 1 and p.cfgs[-1].kind == "base_map_visual"
    calls = {}
    for name in ("seg_schur_down_cal", "seg_schur_up_cal", "seg_schur_pcg_cal"):
        fn = getattr(tseg, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(tseg, name, counted)
    b = tst.t_sub(asm.g_r, trcs.w_y(rs, v, teng._chol_solve(rs.H_ll_inv, asm.g_l)))
    calls.clear()
    trcs.pcg(rs, v, b, PCG_ITERS, 1e-10)
    assert calls == {"seg_schur_down_cal": 2 * PCG_ITERS, "seg_schur_up_cal": 2 * PCG_ITERS}
    one, two = _port_attempt(p), _port_attempt(p)
    assert one[0] == two[0] and torch.equal(one[2], two[2])
    assert all(torch.equal(a, c) for a, c in zip(one[1], two[1]))
    assert one[0] < one[4]
