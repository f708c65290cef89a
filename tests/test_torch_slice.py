"""The port's bias-only LM slice vs the JAX package, end to end on the tiny
blocked problem (float64, CPU).

  * interop.problem_from_numpy hands the JAX problem's state over intact;
  * linearize + assemble agree to 1e-10, solve_assembled and solve_step
    (x_r, x_l, model_red) at lambda = 1e-4 to 1e-8;
  * optimize() for 3 LM iterations tracks the JAX cost sequence within 1e-6;
  * pick_solver resolves every solver name as the JAX package does, and
    every preconditioner family converges to the Gauss-Seidel step.

Intended divergences, from fixing the JAX package's queue-C faults (ROADMAP
section C): the port keeps one linearization + assembly across damping
retries and recomputes it only at an accepted point (fault 2; the JAX carry
path pays a discarded one per retry); it has no compile-failure fallback
(fault 1); comparable_from_linearized returns a zero total for empty cfgs
(fault 3); and its new cost is the residual-only pass of comparable_cost,
which equals the JAX carry path's bookkeeping value up to rounding. None of
these changes a value on this problem, so the cost sequences still agree.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import jax_active_cfgs, jax_problem, port_problem, rel, t, to_numpy

from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import optimizer as jopt
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch.problem import engine as teng
from visual_inertial_bundle_adjustment_tpu_torch.problem import optimizer as topt
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

LAM = 1e-4
PCG_ITERS = 40


def _fields(a, b, tol, what):
    for f in b._fields:
        assert rel(getattr(a, f).numpy(), getattr(b, f)) <= tol, (what, f)


def test_interop_round_trip():
    src = to_numpy(jax_problem())
    p = port_problem()
    for f, a in src["variables"].items():
        np.testing.assert_array_equal(getattr(p.variables, f).numpy(), a)
        assert getattr(p.variables, f).dtype == torch.float64
    for f, a in src["masks"].items():
        np.testing.assert_array_equal(getattr(p.masks, f).numpy(), a)
    assert len(p.cfgs) == len(src["cfgs"])
    for c, cd, d, dd in zip(p.cfgs, src["cfgs"], p.datas, src["datas"]):
        assert (c.kind, tuple(c.loss), c.camera_kind) == (cd["kind"], tuple(cd["loss"]),
                                                          cd["camera_kind"])
        for k, a in d.items():
            if k in dd:
                np.testing.assert_array_equal(a.numpy(), dd[k])
            else:
                assert k in ("_rig_ptr", "_rig_obs", "_pt_ptr", "_pt_obs")  # the port's plans
        if cd["block_info"] is not None:
            for f in ("rb", "nt", "ts", "prb", "pnt", "pts", "prb2", "nhg"):
                assert getattr(c.block_info, f) == cd["block_info"][f]
    f32 = port_problem(dtype=torch.float32)
    assert f32.variables.points.dtype == torch.float32
    assert f32.datas[0]["rig"].dtype == torch.int32


@functools.lru_cache(maxsize=None)
def _jax_linearized():
    pj = jax_problem()
    pj._build()
    cfgs = jax_active_cfgs(pj)
    datas = tuple(pj.datas)
    k_lin, k_asm = pj._jits[0], pj._jits[6]
    lg = k_lin(datas, pj.variables, pj.masks, None)
    return pj, cfgs, lg, k_asm(datas, lg, pj.variables, pj.masks)


@functools.lru_cache(maxsize=None)
def _port_linearized():
    p = port_problem()
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    return p, lg, ks[6](datas, lg, p.variables, p.masks)


def test_linearize_and_assemble_match_jax():
    _, _, lg_j, asm_j = _jax_linearized()
    _, lg_t, asm_t = _port_linearized()
    assert rel(lg_t.cost.numpy(), lg_j.cost) < 1e-10
    assert int(lg_t.num_invalid) == int(lg_j.num_invalid)
    assert int(lg_t.num_optional) == int(lg_j.num_optional)
    for lt, lj in zip(lg_t.lins, lg_j.lins):
        assert lt.groups == lj.groups
        assert rel(lt.res.numpy(), lj.res) < 1e-10
        for Jt, Jj in zip(lt.jac, lj.jac):
            assert rel(Jt.numpy(), Jj) < 1e-10
    assert rel(asm_t.g_l.numpy(), asm_j.g_l) < 1e-10
    assert rel(asm_t.H_ll0.numpy(), asm_j.H_ll0) < 1e-10
    _fields(asm_t.g_r, asm_j.g_r, 1e-10, "g_r")
    _fields(asm_t.diag_r, asm_j.diag_r, 1e-10, "diag_r")


@functools.lru_cache(maxsize=None)
def _jax_step():
    """One JAX carry attempt at LAM: (x_r, x_l, model_red, pcg_rel, pcg_it,
    ...). The carry executable is the one optimize() runs, so the optimize
    test below reuses its compilation."""
    pj, _, lg, asm = _jax_linearized()
    out, _, _ = pj._k_carry(tuple(pj.datas), lg, asm, pj.variables, pj.masks, jnp.asarray(LAM),
                            PCG_ITERS, 1e-10, "gauss_seidel")
    return out


def test_solve_assembled_matches_jax():
    out_j = _jax_step()
    p, _, asm = _port_linearized()
    x_r, x_l, model_red, pcg_rel, pcg_it, rs, _ = trcs.solve_assembled(
        asm, p.variables, p.masks, LAM, PCG_ITERS, 1e-10)
    _fields(x_r, out_j[0], 1e-8, "x_r")
    assert rel(x_l.numpy(), out_j[1]) < 1e-8
    assert rel(model_red.numpy(), out_j[2]) < 1e-8
    assert int(pcg_it) == int(out_j[4])
    assert rel(pcg_rel.numpy(), out_j[3]) < 1e-6
    _fields(rs.precond_inv, out_j[5].precond_inv, 1e-8, "precond_inv")


def test_solve_step_matches_jax():
    """The single-shot entry (assemble + solve) on the port's linearization."""
    out_j = _jax_step()
    p, lg, _ = _port_linearized()
    x_r, x_l, model_red, *_ = trcs.solve_step(p.active_cfgs, tuple(p.datas), lg, p.variables,
                                              p.masks, LAM, PCG_ITERS, 1e-10)
    _fields(x_r, out_j[0], 1e-8, "x_r")
    assert rel(x_l.numpy(), out_j[1]) < 1e-8
    assert rel(model_red.numpy(), out_j[2]) < 1e-8


def test_hessian_matvecs_match_jax():
    """engine._hmatvec on the full graph vs the JAX package's, and the
    stacked rest-graph matvec vs _hmatvec restricted to the rest graph."""
    pj, _, lg_j, _ = _jax_linearized()
    p, lg_t, asm = _port_linearized()
    rng = np.random.default_rng(33)
    zt = tst.zero_tangent(p.variables)
    x = {f: rng.normal(size=tuple(getattr(zt, f).shape)) for f in zt._fields}
    xp = rng.normal(size=tuple(p.variables.points.shape))
    x_t = tst.Tangent(**{f: t(a) for f, a in x.items()})
    y_t, yp_t = teng._hmatvec(lg_t, p.variables, x_t, t(xp))
    y_j, yp_j = jeng._hmatvec(lg_j, pj.variables, jst.Tangent(**{f: jnp.asarray(a) for f, a in
                                                                 x.items()}), jnp.asarray(xp))
    _fields(y_t, y_j, 1e-10, "hmatvec")
    assert rel(yp_t.numpy(), yp_j) < 1e-10
    y_rest = trcs.rest_hmatvec(asm.rest_stacks, p.variables, x_t)
    y_ref, _ = teng._hmatvec(asm.rest, p.variables, x_t, torch.zeros_like(p.variables.points))
    _fields(y_rest, y_ref, 1e-12, "rest_hmatvec")


def test_comparable_from_linearized_matches_jax():
    """The carry path's bookkeeping cost at a new point equals the
    residual-only comparable_cost there, and the JAX package's value; empty
    cfgs give a zero total (the JAX package returns None there, queue-C
    fault 3)."""
    pj, cfgs_j, lg_j, _ = _jax_linearized()
    p, lg_t, asm = _port_linearized()
    datas = tuple(p.datas)
    x_r, x_l, *_ = trcs.solve_assembled(asm, p.variables, p.masks, LAM, PCG_ITERS, 1e-10)
    v_new = tst.retract(p.variables, tst.t_scale(x_r, -1.0), -x_l, p.masks)
    lg_new = teng.linearize(p.active_cfgs, datas, v_new, p.masks)
    got = teng.comparable_from_linearized(p.active_cfgs, lg_t, lg_new)
    want = teng.comparable_cost(p.active_cfgs, datas, v_new, lg_t)
    assert rel(got.cost.numpy(), want.cost.numpy()) < 1e-12
    assert int(got.num_invalid) == int(want.num_invalid)
    v_new_j = type(pj.variables)(*(jnp.asarray(a.numpy()) for a in v_new))
    lg_new_j = pj._jits[0](tuple(pj.datas), v_new_j, pj.masks, None)
    ref = jeng.comparable_from_linearized(cfgs_j, lg_j, lg_new_j)
    assert rel(got.cost.numpy(), ref.cost) < 1e-10
    assert float(teng.comparable_from_linearized((), lg_t, lg_new).cost) == 0.0


@pytest.mark.parametrize("precond", ["jacobi", "lower_prec", "identity"])
def test_preconditioners_reach_the_same_step(precond):
    """Every preconditioner family solves the same damped system: run to
    convergence, each step matches the Gauss-Seidel one."""
    p, _, asm = _port_linearized()
    ref = trcs.solve_assembled(asm, p.variables, p.masks, LAM, 2000, 1e-12)
    x_r, x_l, _, pcg_rel, _, rs, _ = trcs.solve_assembled(asm, p.variables, p.masks, LAM, 2000,
                                                          1e-12, precond)
    assert (rs.precond_inv is None) == (precond == "identity")
    assert float(pcg_rel) < 1e-10
    _fields(x_r, tst.Tangent(*(a.numpy() for a in ref[0])), 1e-6, precond)
    assert rel(x_l.numpy(), ref[1].numpy()) < 1e-6


@pytest.mark.parametrize("solver,num_rigs", [
    ("auto", 1200), ("auto", 20000), ("direct", 50000), ("gauss-seidel", 10), ("jacobi", 10),
    ("lower-prec", 10), ("identity", 10)])
def test_pick_solver_matches_jax(solver, num_rigs):
    t_set = topt.pick_solver(topt.LMSettings(), num_rigs, solver)
    j_set = jopt.pick_solver(jopt.LMSettings(), num_rigs, solver)
    assert (t_set.direct_mode, t_set.preconditioner) == (j_set.direct_mode, j_set.preconditioner)


def test_optimize_tracks_jax_cost_sequence():
    pj = jax_problem()
    _jax_step()  # compile the carry iteration once (shared with the solve test)
    seq_j, seq_t = [], []
    saved = pj.variables
    try:
        sj = jopt.optimize(pj, jopt.LMSettings(
            max_iterations=3, direct_mode=False, pcg_max_iterations=PCG_ITERS,
            iteration_callback=lambda d: seq_j.append((d["prev_cost"], d["cost"]))))
    finally:
        pj.variables = saved
    p = port_problem()
    st = topt.optimize(p, topt.LMSettings(
        max_iterations=3, direct_mode=False, pcg_max_iterations=PCG_ITERS,
        iteration_callback=lambda d: seq_t.append((d["prev_cost"], d["cost"]))))
    assert len(seq_t) == len(seq_j) == 3
    assert rel(np.asarray(seq_t), np.asarray(seq_j)) < 1e-6
    assert abs(st.final_cost - sj.final_cost) <= 1e-6 * abs(sj.final_cost)
    assert st.final_cost < 1e-2 * st.initial_cost
    assert st.num_iterations == sj.num_iterations


def test_structure_ops_match_jax():
    """retract, step_to_var_ratios and the packed-state layout."""
    pj = jax_problem()
    p = port_problem()
    rng = np.random.default_rng(31)
    zt = jst.zero_tangent(pj.variables)
    step = {f: rng.normal(size=np.shape(getattr(zt, f))) * 1e-2 for f in zt._fields}
    tj = jst.Tangent(**{f: jnp.asarray(a) for f, a in step.items()})
    tt = tst.Tangent(**{f: t(a) for f, a in step.items()})
    dl = rng.normal(size=pj.variables.points.shape) * 1e-2
    _fields(tst.retract(p.variables, tt, t(dl), p.masks),
            jst.retract(pj.variables, tj, jnp.asarray(dl), pj.masks), 1e-12, "retract")
    for a, b in zip(tst.step_to_var_ratios(p.variables, tt, t(dl)),
                    jst.step_to_var_ratios(pj.variables, tj, jnp.asarray(dl))):
        assert rel(a.numpy(), b) < 1e-12
    counts, dims, K = tst.pack_info(tt)
    assert (counts, dims, K) == tuple(jst.pack_info(tj))
    packed = tst.pack_t(tt, counts, dims, K)
    assert rel(packed.numpy(), jst.pack_t(tj, counts, dims, K)) == 0.0
    _fields(tst.unpack_t(packed, counts, dims, K), tj, 0.0, "unpack")


def test_small_inverses_match_jax():
    """_inv3 on damped landmark blocks; _precond_inv (with its definiteness
    safeguard) on SPD and on indefinite 6x6 blocks."""
    rng = np.random.default_rng(32)
    A = rng.normal(size=(20, 3, 3))
    H3 = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)
    assert rel(teng._inv3(t(H3)).numpy(), jeng._inv3(jnp.asarray(H3))) < 1e-10
    B = rng.normal(size=(12, 6, 6))
    B6 = B @ np.swapaxes(B, -1, -2)
    # four blocks made slightly indefinite: the safeguard's bumps engage
    shift = np.linalg.eigvalsh(B6[:4])[:, 0] + 1e-3 * np.abs(B6[:4]).max(axis=(1, 2))
    B6[:4] -= shift[:, None, None] * np.eye(6)
    assert rel(teng._precond_inv(t(B6)).numpy(), jeng._precond_inv(jnp.asarray(B6))) < 1e-10


def test_unported_batches_raise():
    """Stated limits of the slice: a two-grid (unbounded point window) batch
    and a blocked batch with calibration columns raise NotImplementedError."""
    p, lg, _ = _port_linearized()
    cfgs = p.active_cfgs
    (vi,) = [i for i, c in enumerate(cfgs) if c.block_info is not None]
    two_grid = list(cfgs)
    two_grid[vi] = dataclasses.replace(cfgs[vi], block_info=dataclasses.replace(
        cfgs[vi].block_info, prb2=0, nhg=0))
    with pytest.raises(NotImplementedError):
        trcs._vis_batches(two_grid, tuple(p.datas), lg)
    lin = lg.lins[vi]
    cal = lg._replace(lins=tuple(
        lin._replace(groups=lin.groups + ("cam_intr",)) if i == vi else l_
        for i, l_ in enumerate(lg.lins)))
    with pytest.raises(NotImplementedError):
        trcs._vis_batches(cfgs, tuple(p.datas), cal)


def test_jax_package_untouched_by_port_import():
    """The port imports no JAX: importing it leaves jax's own state alone
    and its modules carry no jax reference."""
    import sys

    import visual_inertial_bundle_adjustment_tpu_torch as port

    pkg = port.__name__ + "."
    for name, mod in list(sys.modules.items()):
        if name.startswith(pkg) and mod is not None:
            assert not any(getattr(v, "__name__", "").startswith("jax")
                           for v in vars(mod).values() if type(v).__name__ == "module"), name
    assert jax.config.jax_enable_x64
