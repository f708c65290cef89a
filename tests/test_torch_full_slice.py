"""The port's full-sensor LM slice vs the JAX package, end to end on the tiny
full-sensor problem (float64, CPU): two IMUs, a rolling-shutter camera with
readout and time offset estimated, two calibration windows, blocked by
finalize_blocks(ts=64) so the calibration-coupled single-pass engine
(K8-K10 plain versions, K3 at rig_k = 9) runs.

  * interop.problem_from_numpy carries the window plan and the RS tables;
  * linearize + assemble agree to 1e-10 (rig, window, IMU and landmark
    gradients, diagonals, the window block-Jacobi blocks);
  * solve_assembled at lambda = 1e-4 (x_r, x_l, model_red) to 1e-8;
  * optimize() for 3 LM iterations tracks the JAX cost sequence within 1e-6;
  * the pre-step RS-table refresh equals the JAX adapter's at a changed
    calibration.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch
from _torch_port_fixtures import (jax_active_cfgs, jax_full, port_full_built,
                                  port_full_from_jax, rel, to_numpy)

from visual_inertial_bundle_adjustment_tpu.problem import optimizer as jopt
from visual_inertial_bundle_adjustment_tpu_torch.problem import optimizer as topt
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

LAM = 1e-4
PCG_ITERS = 40


def _fields(a, b, tol, what):
    for f in b._fields:
        x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        assert float(np.abs(x - y).max(initial=0.0)) <= tol * max(float(np.abs(y).max(
            initial=0.0)), 1e-300), (what, f)


def test_interop_carries_the_window_plan_and_rs_tables():
    src = to_numpy(jax_full()[0])
    p = port_full_from_jax()
    (i,) = [i for i, c in enumerate(p.cfgs) if c.block_info is not None]
    assert p.cfgs[i].block_info.wb == src["cfgs"][i]["block_info"]["wb"] > 0
    for k in ("_cb_local", "_cb_base"):
        np.testing.assert_array_equal(p.datas[i][k].numpy(), src["datas"][i][k])
    tab = p.datas[i]["rs_tables"]
    for f in tab._fields:
        np.testing.assert_array_equal(getattr(tab, f).numpy(), src["datas"][i]["rs_tables"][f])
    assert trcs.cal_plan_of(p.datas[i], p.cfgs[i].block_info) is not None


@functools.lru_cache(maxsize=None)
def _jax_linearized():
    pj, _ = jax_full()
    pj._build()
    datas = tuple(pj.datas)
    k_lin, k_asm = pj._jits[0], pj._jits[6]
    lg = k_lin(datas, pj.variables, pj.masks, None)
    return pj, lg, k_asm(datas, lg, pj.variables, pj.masks)


@functools.lru_cache(maxsize=None)
def _port_linearized():
    p = port_full_from_jax()
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    return p, lg, ks[6](datas, lg, p.variables, p.masks)


def test_linearize_and_assemble_match_jax():
    pj, lg_j, asm_j = _jax_linearized()
    p, lg_t, asm_t = _port_linearized()
    assert [c.active_groups for c in p.active_cfgs] == [c.active_groups
                                                        for c in jax_active_cfgs(pj)]
    assert rel(lg_t.cost.numpy(), lg_j.cost) < 1e-10
    assert int(lg_t.num_invalid) == int(lg_j.num_invalid)
    (b,) = asm_t.vis
    assert trcs._cal_fast(b) and b.rig_k == 9
    assert rel(asm_t.g_l.numpy(), asm_j.g_l) < 1e-10
    assert rel(asm_t.H_ll0.numpy(), asm_j.H_ll0) < 1e-10
    _fields(asm_t.g_r, asm_j.g_r, 1e-10, "g_r")
    _fields(asm_t.diag_r, asm_j.diag_r, 1e-10, "diag_r")
    for g in ("cam_intr", "cam_extr", "imu_calib", "imu_extr"):
        assert rel(asm_t.blocks0[g].numpy(), asm_j.blocks0[g]) < 1e-10, g


@functools.lru_cache(maxsize=None)
def _jax_step():
    pj, lg, asm = _jax_linearized()
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
    _fields(rs.precond_inv, out_j[5].precond_inv, 1e-8, "precond_inv")


def test_optimize_tracks_jax_cost_sequence():
    pj, _ = jax_full()
    _jax_step()  # compile the carry iteration once (shared with the solve test)
    seq_j, seq_t = [], []
    saved = pj.variables
    try:
        sj = jopt.optimize(pj, jopt.LMSettings(
            max_iterations=3, direct_mode=False, pcg_max_iterations=PCG_ITERS,
            iteration_callback=lambda d: seq_j.append((d["prev_cost"], d["cost"]))))
    finally:
        pj.variables = saved
    p = port_full_from_jax()
    st = topt.optimize(p, topt.LMSettings(
        max_iterations=3, direct_mode=False, pcg_max_iterations=PCG_ITERS,
        iteration_callback=lambda d: seq_t.append((d["prev_cost"], d["cost"]))))
    assert len(seq_t) == len(seq_j) == 3
    assert rel(np.asarray(seq_t), np.asarray(seq_j)) < 1e-6
    assert abs(st.final_cost - sj.final_cost) <= 1e-6 * abs(sj.final_cost)
    assert st.final_cost < 1e-2 * st.initial_cost
    assert st.num_iterations == sj.num_iterations


def test_rs_table_refresh_matches_jax():
    """update_rolling_shutter_data (the pre-step callback from the second
    iteration on) rebuilds the tables at the current IMU calibration and
    swaps them into the rs_visual batch, as the JAX adapter does."""
    pj, aj = jax_full()
    pt, at = port_full_built()
    rng = np.random.default_rng(9)
    bump = np.zeros(pj.variables.imu_calib.shape)
    bump[:, 0:6] = rng.normal(size=(bump.shape[0], 6)) * 1e-3
    saved = pj.variables, aj._rs_tables, [d.get("rs_tables") for d in pj.datas]
    try:  # the JAX problem is shared by the module: restore it after
        pj.variables = pj.variables._replace(imu_calib=pj.variables.imu_calib + bump)
        aj.problem = pj
        aj.update_rolling_shutter_data()
        tj = aj._rs_tables
    finally:
        pj.variables, aj._rs_tables = saved[0], saved[1]
        for d, tab in zip(pj.datas, saved[2]):
            if tab is not None:
                d["rs_tables"] = tab
    pt.variables = pt.variables._replace(imu_calib=pt.variables.imu_calib + torch.from_numpy(bump))
    at.problem = pt
    cb = at.make_pre_step_callback()
    (i,) = [i for i, c in enumerate(pt.cfgs) if c.kind == "rs_visual"]
    before = pt.datas[i]["rs_tables"]
    cb(0, pt)
    assert pt.datas[i]["rs_tables"] is before  # iteration 0: no refresh
    cb(1, pt)
    assert pt.datas[i]["rs_tables"] is at._rs_tables is not before
    for f in at._rs_tables._fields:
        a, b = getattr(at._rs_tables, f).numpy(), np.asarray(getattr(tj, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        a, b = np.where(np.isfinite(a), a, 0.0), np.where(np.isfinite(b), b, 0.0)
        assert float(np.abs(a - b).max()) <= 1e-9 * max(float(np.abs(b).max()), 1.0), f
