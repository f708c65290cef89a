"""The port's global-shutter calibration path vs the JAX package (float64, CPU).

The session is the tiny full-sensor one written with `readout_time_sec=None`
(a global-shutter camera) and built by both packages' adapters with their
default options, which estimate the camera intrinsics and extrinsics in 5 s
windows: one blocked `visual` batch with point + rig + cam_extr + cam_intr
active, tiled by `finalize_blocks(ts=64)`. The JAX package linearizes it with
its calibration-coupled Pallas kernel on the TPU and, on the CPU, with the
generic AD linearizer; the port with K11, whose plain version (the chain rule
written out as in the CUDA kernel) runs here.

  * K11's plain version vs the JAX generic linearizer: 1e-9 relative to the
    max-abs, masks applied, validity equal, padded slots excluded;
  * both adapters build the same batches and observation count;
  * linearize + assemble 1e-10, solve_assembled at lambda = 1e-4 1e-8, the
    3-iteration optimize() cost sequence 1e-6 (the calibration-coupled
    single-pass engine at rig_k = 6);
  * with `use_detector_bias=True` the batch carries a fourth group and both
    packages take their general path: matvec, W y and W^T x 1e-10, and the
    port's result is bit-equal from call to call;
  * a batch with only the intrinsics estimated: both packages fold the lone
    group into their window kernels (the port's K8-K10 at kc = 17): the same
    assembly and matvec, 1e-10.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_port_fixtures import (jax_active_cfgs, jax_gs, port_gs_built, port_gs_from_jax, rel,
                                  t)

from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu.problem import optimizer as jopt
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels, visual_fused
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as tfct
from visual_inertial_bundle_adjustment_tpu_torch.problem import optimizer as topt
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

TOL = 1e-9
LAM = 1e-4
PCG_ITERS = 40
CAL_GROUPS = ("points", "rig", "cam_extr", "cam_intr")


def _fields(a, b, tol, what):
    for f in b._fields:
        x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        assert float(np.abs(x - y).max(initial=0.0)) <= tol * max(float(np.abs(y).max(
            initial=0.0)), 1e-300), (what, f)


def _blocked(p):
    (i,) = [i for i, c in enumerate(p.cfgs) if getattr(c, "block_info", None)]
    return i


def _random_tangent(v, seed):
    rng = np.random.default_rng(seed)
    zt = tst.zero_tangent(v)
    return {f: rng.normal(size=tuple(getattr(zt, f).shape)) for f in zt._fields}


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------


def test_visual_cal_linearize_plain_matches_jax():
    pj, _ = jax_gs()
    i = _blocked(pj)
    cfg = jax_active_cfgs(pj)[i]
    assert cfg.kind == "visual" and cfg.active_groups == CAL_GROUPS
    lin = jax.jit(lambda d, v, m: jfct.linearize_batch(cfg, d, v, m))(
        pj.datas[i], pj.variables, pj.masks)
    assert lin.groups == CAL_GROUPS
    p = port_gs_from_jax()
    data = p.datas[i]
    real = data["_pad"].numpy() < 0.5
    res, valid, J_pt, J_r, J_cal = visual_fused.visual_cal_linearize(
        p.cfgs[i].camera_kind, data, p.variables, p.masks)
    assert J_r.shape[1] == 12 and J_cal.shape[1] == 23
    assert rel(res.numpy()[:, real], np.asarray(lin.res)[:, real]) < TOL
    np.testing.assert_array_equal(valid.numpy(), np.asarray(lin.valid))
    for got, want in ((J_pt, lin.jac[0]), (J_r, lin.jac[1]), (J_cal[:, :6], lin.jac[2]),
                      (J_cal[:, 6:], lin.jac[3])):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        assert rel(got.numpy()[..., real], want[..., real]) < TOL
    assert float(J_r[:, 6:].abs().max()) == 0.0
    # the masks are applied per column: the unmasked Jacobian times each
    # observation's mask row is the masked one, and masked columns are zero
    m_intr = p.masks.cam_intr.index_select(0, data["intr"]).T
    assert float((m_intr == 0.0).sum()) > 0
    assert np.all(J_cal[:, 6:].numpy()[:, m_intr.numpy() == 0.0] == 0.0)
    _, _, _, _, J_free = visual_fused.visual_cal_linearize(p.cfgs[i].camera_kind, data,
                                                           p.variables, None)
    assert rel((J_free[:, 6:] * m_intr[None]).numpy(), J_cal[:, 6:].numpy()) < 1e-14


def test_plain_version_keeps_float32():
    """The card runs float32: the plain version must not promote (forward-mode
    AD of the projection returns float64 tangents from float32 inputs)."""
    p = port_gs_from_jax(dtype=torch.float32)
    i = _blocked(p)
    out = visual_fused.visual_cal_linearize(p.cfgs[i].camera_kind, p.datas[i], p.variables,
                                            p.masks)
    assert all(o.dtype == torch.float32 for o in out)
    ref = visual_fused.visual_cal_linearize(p.cfgs[i].camera_kind, _kernels.to_f64(p.datas[i]),
                                            _kernels.to_f64(p.variables), _kernels.to_f64(p.masks))
    # float32 arithmetic against float64 on the same float32 inputs
    for o, r, tol in zip(out, ref, (1e-3, 0.0, 1e-4, 1e-4, 1e-4)):
        assert rel(o.numpy(), r.numpy()) <= tol


def test_linearize_batch_takes_the_fused_branch():
    """factors.linearize_batch routes the batch to K11's wrapper and returns
    the JAX Lin contract; the residual-only pass is K1's."""
    p = port_gs_from_jax()
    p._build()
    i = _blocked(p)
    cfg, data = p.active_cfgs[i], p.datas[i]
    assert cfg.active_groups == CAL_GROUPS
    lin = tfct.linearize_batch(cfg, data, p.variables, p.masks)
    ref = tfct.linearize_generic(cfg, data, p.variables, p.masks)
    assert lin.groups == ref.groups == CAL_GROUPS
    assert [tuple(J.shape) for J in lin.jac] == [tuple(J.shape) for J in ref.jac]
    for a, b in zip((lin.res, lin.valid) + lin.jac, (ref.res, ref.valid) + ref.jac):
        assert rel(a.numpy(), b.numpy()) < TOL
    for a, b in zip(lin.idx, ref.idx):
        assert torch.equal(a, b)
    res, valid = tfct.residual_batch(cfg, data, p.variables)
    assert rel(res.T.numpy(), lin.res.numpy()) < 1e-12
    _kernels.reset_launch_counts()
    tfct.linearize_batch(cfg, data, p.variables, p.masks)
    assert "visual_cal_linearize" in _kernels.launch_counts()
    assert all(n == 0 for n in _kernels.launch_counts().values())  # CPU: plain versions


# ---------------------------------------------------------------------------
# the path as a whole
# ---------------------------------------------------------------------------


def test_port_build_matches_jax_build():
    pj, aj = jax_gs()
    pt, at = port_gs_built()
    assert [c.kind for c in pt.cfgs] == [c.kind for c in pj.cfgs]
    assert "rs_visual" not in [c.kind for c in pt.cfgs]
    assert all("rs_tables" not in d for d in pt.datas)
    assert at.num_windows == aj.num_windows
    i = _blocked(pj)
    assert pt.cfgs[i].block_info == trcs.BlockInfo(**dataclasses.asdict(pj.cfgs[i].block_info))
    assert pt.cfgs[i].block_info.rb == 112 and pt.cfgs[i].block_info.wb > 0
    n_j = int((np.asarray(pj.datas[i]["_pad"]) < 0.5).sum())
    assert int((pt.datas[i]["_pad"] < 0.5).sum()) == n_j
    for k in ("rig", "point", "intr", "extr", "bias", "_pad", "_cb_local"):
        np.testing.assert_array_equal(pt.datas[i][k].numpy(), np.asarray(pj.datas[i][k]))
    assert rel(pt.datas[i]["obs_uv"].numpy(), pj.datas[i]["obs_uv"]) < 1e-12
    for f in pj.variables._fields:
        a, b = getattr(pt.variables, f).numpy(), np.asarray(getattr(pj.variables, f))
        assert float(np.abs(a - b).max(initial=0.0)) <= 1e-9 * max(float(np.abs(b).max(
            initial=0.0)), 1.0), f
    for f in pj.masks._fields:
        np.testing.assert_array_equal(getattr(pt.masks, f).numpy(),
                                      np.asarray(getattr(pj.masks, f)))


@functools.lru_cache(maxsize=None)
def _jax_linearized():
    pj, _ = jax_gs()
    pj._build()
    datas = tuple(pj.datas)
    k_lin, k_asm = pj._jits[0], pj._jits[6]
    lg = k_lin(datas, pj.variables, pj.masks, None)
    return pj, lg, k_asm(datas, lg, pj.variables, pj.masks)


@functools.lru_cache(maxsize=None)
def _port_linearized():
    p = port_gs_from_jax()
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
    assert trcs._cal_fast(b) and b.rig_k == 6 and b.J_cal.shape[1] == 23
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
    pj, _ = jax_gs()
    _jax_step()  # compile the carry iteration once (shared with the solve test)
    seq_j, seq_t = [], []
    saved = pj.variables
    try:
        sj = jopt.optimize(pj, jopt.LMSettings(
            max_iterations=3, direct_mode=False, pcg_max_iterations=PCG_ITERS,
            iteration_callback=lambda d: seq_j.append((d["prev_cost"], d["cost"]))))
    finally:
        pj.variables = saved
    p = port_gs_from_jax()
    st = topt.optimize(p, topt.LMSettings(
        max_iterations=3, direct_mode=False, pcg_max_iterations=PCG_ITERS,
        iteration_callback=lambda d: seq_t.append((d["prev_cost"], d["cost"]))))
    assert len(seq_t) == len(seq_j) == 3
    assert rel(np.asarray(seq_t), np.asarray(seq_j)) < 1e-6
    assert abs(st.final_cost - sj.final_cost) <= 1e-6 * abs(sj.final_cost)
    assert st.final_cost < 1e-2 * st.initial_cost
    assert st.num_iterations == sj.num_iterations


# ---------------------------------------------------------------------------
# general groups (the two-grid route with few-row groups)
# ---------------------------------------------------------------------------


def _general_pair(pj, p):
    """(JAX, port) damped systems of the same linearization. Batches left
    without an active group (neither package linearizes those) are dropped
    from both."""
    keep = [i for i, c in enumerate(jax_active_cfgs(pj)) if c.active_groups]
    cfgs_j = tuple(jax_active_cfgs(pj)[i] for i in keep)
    datas_j = tuple(pj.datas[i] for i in keep)
    p.cfgs, p.datas, p._kernels = [p.cfgs[i] for i in keep], [p.datas[i] for i in keep], None
    lg_j = jax.jit(lambda d, v, m: jeng.linearize(cfgs_j, d, v, m))(datas_j, pj.variables,
                                                                   pj.masks)
    asm_j = jrcs.assemble(cfgs_j, datas_j, lg_j, pj.variables, pj.masks)
    ks = p._build()
    datas = tuple(p.datas)
    lg_t = ks[0](datas, p.variables, p.masks, None)
    asm_t = ks[6](datas, lg_t, p.variables, p.masks)
    return (asm_j, jrcs.with_damping(asm_j, pj.variables, pj.masks, LAM),
            asm_t, trcs.with_damping(asm_t, p.variables, p.masks, LAM))


def _check_general(pj, p, groups, seed):
    asm_j, rs_j, asm_t, rs_t = _general_pair(pj, p)
    (bj,), (bt,) = asm_j.vis, asm_t.vis
    assert not jrcs._rig_only_fast(bj) and not trcs._single_pass(bt)
    assert bt.groups == groups and bt.cplan is None
    assert rel(asm_t.H_ll0.numpy(), asm_j.H_ll0) < 1e-10
    assert rel(asm_t.g_l.numpy(), asm_j.g_l) < 1e-10
    _fields(asm_t.g_r, asm_j.g_r, 1e-10, "g_r")
    _fields(asm_t.diag_r, asm_j.diag_r, 1e-10, "diag_r")
    for g in groups[1:]:
        assert rel(asm_t.blocks0[g].numpy(), asm_j.blocks0[g]) < 1e-10, g
    x = _random_tangent(p.variables, seed)
    x_t = tst.Tangent(**{f: t(a) for f, a in x.items()})
    x_j = jst.Tangent(**{f: jnp.asarray(a) for f, a in x.items()})
    y_t = trcs.matvec(rs_t, p.variables, x_t)
    _fields(y_t, jrcs.matvec(rs_j, pj.variables, x_j), 1e-10, "matvec")
    z = np.random.default_rng(seed + 1).normal(size=tuple(p.variables.points.shape))
    _fields(trcs.w_y(rs_t, p.variables, t(z)), jrcs.w_y(rs_j, pj.variables, jnp.asarray(z)),
            1e-10, "w_y")
    assert rel(trcs.w_transpose_x(rs_t, p.variables, x_t).numpy(),
               jrcs.w_transpose_x(rs_j, pj.variables, x_j)) < 1e-10
    return bj, bt, rs_t, x_t, y_t


def test_detector_bias_batch_takes_the_general_path():
    pj, _ = jax_gs(use_detector_bias=True)
    p = port_gs_from_jax(use_detector_bias=True)
    bj, bt, rs_t, x_t, y_t = _check_general(pj, p, ("rig", "cam_extr", "cam_intr", "det_bias"),
                                            51)
    # _vis_u / _vis_scatter against the JAX ones on the same wu
    x_j = jst.Tangent(**{f: jnp.asarray(a.numpy()) for f, a in x_t._asdict().items()})
    u_t = trcs._vis_u(bt, x_t)
    assert rel(u_t.numpy(), jrcs._vis_u(bj, x_j)) < 1e-10
    y0 = tst.zero_tangent(p.variables)._asdict()
    s_t = trcs._vis_scatter(bt, dict(y0), u_t)
    s_j = jrcs._vis_scatter(bj, jst.zero_tangent(pj.variables)._asdict(), jnp.asarray(u_t.numpy()))
    for g in bt.groups:
        assert np.abs(np.asarray(s_j[g])).max() > 0
        assert rel(s_t[g].numpy(), s_j[g]) < 1e-10, g
    # repeatable: the same call twice gives the same bits
    again = trcs._vis_scatter(bt, dict(y0), trcs._vis_u(bt, x_t))
    for g in bt.groups:
        assert torch.equal(again[g], s_t[g]), g
    y2 = trcs.matvec(rs_t, p.variables, x_t)
    for f in y_t._fields:
        assert torch.equal(getattr(y2, f), getattr(y_t, f)), f
    # the few-row groups reduce through chunked plans, not index_add_
    for g, rows in zip(bt.groups[1:], bt.rows[1:]):
        assert rows.row_chunk is not None, g


def test_intrinsics_only_batch_takes_the_general_path():
    """Only cam_intr estimated: both packages fold the lone group into their
    window kernels (the port's K8-K10 at kc = 17, where before they took the
    6 | 17 split only and sent the batch the general way)."""
    pj, _ = jax_gs()
    saved = pj.masks
    try:
        pj.masks = pj.masks._replace(cam_extr=jnp.zeros_like(pj.masks.cam_extr))
        p = port_gs_from_jax()
        _check_general_folded(pj, p, *_general_pair(pj, p))
    finally:
        pj.masks = saved


def _check_general_folded(pj, p, asm_j, rs_j, asm_t, rs_t):
    (bj,), (bt,) = asm_j.vis, asm_t.vis
    assert jrcs._cal_fast(bj) and bj.cal_groups == (("cam_intr", 17),)
    assert trcs._cal_fast(bt) and bt.cal_groups == (("cam_intr", 17),)
    assert bt.groups == ("rig", "cam_intr") and tuple(bt.J_cal.shape[:2]) == (2, 17)
    assert rel(asm_t.H_ll0.numpy(), asm_j.H_ll0) < 1e-10
    _fields(asm_t.g_r, asm_j.g_r, 1e-10, "g_r")
    _fields(asm_t.diag_r, asm_j.diag_r, 1e-10, "diag_r")
    assert rel(asm_t.blocks0["cam_intr"].numpy(), asm_j.blocks0["cam_intr"]) < 1e-10
    x = _random_tangent(p.variables, 61)
    y_t = trcs.matvec(rs_t, p.variables, tst.Tangent(**{f: t(a) for f, a in x.items()}))
    y_j = jrcs.matvec(rs_j, pj.variables, jst.Tangent(**{f: jnp.asarray(a) for f, a in x.items()}))
    _fields(y_t, y_j, 1e-10, "matvec")
