"""The port's full-sensor kernel modules and factor kinds vs the JAX package.

On the CPU each kernel wrapper takes its plain PyTorch version (the CUDA
kernels build and run only on the card). Inputs are the JAX package's tiny
full-sensor problem (tests/_torch_port_fixtures.py), handed to the port as
numpy, in float64. Held to 1e-9 relative to the reference's max-abs:

  factor kinds  each kind the session adapter emits (inertial_secondary,
                omega_prior, the four random walks, the four factory priors,
                rs_visual unblocked): residual and J by the generic
                torch.func path vs the JAX linearize_batch
  K7            ops/rs_fused.rs_linearize vs the JAX linearize_batch of the
                blocked batch (its fused Pallas linearizer declines on the
                CPU, so the generic AD path runs), with and without J
  K8-K10        seg_assemble_cal, seg_schur_down_cal, seg_schur_up_cal,
                seg_schur_pcg_cal vs the JAX entries on their XLA branches
  K2-K6         at rig_k = 9 (the rolling-shutter batch's pose + velocity
                columns) vs the JAX entries

Both sides take the same J, weights and tables (random ones from a numpy
seed). Each CUDA kernel is held against its plain version on the card by
tests/test_torch_kernels_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port_fixtures import jax_active_cfgs, jax_full, port_full_from_jax, rel, t

from visual_inertial_bundle_adjustment_tpu.ops import segments as jseg
from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
from visual_inertial_bundle_adjustment_tpu_torch.ops import rs_fused
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as tfct
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

TOL = 1e-9
NEW_KINDS = ("inertial_secondary", "omega_prior", "rw_imu_calib", "rw_cam_intr", "rw_cam_extr",
             "rw_imu_extr", "cam_intr_prior", "cam_extr_prior", "imu_calib_prior",
             "imu_extr_prior", "rs_visual")
CAL_KERNELS = ("assemble_cal", "schur_down_cal", "schur_up_cal", "schur_pcg_cal")
RIG_KERNELS = ("assemble_rig", "precond_rig", "schur_down", "schur_up", "schur_pcg")


@functools.lru_cache(maxsize=None)
def _port():
    return port_full_from_jax()


def close(a, b, tol=TOL):
    """max |a - b| within tol of max(max |b|, 1): the residuals of the
    extrinsic priors and random walks at the built state are rounding noise
    around zero (both windows start from the same calibration)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) <= tol * max(float(np.abs(b).max()), 1.0)


def _rs_index(p):
    (i,) = [i for i, c in enumerate(p.cfgs) if c.kind == "rs_visual"]
    return i


@functools.lru_cache(maxsize=None)
def _jax_vis():
    """The JAX linearization and the blocked batch's VisBatch."""
    pj, _ = jax_full()
    cfgs = jax_active_cfgs(pj)
    datas = tuple(pj.datas)
    lg = jax.jit(lambda d, v, m: jeng.linearize(cfgs, d, v, m))(datas, pj.variables, pj.masks)
    (b, lin), = jrcs._vis_batches(cfgs, datas, lg)
    assert jrcs._cal_fast(b) and b.rig_k == 9
    return lg, b, lin


# ---------------------------------------------------------------------------
# factor kinds and K7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_factor_kind_matches_jax(kind):
    """Residual and J of each new kind by the generic AD path (the rs_visual
    batch with its blocking hidden)."""
    pj, _ = jax_full()
    p = _port()
    (i,) = [i for i, c in enumerate(pj.cfgs) if c.kind == kind]
    cfg_j = dataclasses.replace(jax_active_cfgs(pj)[i], block_info=None)
    data_j = {k: a for k, a in pj.datas[i].items() if k != "_uvT"}
    lin_j = jax.jit(lambda d, v, m: jfct.linearize_batch(cfg_j, d, v, m))(
        data_j, pj.variables, pj.masks)
    cfg_t = dataclasses.replace(p.cfgs[i], block_info=None, active_groups=cfg_j.active_groups)
    lin_t = tfct.linearize_batch(cfg_t, p.datas[i], p.variables, p.masks)
    assert lin_t.groups == lin_j.groups
    assert close(lin_t.res.numpy(), lin_j.res)
    np.testing.assert_array_equal(lin_t.valid.numpy(), np.asarray(lin_j.valid))
    for g, Jt, Jj in zip(lin_t.groups, lin_t.jac, lin_j.jac):
        assert rel(Jt.numpy(), Jj) < TOL, g
    res_t, valid_t = tfct.residual_batch(cfg_t, p.datas[i], p.variables)
    res_j, valid_j = jfct.residual_batch(cfg_j, data_j, pj.variables)
    assert close(res_t.numpy(), res_j)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


@pytest.mark.parametrize("with_jac", [True, False])
def test_rs_linearize_plain_matches_jax(with_jac):
    pj, _ = jax_full()
    i = _rs_index(pj)
    cfg = jax_active_cfgs(pj)[i]
    assert cfg.block_info is not None and "_uvT" in pj.datas[i]  # the fused hook declines
    p = _port()
    data = p.datas[i]
    if with_jac:
        lin = jax.jit(lambda d, v, m: jfct.linearize_batch(cfg, d, v, m))(
            pj.datas[i], pj.variables, pj.masks)
        assert lin.groups == (jfct.POINTS, jfct.RIG, jfct.CAM_EXTR, jfct.CAM_INTR)
        res, valid, J_pt, J_r, J_cal = rs_fused.rs_linearize(cfg.camera_kind, data, p.variables,
                                                             p.masks, True, True)
        assert rel(res.numpy(), lin.res) < TOL
        np.testing.assert_array_equal(valid.numpy(), np.asarray(lin.valid))
        assert rel(J_pt.numpy(), lin.jac[0]) < TOL
        assert rel(J_r.numpy(), lin.jac[1]) < TOL
        assert rel(J_cal.numpy(), np.concatenate([lin.jac[2], lin.jac[3]], axis=1)) < TOL
    else:
        res_j, valid_j = jax.jit(lambda d, v: jfct.residual_batch(cfg, d, v))(pj.datas[i],
                                                                              pj.variables)
        res, valid = rs_fused.rs_linearize(cfg.camera_kind, data, p.variables, None, False,
                                           False)
        assert rel(res.numpy().T, res_j) < TOL
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))


# ---------------------------------------------------------------------------
# K8-K10 and K2-K6 at rig_k = 9
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inputs():
    """The JAX batch's J, res and weights, plus random rig/window/landmark
    tables and SPD landmark-block inverses."""
    _, b, lin = _jax_vis()
    v = jax_full()[0].variables
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    rng = np.random.default_rng(23)
    A = rng.normal(size=(L, 3, 3))
    return dict(J=np.asarray(b.jac[0]), J_cal=np.asarray(b.J_cal), J_pt=np.asarray(b.J_pt),
                res=np.asarray(lin.res), w=np.asarray(b.w), x=rng.normal(size=(R, 9)),
                x_c=rng.normal(size=(n_c, 23)), z=rng.normal(size=(L, 3)),
                hinv=A @ np.swapaxes(A, -1, -2) + np.eye(3))


def _jax_seg(name, a):
    _, b, _ = _jax_vis()
    i = b.info
    R, L, n_c = a["x"].shape[0], a["z"].shape[0], a["x_c"].shape[0]
    J, Jc, Jp, w = (jnp.asarray(a[k]) for k in ("J", "J_cal", "J_pt", "w"))
    x, xc, z, hinv = (jnp.asarray(a[k]) for k in ("x", "x_c", "z", "hinv"))
    loc = (b.rb_local, b.rg_pt_local, b.rg_hib)
    cal_loc = (b.rb_local, b.cal_local, b.rg_pt_local, b.rg_hib)
    geo = (i.nt, i.ts, i.rb, i.prb2 // 128, i.nhg)
    cgeo = (i.nt, i.ts, i.rb, i.wb, i.prb2 // 128, i.nhg)
    if name == "assemble_cal":
        g_r, d_r, g_c, d_c, blocks, g_l, H = jseg.seg_assemble_cal(
            J, Jc, Jp, jnp.asarray(a["res"]), w, *cal_loc, b.rb_base, b.cal_base, L, *cgeo, R,
            n_c, tuple(d for _, d in b.cal_groups))
        return (g_r, d_r, g_c, d_c, *blocks, g_l, H)
    if name == "schur_down_cal":
        return jseg.seg_schur_down_cal(J, Jc, Jp, w, *cal_loc, x, xc, b.rb_base, b.cal_base, L,
                                       *cgeo)
    if name == "schur_up_cal":
        return jseg.seg_schur_up_cal(J, Jc, Jp, w, *cal_loc, z, b.rb_base, b.cal_base, *cgeo,
                                     R, n_c)
    if name == "schur_pcg_cal":
        return jseg.seg_schur_pcg_cal(J, Jc, Jp, w, *cal_loc, x, xc, hinv, b.rb_base,
                                      b.cal_base, L, *cgeo)
    if name == "assemble_rig":
        return jseg.seg_assemble_rig(J, Jp, jnp.asarray(a["res"]), w, *loc, b.rb_base, L, *geo, R)
    if name == "precond_rig":
        M = jseg.seg_precond_rig(J, Jp, w, *loc, hinv, b.rb_base, *geo, R)
        return (0.5 * (M + jnp.swapaxes(M, -1, -2)),)  # the port returns the symmetric block
    if name == "schur_down":
        return jseg.seg_schur_down(J, Jp, w, *loc, x, b.rb_base, L, *geo)
    if name == "schur_up":
        return (jseg.seg_schur_up(J, Jp, w, *loc, z, b.rb_base, *geo, R),)
    return (jseg.seg_schur_pcg(J, Jp, w, *loc, x, hinv, b.rb_base, L, *geo),)


def _port_seg(name, a, plan, cplan):
    J, Jc, Jp, w, x, xc, z, hinv = (a[k] for k in ("J", "J_cal", "J_pt", "w", "x", "x_c", "z",
                                                    "hinv"))
    if name == "assemble_cal":
        g_r, d_r, g_c, d_c, blocks, g_l, H = tseg.seg_assemble_cal(J, Jc, Jp, a["res"], w, plan,
                                                                   cplan)
        return (g_r, d_r, g_c, d_c, *blocks, g_l, H)
    if name == "schur_down_cal":
        return tseg.seg_schur_down_cal(J, Jc, Jp, w, x, xc, plan, cplan)
    if name == "schur_up_cal":
        return tseg.seg_schur_up_cal(J, Jc, Jp, w, z, plan, cplan)
    if name == "schur_pcg_cal":
        return tseg.seg_schur_pcg_cal(J, Jc, Jp, w, x, xc, hinv, plan, cplan)
    if name == "assemble_rig":
        return tseg.seg_assemble_rig(J, Jp, a["res"], w, plan)
    if name == "precond_rig":
        return (tseg.seg_precond_rig(J, Jp, w, hinv, plan),)
    if name == "schur_down":
        return tseg.seg_schur_down(J, Jp, w, x, plan)[:2]
    if name == "schur_up":
        return (tseg.seg_schur_up(J, Jp, w, z, plan),)
    return (tseg.seg_schur_pcg(J, Jp, w, x, hinv, plan),)


@pytest.mark.parametrize("name", CAL_KERNELS + RIG_KERNELS)
def test_segment_plain_matches_jax(name):
    a = _inputs()
    out_j = _jax_seg(name, a)
    p = _port()
    i = _rs_index(p)
    data, info = p.datas[i], p.cfgs[i].block_info
    out_t = _port_seg(name, {k: t(v) for k, v in a.items()}, trcs.plan_of(data),
                      trcs.cal_plan_of(data, info))
    assert len(out_t) == len(out_j)
    for ot, oj in zip(out_t, out_j):
        assert rel(ot.numpy(), oj) < TOL


def test_cal_kernels_do_not_depend_on_the_chunk_size():
    """The window-row chunking is a reduction plan only: a plan with 3-slot
    chunks lists the same slots per row as the default one."""
    p = _port()
    i = _rs_index(p)
    data, info = p.datas[i], p.cfgs[i].block_info
    win = trcs.cal_plan_of(data, info).win.numpy()
    pad = data["_pad"].numpy()
    small = tseg.cal_plan_arrays(win, pad, p.variables.cam_intr.shape[0], chunk=3)
    big = tseg.cal_plan_arrays(win, pad, p.variables.cam_intr.shape[0])
    np.testing.assert_array_equal(small["_cal_chunk_obs"], big["_cal_chunk_obs"])
    rc, cp = small["_cal_row_chunk"], small["_cal_chunk_ptr"]
    rb, cb = big["_cal_row_chunk"], big["_cal_chunk_ptr"]
    np.testing.assert_array_equal(cp[rc], cb[rb])  # the same row boundaries
    assert np.diff(cp).max() <= 3


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    a = {k: t(v) for k, v in _inputs().items()}
    p = _port()
    i = _rs_index(p)
    data, info = p.datas[i], p.cfgs[i].block_info
    _kernels.reset_launch_counts()
    rs_fused.rs_linearize(p.cfgs[i].camera_kind, data, p.variables, p.masks, True, True)
    for name in CAL_KERNELS:
        _port_seg(name, a, trcs.plan_of(data), trcs.cal_plan_of(data, info))
    counts = _kernels.launch_counts()
    assert {"rs_linearize", *CAL_KERNELS} <= set(counts)
    assert all(n == 0 for n in counts.values())
