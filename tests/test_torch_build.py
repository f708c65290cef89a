"""PyTorch port vs the JAX package: the host-side problem build.

On a 6 s / 60-landmark synthetic session (float64, CPU): the session's
observations are equal, preintegration and the inertial sqrt-information
agree to 1e-9, the built problem's tables and batches agree to 1e-9, and
the port's finalize_blocks lays the visual batch out in the JAX package's
slot order, array for array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import BLOCKS, BUILD, jax_problem, jax_session, port_session, rel, t

from visual_inertial_bundle_adjustment_tpu.models import imu as jimu
from visual_inertial_bundle_adjustment_tpu.ops import preintegration as jpre
from visual_inertial_bundle_adjustment_tpu.pipeline import builder as jb
from visual_inertial_bundle_adjustment_tpu_torch.models import imu as timu
from visual_inertial_bundle_adjustment_tpu_torch.ops import preintegration as tpre
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tb
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

TOL = 1e-9


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for a in x for leaf in _leaves(a)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)]


def test_observations_equal():
    oj, ot = jax_session().observations(), port_session().observations()
    assert set(oj) == set(ot)
    for k in ("point", "rig", "cam"):
        np.testing.assert_array_equal(ot[k], oj[k])
    assert rel(ot["uv"], oj["uv"]) < 1e-12


def test_session_streams_equal():
    sj, st = jax_session(), port_session()
    for name in ("rig_times", "gt_pose_q", "gt_pose_t", "gt_vel_w", "gt_omega", "points_w",
                 "gravity", "camera_params", "gyro_t", "gyro_v", "accel_t", "accel_v"):
        assert rel(getattr(st, name), getattr(sj, name)) < TOL, name
    ivj, nj = sj.preint_intervals()
    ivt, nt = st.preint_intervals()
    assert nj == nt
    for a, b in zip(_leaves(ivt), _leaves(ivj)):
        assert rel(a, b) < TOL


def test_preintegrate_batch_matches_jax():
    """The same intervals and per-interval calibrations (identity plus a
    bias/scale perturbation) through both integrators."""
    iv, num_steps = jax_session().preint_intervals()
    n = iv.t_len.shape[0]
    rng = np.random.default_rng(5)
    calibs = np.tile(np.asarray(jimu.identity_calib(jnp.float64)), (n, 1))
    calibs[:, :6] += rng.normal(size=(n, 6)) * 1e-3
    calibs[:, 6:12] += rng.normal(size=(n, 6)) * 1e-3
    pj = jpre.preintegrate_batch(jnp.asarray(calibs), iv, jimu.default_noise_model(jnp.float64),
                                 num_steps)
    pt = tpre.preintegrate_batch(t(calibs), tpre.PreintInterval(*(t(a) for a in iv)),
                                 timu.default_noise_model(), num_steps)
    for a, b in zip(_leaves(pt), _leaves(pj)):
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            assert rel(a, b) < TOL


def test_chol_inv_lower_matches_jax():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(10, 9, 9))
    cov = A @ np.swapaxes(A, -1, -2) * 1e-6 + np.eye(9) * 1e-9
    assert rel(tb.chol_inv_lower(t(cov)).numpy(), np.asarray(jb.chol_inv_lower(jnp.asarray(cov)))) \
        < TOL


@pytest.fixture(scope="module")
def port_built():
    return tb.build_synthetic_problem(port_session(), tb.BuildOptions(**BUILD), device="cpu")


def test_build_synthetic_problem_matches_jax(port_built):
    pj = jb.build_synthetic_problem(jax_session(), jb.BuildOptions(**BUILD))
    pt = port_built
    for f in pj.variables._fields:
        assert rel(getattr(pt.variables, f).numpy(), getattr(pj.variables, f)) < TOL, f
    for f in pj.masks._fields:
        np.testing.assert_array_equal(getattr(pt.masks, f).numpy(), np.asarray(getattr(pj.masks, f)))
    assert [c.kind for c in pt.cfgs] == [c.kind for c in pj.cfgs]
    for cj, ct, dj, dt in zip(pj.cfgs, pt.cfgs, pj.datas, pt.datas):
        assert tuple(ct.loss) == tuple(cj.loss) and ct.camera_kind == cj.camera_kind
        assert set(dt) == set(dj), (set(dt) ^ set(dj))
        for k in dj:
            assert rel(dt[k].numpy(), dj[k]) < TOL, (cj.kind, k)


def test_finalize_blocks_slot_order_matches_jax():
    """Same slot order, pads, tile bases and point windows as the JAX
    package's finalize_blocks, so blocked arrays compare one to one."""
    p = tb.build_synthetic_problem(port_session(), tb.BuildOptions(**BUILD), device="cpu")
    trcs.finalize_blocks(p, **BLOCKS)
    pj = jax_problem()
    (bj, dj), = [(c.block_info, d) for c, d in zip(pj.cfgs, pj.datas) if c.block_info]
    (bt, dt), = [(c.block_info, d) for c, d in zip(p.cfgs, p.datas) if c.block_info]
    for f in ("rb", "nt", "ts", "prb", "pnt", "pts", "prb2", "nhg"):
        assert getattr(bt, f) == getattr(bj, f), f
    shared = set(dt) & set(dj)
    assert {"rig", "point", "obs_uv", "sqrt_h", "_pad", "_rb_local", "_rb_base",
            "_rg_pt_local", "_rg_hib"} <= shared
    for k in shared:
        assert rel(dt[k].numpy(), dj[k]) < TOL, k
