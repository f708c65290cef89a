"""The port's covariance path (problem/covariance.py and what it needs)
against the JAX package, in float64 on the CPU.

  * the gauge prior `position_yaw_prior` and `pose_prior`: residuals and
    Jacobians against factors.linearize_batch within 1e-10;
  * engine.prune_cfgs and structure.apply_world_transformation as the JAX
    package's;
  * packed PCG on C right-hand sides (a trailing column axis) bit-equal,
    column by column, to single-column solves: on the generic engine, and
    on the blocked engine through the plain column K4 (the tiny bias-only
    problem) and column K9 (the tiny full-sensor problem);
  * rig_covariances, calib_covariances, update_under_conditioning and
    marginal_information against the JAX package on its generic engine, on
    the tiny problem with the IMU biases estimated, within 1e-6 of each
    block's largest entry (measured: 1e-10 and below);
  * the blocked engine's covariances (column K4; column K9 on the
    full-sensor problem) against the generic engine's on the same problem
    (`Problem.use_blocked_engine = False`), the port's twin of
    tests/test_marginals.py::test_blocked_covariance_matches_generic,
    within 1e-6 (measured: 1e-9 and below).

The JAX side keeps to 150 PCG iterations, and its results are computed once
per process (its eager linearization compiles for about a minute).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import port_blocked_problem, port_full_built, rel, t, to_numpy

from visual_inertial_bundle_adjustment_tpu.ops import lie as jlie
from visual_inertial_bundle_adjustment_tpu.problem import covariance as jcov
from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch import interop
from visual_inertial_bundle_adjustment_tpu_torch.problem import covariance as tcov
from visual_inertial_bundle_adjustment_tpu_torch.problem import engine as teng
from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as tfct
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

jax.config.update("jax_enable_x64", True)

PCG = dict(pcg_iters=150)
LAM = 1e-7
RIGS = [1, 4, 7]
TOL = 1e-6


def _block_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@functools.lru_cache(maxsize=None)
def _jax_problem():
    from __graft_entry__ import _tiny_problem

    return _tiny_problem(estimate_imu_calib=True,
                         imu_calib_options=dict(accelBias=True, gyroBias=True))


def _port_problem():
    return interop.problem_from_numpy(**to_numpy(_jax_problem()), device="cpu",
                                      dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _jax_covariances():
    pj = _jax_problem()
    return (jcov.rig_covariances(pj, RIGS, lam=LAM, **PCG),
            jcov.calib_covariances(pj, "imu_calib", [0], lam=LAM, **PCG))


def _prior_data(kind, R, rng):
    n = 5
    q = rng.normal(size=(n, 4))
    data = {"rig": rng.integers(0, R, n).astype(np.int32),
            "ref_q": q / np.linalg.norm(q, axis=-1, keepdims=True),
            "ref_t": rng.normal(size=(n, 3))}
    if kind == "pose_prior":
        data["sqrt_h"] = rng.normal(size=(n, 6, 6))
    else:
        data["sqrt_h_pos"] = rng.random((n, 3)) + 0.5
        data["sqrt_h_yaw"] = rng.random((n, 1)) + 0.5
    return data


@pytest.mark.parametrize("kind", ["pose_prior", "position_yaw_prior"])
def test_prior_factors_match_jax(kind):
    pj = _jax_problem()
    pt = _port_problem()
    data = _prior_data(kind, pt.variables.pose_q.shape[0], np.random.default_rng(5))
    want = jfct.linearize_batch(jfct.BatchCfg(kind=kind), {k: jnp.asarray(a) for k, a in
                                                           data.items()}, pj.variables, pj.masks)
    got = tfct.linearize_batch(tfct.BatchCfg(kind=kind), {k: t(a) for k, a in data.items()},
                               pt.variables, pt.masks)
    assert tfct.REGISTRY[kind]["res_dim"] == got.res.shape[0] == (6 if kind == "pose_prior"
                                                                  else 4)
    assert rel(got.res.numpy(), want.res) < 1e-10
    assert got.groups == tuple(want.groups)
    for a, b in zip(got.jac, want.jac):
        assert np.abs(np.asarray(b)).max() > 0
        assert rel(a.numpy(), b) < 1e-10


def test_prune_cfgs_matches_jax():
    pj, pt = _jax_problem(), _port_problem()
    for free in (None, "imu_calib"):
        jm, tm = pj.masks, pt.masks
        if free is not None:
            jm = jm._replace(imu_calib=jnp.zeros_like(jm.imu_calib))
            tm = tm._replace(imu_calib=torch.zeros_like(tm.imu_calib))
        want = [c.active_groups for c in jeng.prune_cfgs(tuple(pj.cfgs), jm)]
        assert [c.active_groups for c in teng.prune_cfgs(tuple(pt.cfgs), tm)] == want


def test_apply_world_transformation_matches_jax():
    pj, pt = _jax_problem(), _port_problem()
    xi = np.random.default_rng(3).normal(size=6) * np.array([2.0, 2.0, 2.0, 0.6, 0.6, 0.6])
    Tq, Tt = jlie.se3_exp(jnp.asarray(xi))
    want = jst.apply_world_transformation(pj.variables, Tq, Tt)
    got = tst.apply_world_transformation(pt.variables, t(Tq), t(Tt))
    for f in tst.VariableTables._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


def _system(problem):
    problem._build()
    cfgs, datas, v = problem.active_cfgs, tuple(problem.datas), problem.variables
    lg = teng.linearize(cfgs, datas, v, problem.masks)
    if any(c.block_info is not None for c in cfgs):
        rs = trcs.with_damping(trcs.assemble(cfgs, datas, lg, v, problem.masks), v,
                               problem.masks, 1e-4)
        return v, lambda b: trcs.pcg(rs, v, b, 25, 1e-12)
    rs = teng.build_reduced_system(lg, v, problem.masks, 1e-4)
    return v, lambda b: teng.pcg_solve(lg, v, rs, b, 25, 1e-12)


@pytest.mark.parametrize("engine", ["generic", "blocked_k4", "blocked_k9"])
def test_packed_pcg_columns_bit_equal(engine):
    """9 random right-hand sides solved at once equal, bit for bit, their
    single-column solves (x, rel and iterations)."""
    p = {"generic": _port_problem, "blocked_k4": port_blocked_problem,
         "blocked_k9": lambda: port_full_built()[0]}[engine]()
    v, solve = _system(p)
    C = 9
    g = torch.Generator().manual_seed(11)
    b = tst.Tangent(*(torch.randn(a.shape + (C,), generator=g, dtype=a.dtype)
                      for a in tst.zero_tangent(v)))
    x, rel_c, it = solve(b)
    assert rel_c.shape == it.shape == (C,)
    assert all(getattr(x, f).shape == getattr(b, f).shape for f in tst.Tangent._fields)
    for c in range(C):
        x1, rel1, it1 = solve(tst.column(b, c))
        for f in tst.Tangent._fields:
            assert torch.equal(getattr(x, f)[..., c], getattr(x1, f)), (c, f)
        assert torch.equal(rel_c[c], rel1) and torch.equal(it[c], it1)


def test_covariances_match_jax():
    """rig_covariances and calib_covariances on the generic engine."""
    want_rig, want_cal = _jax_covariances()
    pt = _port_problem()
    got_rig = tcov.rig_covariances(pt, RIGS, lam=LAM, **PCG)
    assert len(pt.cfgs) == len(_jax_problem().cfgs)  # the gauge prior removed again
    for r in RIGS:
        assert got_rig[r].shape == (12, 12)
        assert _block_rel(got_rig[r], want_rig[r]) < TOL
    got_cal = tcov.calib_covariances(pt, "imu_calib", [0], lam=LAM, **PCG)
    (B, dims), (Bj, dims_j) = got_cal[0], want_cal[0]
    assert dims == dims_j == list(range(6))
    assert _block_rel(B, Bj) < TOL
    assert np.linalg.eigvalsh(B).min() > 0


def test_update_under_conditioning_and_marginal_information_match_jax():
    pj, pt = _jax_problem(), _port_problem()
    rng = np.random.default_rng(7)
    u = rng.normal(size=12) * 1e-3
    cond = {f: np.zeros(np.shape(a)) for f, a in pj.masks._asdict().items()}
    cond["rig"][3] = 1.0
    ut = np.zeros(np.shape(pj.masks.rig))
    ut[3] = u
    jz, tz = jst.zero_tangent(pj.variables), tst.zero_tangent(pt.variables)
    want = jcov.update_under_conditioning(
        pj, jz._replace(rig=jnp.asarray(ut)), jnp.zeros_like(pj.variables.points),
        jst.Masks(**{f: jnp.asarray(a) for f, a in cond.items()}), lam=LAM, **PCG)
    got = tcov.update_under_conditioning(
        pt, tz._replace(rig=t(ut)), torch.zeros_like(pt.variables.points),
        tst.Masks(**{f: t(a) for f, a in cond.items()}), lam=LAM, **PCG)
    for f in ("pose_q", "pose_t", "vel", "omega", "points", "gravity", "imu_calib"):
        moved = np.abs(np.asarray(getattr(want, f)) - np.asarray(getattr(pj.variables, f))).max()
        err = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f))).max()
        assert err <= TOL * max(moved, 1e-12), f

    entries = [("rig", 4, d) for d in range(12)] + [("gravity", 0, d) for d in range(2)]
    with jcov.with_gauge_prior(pj):
        want_m = jcov.marginal_information(pj, entries, lam=LAM, **PCG)
    with tcov.with_gauge_prior(pt):
        got_m = tcov.marginal_information(pt, entries, lam=LAM, **PCG)
    assert got_m.shape == (14, 14)
    assert _block_rel(got_m, want_m) < TOL


@pytest.mark.parametrize("route", ["k4", "k9"])
def test_blocked_covariances_match_generic(route):
    """The blocked engine's columns (column K4 on the tiny bias-only
    problem, column K9 on the tiny full-sensor one) against the generic
    engine's on the same problem. The full-sensor problem is damped with
    lambda 1e-2: at 1e-7 its weakly observed directions leave the two
    engines' columns 1e-4 apart after 400 PCG iterations, and further apart
    after 1,000 (its damped system is too ill-conditioned for float64 to
    fix them); at 1e-2 they agree to 1e-15 within 60."""
    if route == "k4":
        pa, pb = port_blocked_problem(), port_blocked_problem(blocks={"ts": 10 ** 9})
        rigs, cal, kw = [2, 9], None, dict(lam=LAM, pcg_iters=400)
    else:
        pa, pb = port_full_built()[0], port_full_built(blocked=False)[0]
        rigs, cal, kw = [3], [0], dict(lam=1e-2, pcg_iters=60)
    pb.use_blocked_engine = False
    with tcov.with_gauge_prior(pa):
        sys_a = tcov.prepare_system(pa, kw["lam"])
        assert tcov.system_is_blocked(sys_a)
        (b,) = sys_a[1].vis
        assert trcs._cal_fast(b) == (route == "k9") and trcs._single_pass(b)
    with tcov.with_gauge_prior(pb):
        assert not tcov.system_is_blocked(tcov.prepare_system(pb, kw["lam"]))
    got, want = (tcov.rig_covariances(p, rigs, **kw) for p in (pa, pb))
    for r in rigs:
        assert _block_rel(got[r], want[r]) < TOL
    if cal is not None:
        got, want = (tcov.calib_covariances(p, "imu_calib", cal, **kw) for p in (pa, pb))
        for r in cal:
            assert got[r][1] == want[r][1] and got[r][1]
            assert _block_rel(got[r][0], want[r][0]) < TOL
