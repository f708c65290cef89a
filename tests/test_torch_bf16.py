"""The port's bf16 J storage of the PCG loop (`rcs.MATVEC_BF16`) against the
JAX package, float64 on the CPU.

With the flag on, `rcs._vis_batches` gives each single-pass batch bf16
copies of its Jacobians (`J_mv`, `J_pt_mv`, `J_cal_mv`), which the
preconditioner's rig blocks (K3), W y (K5, K10's up pass) and the PCG matvec
(K4, K9; K6 and K10's down pass on the route with several batches) read;
the back-substitution, assembly, gradient and cost keep float32 (here
float64) J. Both packages see the same rounded values: the port rounds
once (`J.to(torch.bfloat16)`), and the test puts those values, unpadded,
into the JAX package's assembled `VisBatch`es as its `J_mv`, `J_pt_mv` and
`J_cal_mv` (the JAX package fills them only on its TPU; its XLA entries
upcast bf16 J to w's type as the port's plain versions do). Nothing of the
JAX package is edited. Routes: the tiny bias-only problem (rig-only
single-pass, K3-K6 at rig_k 6), the tiny full-sensor problem (calibration
coupled, rig_k 9, kc 23) and its global-shutter recording (rig_k 6, kc 23).

  * the flagged matvec on a seeded x, W y on a seeded y_l, the
    preconditioner's inverse blocks and solve_assembled's (x_r, x_l,
    model reduction) within 1e-9 of the JAX package's, relative to max-abs;
  * the back-substitution W^T x is bit-identical with the flag on and off
    (it reads float J);
  * with the flag off the batches carry no copies and a solve is
    bit-identical to one made before the flag was ever set;
  * the rounded operator is symmetric: x^T S~ y - y^T S~ x within 1e-12 of
    |x| |S~ y|;
  * the route with several single-pass batches: the tiny merged problem of
    tests/test_torch_multi_session.py, blocked with its TINY_BLOCKS (two
    rig-only single-pass batches beside the point-coupled base map), whose
    matvec runs K6 with y and K5 on the copies: within 1e-9 of the JAX
    package's;
  * each plain version of the eight kernels that read bf16 J gives, on bf16
    J, the bits it gives on that J upcast to w's type.
"""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_fixtures import (jax_full, jax_gs, jax_problem, port_full_from_jax,
                                  port_gs_from_jax, port_problem, rel, t)
from test_torch_multi_session import TINY_BLOCKS, _fresh_jax_merge, _port

from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as tseg
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs
from visual_inertial_bundle_adjustment_tpu_torch.problem import structure as tst

LAM = 1e-4
PCG_ITERS = 40
TOL = 1e-9
ROUTES = {"bias": (jax_problem, port_problem),
          "full": (lambda: jax_full()[0], port_full_from_jax),
          "gs_cal": (lambda: jax_gs()[0], port_gs_from_jax)}


def _fields(a, b, tol, what):
    for f in b._fields:
        x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        assert float(np.abs(x - y).max(initial=0.0)) <= tol * max(float(np.abs(y).max(
            initial=0.0)), 1e-300), (what, f)


@contextlib.contextmanager
def _flag(on):
    saved = trcs.MATVEC_BF16
    trcs.MATVEC_BF16 = on
    try:
        yield
    finally:
        trcs.MATVEC_BF16 = saved


def _jax_bf16(a):
    """The port's bf16 values as a JAX bf16 array (exact), or None."""
    return None if a is None else jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)


def _with_copies(asm_j, asm_t):
    """The JAX assembly with the port's bf16 copies in its VisBatches."""
    return asm_j._replace(vis=tuple(
        bj._replace(J_mv=_jax_bf16(bt.J_mv), J_pt_mv=_jax_bf16(bt.J_pt_mv),
                    J_cal_mv=_jax_bf16(bt.J_cal_mv)) for bj, bt in zip(asm_j.vis, asm_t.vis)))


def _port_asm(p, flag):
    ks = p._build()
    datas = tuple(p.datas)
    lg = ks[0](datas, p.variables, p.masks, None)
    with _flag(flag):
        return ks[6](datas, lg, p.variables, p.masks)


@functools.lru_cache(maxsize=None)
def _systems(route):
    """(JAX problem, port problem, JAX assembly with the port's copies, the
    port's flagged assembly, both damped systems at LAM)."""
    make_j, make_t = ROUTES[route]
    pj, p = make_j(), make_t()
    pj._build()
    datas_j = tuple(pj.datas)
    lg_j = pj._jits[0](datas_j, pj.variables, pj.masks, None)
    asm_j = pj._jits[6](datas_j, lg_j, pj.variables, pj.masks)
    asm_t = _port_asm(p, True)
    (b,) = asm_t.vis
    assert trcs._single_pass(b) and b.J_mv.dtype == torch.bfloat16
    asm_j = _with_copies(asm_j, asm_t)
    rs_j = jrcs.with_damping(asm_j, pj.variables, pj.masks, LAM)
    rs_t = trcs.with_damping(asm_t, p.variables, p.masks, LAM)
    return pj, p, asm_j, asm_t, rs_j, rs_t


def _random_tangent(v, seed):
    rng = np.random.default_rng(seed)
    zt = tst.zero_tangent(v)
    return {f: rng.normal(size=tuple(getattr(zt, f).shape)) for f in zt._fields}


def _tangents(v, seed):
    x = _random_tangent(v, seed)
    return (tst.Tangent(**{f: t(a) for f, a in x.items()}),
            jst.Tangent(**{f: jnp.asarray(a) for f, a in x.items()}))


@pytest.mark.parametrize("route", list(ROUTES))
def test_copies_are_the_rounded_jacobians(route):
    _, _, _, asm_t, _, _ = _systems(route)
    (b,) = asm_t.vis
    assert torch.equal(b.J_mv, b.J.to(torch.bfloat16))
    assert torch.equal(b.J_pt_mv, b.J_pt.to(torch.bfloat16))
    if route == "bias":
        assert trcs._rig_only_fast(b) and b.J_cal_mv is None
    else:  # unpadded: kc columns, not a multiple of 8 as in the JAX package
        assert trcs._cal_fast(b) and b.J_cal_mv.shape == b.J_cal.shape == (2, 23, b.J.shape[-1])
        assert torch.equal(b.J_cal_mv, b.J_cal.to(torch.bfloat16))
    assert float((b.J_mv.double() - b.J).abs().max()) > 0  # the copies are rounded


@pytest.mark.parametrize("route", list(ROUTES))
def test_flagged_matvec_matches_jax(route):
    pj, p, _, _, rs_j, rs_t = _systems(route)
    x_t, x_j = _tangents(p.variables, 5)
    _fields(trcs.matvec(rs_t, p.variables, x_t), jrcs.matvec(rs_j, pj.variables, x_j), TOL,
            "matvec")


@pytest.mark.parametrize("route", list(ROUTES))
def test_flagged_w_y_matches_jax(route):
    pj, p, _, _, rs_j, rs_t = _systems(route)
    z = np.random.default_rng(6).normal(size=tuple(p.variables.points.shape))
    _fields(trcs.w_y(rs_t, p.variables, t(z)), jrcs.w_y(rs_j, pj.variables, jnp.asarray(z)),
            TOL, "w_y")


@pytest.mark.parametrize("route", list(ROUTES))
def test_flagged_preconditioner_matches_jax(route):
    _, _, _, _, rs_j, rs_t = _systems(route)
    _fields(rs_t.precond_inv, rs_j.precond_inv, TOL, "precond_inv")


@pytest.mark.parametrize("route", list(ROUTES))
def test_flagged_solve_assembled_matches_jax(route):
    pj, p, asm_j, asm_t, _, _ = _systems(route)
    x_r, x_l, model_red, *_ = trcs.solve_assembled(asm_t, p.variables, p.masks, LAM,
                                                   PCG_ITERS, 1e-10)
    want = jrcs.solve_assembled(asm_j, pj.variables, pj.masks, LAM, PCG_ITERS, 1e-10)
    _fields(x_r, want[0], TOL, "x_r")
    assert rel(x_l.numpy(), want[1]) < TOL
    assert rel(model_red.numpy(), want[2]) < TOL


@pytest.mark.parametrize("route", list(ROUTES))
def test_back_substitution_reads_float_jacobians(route):
    """W^T x with the flag on is bit-identical to the flag-off call."""
    _, p, _, asm_t, _, rs_t = _systems(route)
    rs_off = trcs.with_damping(_port_asm(p, False), p.variables, p.masks, LAM)
    assert rs_off.vis[0].J_mv is None and asm_t.vis[0].J_mv is not None
    x_t, _ = _tangents(p.variables, 7)
    assert torch.equal(trcs.w_transpose_x(rs_t, p.variables, x_t),
                       trcs.w_transpose_x(rs_off, p.variables, x_t))


@pytest.mark.parametrize("route", list(ROUTES))
def test_flag_off_changes_nothing(route, monkeypatch):
    """With the flag off the batches carry no copies, and a solve equals,
    bit for bit, one made before the flag was ever set."""
    p = ROUTES[route][1]()
    assert trcs.MATVEC_BF16 is False

    def solve():
        asm = _port_asm(p, trcs.MATVEC_BF16)
        assert all(b.J_mv is None and b.J_pt_mv is None and b.J_cal_mv is None for b in asm.vis)
        return trcs.solve_assembled(asm, p.variables, p.masks, LAM, PCG_ITERS, 1e-10)[:3]

    before = solve()
    monkeypatch.setattr(trcs, "MATVEC_BF16", True)
    assert _port_asm(p, trcs.MATVEC_BF16).vis[0].J_mv is not None
    monkeypatch.setattr(trcs, "MATVEC_BF16", False)
    after = solve()
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert torch.equal(before[1], after[1]) and torch.equal(before[2], after[2])


@pytest.mark.parametrize("route", list(ROUTES))
def test_rounded_operator_is_symmetric(route, monkeypatch):
    monkeypatch.setattr(trcs, "MATVEC_BF16", True)
    _, p, _, _, _, rs_t = _systems(route)
    x, _ = _tangents(p.variables, 8)
    y, _ = _tangents(p.variables, 9)
    Sx, Sy = trcs.matvec(rs_t, p.variables, x), trcs.matvec(rs_t, p.variables, y)
    gap = float(tst.t_dot(x, Sy) - tst.t_dot(y, Sx))
    scale = float(tst.t_norm(x) * tst.t_norm(Sy))
    assert abs(gap) <= 1e-12 * scale, (gap, scale)


def test_several_batch_route_matvec_matches_jax(monkeypatch):
    """The merged problem's two rig-only single-pass batches (and its base
    map, point-coupled) take the matvec's route with several batches: K6
    with y and K5 on the copies, the landmark solve between them."""
    pj = _fresh_jax_merge()
    p = _port(pj)
    jrcs.finalize_blocks(pj, **TINY_BLOCKS)
    trcs.finalize_blocks(p, **TINY_BLOCKS)
    monkeypatch.setattr(trcs, "MATVEC_BF16", True)
    asm_t = _port_asm(p, True)
    assert [trcs._rig_only_fast(b) for b in asm_t.vis] == [True, True]
    assert all(b.J_mv is not None for b in asm_t.vis)
    pj._build()
    datas_j = tuple(pj.datas)
    lg_j = pj._jits[0](datas_j, pj.variables, pj.masks, None)
    asm_j = _with_copies(pj._jits[6](datas_j, lg_j, pj.variables, pj.masks), asm_t)
    rs_j = jrcs.with_damping(asm_j, pj.variables, pj.masks, LAM, "identity")
    rs_t = trcs.with_damping(asm_t, p.variables, p.masks, LAM, "identity")
    assert rs_t.rest_pt.lins and len(rs_t.vis) == 2
    x_t, x_j = _tangents(p.variables, 10)
    _fields(trcs.matvec(rs_t, p.variables, x_t), jrcs.matvec(rs_j, pj.variables, x_j), TOL,
            "matvec")


def _kernel_args(name):
    """A wrapper's arguments on the tiny problems' real Jacobians (float64
    w and tables, J as bf16)."""
    route = "bias" if name in ("precond_rig", "schur_down", "schur_up", "schur_pcg") else "full"
    _, p, _, asm_t, _, rs_t = _systems(route)
    (b,) = asm_t.vis
    rng = np.random.default_rng(11)
    R, L = p.variables.pose_q.shape[0], p.variables.points.shape[0]
    x = t(rng.normal(size=(R, b.rig_k)))
    z = t(rng.normal(size=(L, 3)))
    J, Jp, Jc = b.J_mv, b.J_pt_mv, b.J_cal_mv
    if route == "bias":
        args = {"precond_rig": (J, Jp, b.w, rs_t.H_ll_inv, b.plan),
                "schur_down": (J, Jp, b.w, x, b.plan),
                "schur_up": (J, Jp, b.w, z, b.plan),
                "schur_pcg": (J, Jp, b.w, x, rs_t.H_ll_inv, b.plan)}[name]
        return args, (0, 1)
    xc = t(rng.normal(size=(b.cplan.n_rows, Jc.shape[1])))
    args = {"schur_down_cal": (J, Jc, Jp, b.w, x, xc, b.plan, b.cplan),
            "schur_up_cal": (J, Jc, Jp, b.w, z, b.plan, b.cplan),
            "schur_pcg_cal": (J, Jc, Jp, b.w, x, xc, rs_t.H_ll_inv, b.plan, b.cplan),
            "schur_pcg_cal_cols": (J, Jc, Jp, b.w, x[..., None].repeat(1, 1, 3),
                                   xc[..., None].repeat(1, 1, 3), rs_t.H_ll_inv, b.plan,
                                   b.cplan)}[name]
    return args, (0, 1, 2)


@pytest.mark.parametrize("name", ["precond_rig", "schur_down", "schur_up", "schur_pcg",
                                  "schur_down_cal", "schur_up_cal", "schur_pcg_cal",
                                  "schur_pcg_cal_cols"])
def test_plain_versions_upcast_bf16_jacobians(name):
    """Each plain version on bf16 J gives the bits it gives on J upcast to
    w's type (float64 here): it computes the kernels' function."""
    fn = getattr(tseg, "seg_" + name)
    args, jpos = _kernel_args(name)
    assert all(args[i].dtype == torch.bfloat16 for i in jpos)
    up = tuple(a.double() if i in jpos else a for i, a in enumerate(args))
    got, want = fn(*args), fn(*up)
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple)
                                                            else (want,))
    assert len(got) == len(want)
    for a, c in zip(got, want):
        assert a.dtype == torch.float64 and torch.equal(a, c)
