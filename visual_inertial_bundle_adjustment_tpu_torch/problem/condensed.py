"""Condensed (marginal) factors: quadratic factors re-injecting marginalized
information.

Port of `visual_inertial_bundle_adjustment_tpu/problem/condensed.py`
(reference lib/small_thing/CondensedFactor.h:36-572 + Proxies.h): a
condensed factor is 1/2 x^T H x + b^T x + c over proxy-transformed
variables, where x stacks box-minus deltas against stored linearization
points (DirectForward proxies, with the SE3/S2/vector box ops) or
relative-pose logs (ProxyRelativePoses). In the whitened-residual engine it
becomes res = A x + u with H = A^T A and u = A^-T b, so the generic
machinery reproduces gradient H x + b and Gauss-Newton Hessian H exactly
(cost differs by the constant c, which LM never uses).

One batch kind exists per static signature `condensed_rigs{K}`: K rig states
(pose+vel+omega, 12 dims each) plus gravity (2), D = 12K + 2, registered at
run time (`ensure_condensed_kind`). The builder `marginalize_onto_rigs`
computes (H, b) of the full problem marginalized onto the kept rigs
(reference computeMarginalProblem, Optimizer.cpp:422-494) via Schur-reduced
covariance solves (problem/covariance.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from ..ops import lie
from . import covariance, engine
from . import factors as fct
from .structure import GRAVITY_MAG, OMEGA, POSE, VEL


def _ok(res):
    return torch.ones_like(res[0], dtype=torch.bool)


def _condensed_local(ts, ar, cfg):
    K = len(ts) - 1
    xs = []
    for k in range(K):
        xi = ts[k]
        Tq, Tt = fct._se3_at(ar[f"pose_q{k}"], ar[f"pose_t{k}"], xi[POSE])
        dpose = lie.se3_boxminus((Tq, Tt), (ar[f"lin_q{k}"], ar[f"lin_t{k}"]))
        dvel = ar[f"vel{k}"] + xi[VEL] - ar[f"lin_vel{k}"]
        dom = ar[f"omega{k}"] + xi[OMEGA] - ar[f"lin_omega{k}"]
        xs.append(torch.cat([dpose, dvel, dom]))
    grav = lie.s2_boxplus(ar["grav"], GRAVITY_MAG, ts[-1])
    xs.append(lie.s2_boxminus(grav, ar["lin_grav"], GRAVITY_MAG))
    res = ar["A"] @ torch.cat(xs) + ar["u"]
    return res, (res, _ok(res))


def _rig_args(out, v, d, k):
    idx = d[f"rig{k}"]
    out[f"pose_q{k}"] = fct._take(v.pose_q, idx)
    out[f"pose_t{k}"] = fct._take(v.pose_t, idx)
    out[f"vel{k}"] = fct._take(v.vel, idx)
    out[f"omega{k}"] = fct._take(v.omega, idx)
    for f in (f"lin_q{k}", f"lin_t{k}", f"lin_vel{k}", f"lin_omega{k}"):
        out[f] = d[f]


def _condensed_args(K):
    def fn(v, d):
        out = {}
        for k in range(K):
            _rig_args(out, v, d, k)
        out["grav"] = v.gravity.expand(d["rig0"].shape[0], 3)
        for f in ("lin_grav", "A", "u"):
            out[f] = d[f]
        return out

    return fn


def ensure_condensed_kind(K: int) -> str:
    """Register (once) the batch kind for K rig states + gravity."""
    kind = f"condensed_rigs{K}"
    if kind not in fct.REGISTRY:
        fct.REGISTRY[kind] = dict(
            local=_condensed_local,
            args=_condensed_args(K),
            tangents=[(fct.RIG, f"rig{k}") for k in range(K)] + [(fct.GRAVITY, None)],
            optional=False,
            res_dim=12 * K + 2,
        )
    return kind


def _sqrt_info(H, b):
    """(A, u) with H = A^T A (A the symmetric square root of the PSD
    marginal) and u = A^-T b."""
    w, V = np.linalg.eigh(0.5 * (H + H.T))
    w = np.maximum(w, 1e-12 * max(w.max(), 1.0))
    A = (V * np.sqrt(w)) @ V.T
    return A, np.linalg.solve(A.T, b)


def _tensor(a, v):
    return torch.as_tensor(np.asarray(a), dtype=v.points.dtype, device=v.points.device)


def _index(r, v):
    return torch.tensor([int(r)], dtype=torch.int32, device=v.points.device)


def make_condensed_batch(v, rig_indices, H, b):
    """Batch data for ONE condensed factor over `rig_indices` + gravity.

    H: (D, D) marginal information, b: (D,) gradient at the current values
    (which become the stored linearization points). D = 12*K + 2."""
    K = len(rig_indices)
    D = 12 * K + 2
    assert H.shape == (D, D) and b.shape == (D,)
    A, u = _sqrt_info(H, b)
    data = {}
    for k, r in enumerate(rig_indices):
        r = int(r)
        data[f"rig{k}"] = _index(r, v)
        data[f"lin_q{k}"] = v.pose_q[r][None].clone()
        data[f"lin_t{k}"] = v.pose_t[r][None].clone()
        data[f"lin_vel{k}"] = v.vel[r][None].clone()
        data[f"lin_omega{k}"] = v.omega[r][None].clone()
    data["lin_grav"] = v.gravity[None].clone()
    data["A"] = _tensor(A, v)[None]
    data["u"] = _tensor(u, v)[None]
    return ensure_condensed_kind(K), data


#
# Relative (gauge-invariant) condensed factors, reference Proxies.h
# (ProxyRelativePoses :152-196, ProxyTransformedVelocities :252-295,
# ProxyS2 :57-104): the marginal's coordinates are re-expressed relative to a
# base pose variable, so re-injecting into a problem whose world frame has
# moved (applyWorldTransformation) leaves the factor's cost unchanged, and
# the information correctly follows the base pose.
#
# x layout (matching marginalize_rel_onto_rigs entry order):
#   [base vel (3, base-frame), base omega (3)]
#   + per rig k: [rel-pose log (6), vel in base frame (3), omega (3)]
#   + gravity in base frame (S2 tangent, 2)
# D = 6 + 12K + 2. Omegas are body-frame (gyro) quantities, hence already
# gauge-invariant and forwarded directly (DirectForward).
#


def _condensed_rel_local(ts, ar, cfg):
    K = len(ts) - 2  # ts = [base, rig0..rig{K-1}, gravity]
    xib = ts[0]
    Tbq, Tbt = fct._se3_at(ar["base_q"], ar["base_t"], xib[POSE])
    Tb_inv = lie.se3_inverse((Tbq, Tbt))
    xs = [
        lie.quat_rotate(Tbq, ar["base_vel"] + xib[VEL]) - ar["lin_bvel"],
        ar["base_omega"] + xib[OMEGA] - ar["lin_bomega"],
    ]
    for k in range(K):
        xi = ts[k + 1]
        Ti = fct._se3_at(ar[f"pose_q{k}"], ar[f"pose_t{k}"], xi[POSE])
        dpose = lie.se3_boxminus(lie.se3_mul(Ti, Tb_inv), (ar[f"lin_q{k}"], ar[f"lin_t{k}"]))
        dvel = lie.quat_rotate(Tbq, ar[f"vel{k}"] + xi[VEL]) - ar[f"lin_vel{k}"]
        dom = ar[f"omega{k}"] + xi[OMEGA] - ar[f"lin_omega{k}"]
        xs.append(torch.cat([dpose, dvel, dom]))
    grav = lie.s2_boxplus(ar["grav"], GRAVITY_MAG, ts[-1])
    xs.append(lie.s2_boxminus(lie.quat_rotate(Tbq, grav), ar["lin_grav"], GRAVITY_MAG))
    res = ar["A"] @ torch.cat(xs) + ar["u"]
    return res, (res, _ok(res))


def _condensed_rel_args(K):
    def fn(v, d):
        bidx = d["base"]
        out = {"base_q": fct._take(v.pose_q, bidx), "base_t": fct._take(v.pose_t, bidx),
               "base_vel": fct._take(v.vel, bidx), "base_omega": fct._take(v.omega, bidx),
               "lin_bvel": d["lin_bvel"], "lin_bomega": d["lin_bomega"]}
        for k in range(K):
            _rig_args(out, v, d, k)
        out["grav"] = v.gravity.expand(bidx.shape[0], 3)
        for f in ("lin_grav", "A", "u"):
            out[f] = d[f]
        return out

    return fn


def ensure_condensed_rel_kind(K: int) -> str:
    """Register (once) the relative batch kind for K rigs + base + gravity."""
    kind = f"condensed_rel_rigs{K}"
    if kind not in fct.REGISTRY:
        fct.REGISTRY[kind] = dict(
            local=_condensed_rel_local,
            args=_condensed_rel_args(K),
            tangents=[(fct.RIG, "base")] + [(fct.RIG, f"rig{k}") for k in range(K)]
            + [(fct.GRAVITY, None)],
            optional=False,
            res_dim=6 + 12 * K + 2,
        )
    return kind


def _rel_linearization(v, base_rig, rig_indices):
    """Proxy linearization points (base-relative coords) at current values,
    as tensors on the variables' device."""
    b = int(base_rig)
    Rb = lie.quat_to_matrix(v.pose_q[b])
    lin = {
        "lin_bvel": Rb @ v.vel[b],
        "lin_bomega": v.omega[b].clone(),
        "lin_grav": Rb @ v.gravity,
    }
    Tb_inv = lie.se3_inverse((v.pose_q[b], v.pose_t[b]))
    for k, r in enumerate(rig_indices):
        r = int(r)
        rq, rt = lie.se3_mul((v.pose_q[r], v.pose_t[r]), Tb_inv)
        lin[f"lin_q{k}"] = rq
        lin[f"lin_t{k}"] = rt
        lin[f"lin_vel{k}"] = Rb @ v.vel[r]
        lin[f"lin_omega{k}"] = v.omega[r].clone()
    return lin


def _abs_to_rel_jacobian(v, base_rig, rig_indices):
    """S = d(proxy coords)/d(absolute tangent) at the linearization point.

    The marginal (H, b) lives in absolute tangent coordinates (base pose
    held constant); the condensed factor evaluates proxy coordinates. Pose
    and omega blocks are exactly identity (log(exp(xi) * rel * rel^-1) = xi);
    velocity blocks rotate by R_base; the gravity block is the 2x2 map
    ortho(R_b g) R_b ortho(g)^T. Computed by forward-mode AD of the proxy
    map (torch.func.jacfwd; D is tiny)."""
    b = int(base_rig)
    D = 6 + 12 * len(rig_indices) + 2
    lin = _rel_linearization(v, base_rig, rig_indices)
    Tb_inv = lie.se3_inverse((v.pose_q[b], v.pose_t[b]))

    def proxy(xabs):
        # xabs: [base vel 3, base om 3] + per-rig 12 + grav 2 (base pose FIXED)
        xs = [
            lie.quat_rotate(v.pose_q[b], v.vel[b] + xabs[0:3]) - lin["lin_bvel"],
            v.omega[b] + xabs[3:6] - lin["lin_bomega"],
        ]
        off = 6
        for k, r in enumerate(rig_indices):
            r = int(r)
            xi = xabs[off:off + 12]
            Ti = lie.se3_boxplus((v.pose_q[r], v.pose_t[r]), xi[POSE])
            dpose = lie.se3_boxminus(lie.se3_mul(Ti, Tb_inv), (lin[f"lin_q{k}"], lin[f"lin_t{k}"]))
            dvel = lie.quat_rotate(v.pose_q[b], v.vel[r] + xi[VEL]) - lin[f"lin_vel{k}"]
            dom = v.omega[r] + xi[OMEGA] - lin[f"lin_omega{k}"]
            xs.append(torch.cat([dpose, dvel, dom]))
            off += 12
        grav = lie.s2_boxplus(v.gravity, GRAVITY_MAG, xabs[off:off + 2])
        xs.append(lie.s2_boxminus(lie.quat_rotate(v.pose_q[b], grav), lin["lin_grav"],
                                  GRAVITY_MAG))
        return torch.cat(xs)

    S = jacfwd(proxy)(v.points.new_zeros((D,)))
    return S.detach().to(torch.float64).cpu().numpy(), lin


def make_condensed_rel_batch(v, base_rig, rig_indices, H, b):
    """Batch data for ONE relative condensed factor (base + K rigs + gravity).

    H: (D, D), b: (D,) in ABSOLUTE tangent coordinates over
    [base vel, base omega] + rigs + gravity with the base pose held constant
    (as produced by marginalize_rel_onto_rigs); transformed here into the
    proxy coordinates the factor evaluates."""
    K = len(rig_indices)
    D = 6 + 12 * K + 2
    assert H.shape == (D, D) and b.shape == (D,)
    S, lin = _abs_to_rel_jacobian(v, base_rig, rig_indices)
    Sinv = np.linalg.inv(S)
    A, u = _sqrt_info(Sinv.T @ H @ Sinv, Sinv.T @ b)
    data = {"base": _index(base_rig, v)}
    for k, r in enumerate(rig_indices):
        data[f"rig{k}"] = _index(r, v)
    for key, val in lin.items():
        data[key] = val.detach()[None]
    data["A"] = _tensor(A, v)[None]
    data["u"] = _tensor(u, v)[None]
    return ensure_condensed_rel_kind(K), data


def _solve_kept(problem, lam, kw):
    """The full problem's damped GN step x_r at the current masks."""
    datas = tuple(problem.datas)
    v, masks = problem.variables, problem.masks
    cfgs = engine.prune_cfgs(tuple(problem.cfgs), masks)
    lg = engine.linearize(cfgs, datas, v, masks)
    x_r, *_ = engine.solve_step(cfgs, datas, lg, v, masks, lam,
                                max_iters=kw.get("pcg_iters", 800),
                                rel_tol=kw.get("pcg_tol", 1e-12))
    return covariance._numpy(x_r)


def marginalize_rel_onto_rigs(problem, base_rig, rig_indices, lam=1e-7, **kw):
    """(H, b) marginalized onto [base vel/omega] + rigs + gravity with the
    base rig's POSE held constant (the gauge anchor), in absolute tangent
    coordinates: feed to make_condensed_rel_batch.

    Mirrors reference TestCondensedFactor.cpp:335-774 usage: pose 0 constant,
    marginal over surviving poses + all velocities (+ gravity)."""
    b = int(base_rig)
    saved_rig = problem.masks.rig
    rig = saved_rig.clone()
    rig[b, 0:6] = 0.0
    problem.masks = problem.masks._replace(rig=rig)
    problem._invalidate()
    try:
        entries = [(fct.RIG, b, d) for d in range(6, 12)]
        entries += [(fct.RIG, int(r), d) for r in rig_indices for d in range(12)]
        entries += [(fct.GRAVITY, 0, d) for d in range(2)]
        Hm = covariance.marginal_information(problem, entries, lam=lam, **kw)
        x_r = _solve_kept(problem, lam, kw)
        xstar = np.concatenate([x_r.rig[b, 6:12]] + [x_r.rig[int(r)] for r in rig_indices]
                               + [x_r.gravity])
        bvec = Hm @ xstar
    finally:
        problem.masks = problem.masks._replace(rig=saved_rig)
        problem._invalidate()
    return Hm, bvec


def marginalize_onto_rigs(problem, rig_indices, lam=1e-7, **kw):
    """(H, b) of the problem marginalized onto rigs + gravity.

    b = Hm x* where x* is the full minimizer restricted to the kept entries
    (equivalently the Schur-reduced gradient), so that re-injecting the
    factor reproduces the marginal's minimum at the current linearization.
    """
    entries = [(fct.RIG, int(r), d) for r in rig_indices for d in range(12)]
    entries += [(fct.GRAVITY, 0, d) for d in range(2)]
    Hm = covariance.marginal_information(problem, entries, lam=lam, **kw)
    x_r = _solve_kept(problem, lam, kw)
    xstar = np.concatenate([x_r.rig[int(r)] for r in rig_indices] + [x_r.gravity])
    return Hm, Hm @ xstar
