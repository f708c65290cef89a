"""Gauss-Newton engine pieces: cost, gradient, small-block inverses.

Port of the parts of `visual_inertial_bundle_adjustment_tpu/problem/engine.py`
that the blocked bias-only path uses: the per-iteration linearization state,
comparable costs (reference Factor.h:391-417), gradient accumulation, the
closed-form 3x3 landmark inverses, the block-Jacobi preconditioner inverses
with the LowerPrecSolvePrecond definiteness safeguard
(Preconditioner.h:186-219), and the generic Hessian matvec used for the
small (non-visual) rest graph. The Schur-reduced solve itself lives in
problem/rcs.py.

Damping follows reference Optimizer::addDamping (Optimizer.cpp:135-146):
diag *= (1 + lambda); diag += lambda.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import losses
from . import factors as fct
from .structure import Masks, Tangent, VariableTables, zero_tangent


class LinearizedGraph(NamedTuple):
    """Per-iteration linearization state (cfgs are kept by the caller)."""

    lins: tuple  # tuple[fct.Lin] per batch
    w: tuple  # tuple[(N,)] robust weight * valid per batch
    cost: torch.Tensor  # () total cost 0.5 * sum rho(s)
    stored_cost: tuple  # tuple[(N,)] per-factor cost at linearization
    valid0: tuple  # tuple[(N,)] validity at linearization
    num_invalid: torch.Tensor  # () count of invalid optional factors
    num_optional: torch.Tensor  # () count of optional factors


def _batch_cost_terms(cfg: fct.BatchCfg, res, valid, axis=-1):
    """res (N, d) with axis=-1 (cost paths) or (d, N) with axis=0 (Lin)."""
    s = (res * res).sum(axis)
    kind, a, k = cfg.loss
    val, der = losses.loss_jet2(int(kind), float(a), float(k), s)
    return 0.5 * val * valid, der * valid


def _count(mask):
    return mask.sum().to(torch.int64)


def linearize(cfgs, datas, v: VariableTables, masks: Masks, alive: tuple | None = None):
    """Linearize all batches. `alive` optionally freezes factors that failed
    at an earlier linearization (reference dontRetryFailed,
    Optimizer.cpp:1002-1007)."""
    lins, ws, costs, stored, valid0 = [], [], [], [], []
    device = v.points.device
    n_inv = torch.zeros((), dtype=torch.int64, device=device)
    n_opt = torch.zeros((), dtype=torch.int64, device=device)
    for i, (cfg, data) in enumerate(zip(cfgs, datas)):
        lin = fct.linearize_batch(cfg, data, v, masks)
        valid = lin.valid
        optional = fct.REGISTRY[cfg.kind]["optional"]
        if alive is not None and optional:
            valid = valid * alive[i]
            lin = lin._replace(valid=valid)
        cost_f, w = _batch_cost_terms(cfg, lin.res, valid, axis=0)
        lins.append(lin)
        ws.append(w)
        costs.append(cost_f.sum())
        stored.append(cost_f)
        valid0.append(valid)
        if optional:
            n_inv = n_inv + _count(valid < 0.5)
            n_opt = n_opt + (_count(data["_pad"] < 0.5) if "_pad" in data
                             else valid.shape[0])
    return LinearizedGraph(
        lins=tuple(lins), w=tuple(ws), cost=sum(costs), stored_cost=tuple(stored),
        valid0=tuple(valid0), num_invalid=n_inv, num_optional=n_opt,
    )


class CostStats(NamedTuple):
    cost: torch.Tensor
    num_invalid: torch.Tensor
    num_prev_invalid: torch.Tensor
    num_total: torch.Tensor


def comparable_cost(cfgs, datas, v: VariableTables, lg: LinearizedGraph) -> CostStats:
    """Cost at new variables, comparable with the linearization point
    (Factor.h:391-417): factors invalid at linearization contribute nothing;
    factors valid then but invalid now contribute their stored cost."""
    device = v.points.device
    total = torch.zeros((), dtype=v.points.dtype, device=device)
    n_inv = torch.zeros((), dtype=torch.int64, device=device)
    n_prev = torch.zeros((), dtype=torch.int64, device=device)
    n_tot = torch.zeros((), dtype=torch.int64, device=device)
    for cfg, data, stored, v0 in zip(cfgs, datas, lg.stored_cost, lg.valid0):
        res, valid = fct.residual_batch(cfg, data, v)
        cost_f, _ = _batch_cost_terms(cfg, res, valid)
        if fct.REGISTRY[cfg.kind]["optional"]:
            prev_ok = v0 > 0.5
            now_ok = valid > 0.5
            contrib = torch.where(prev_ok, torch.where(now_ok, cost_f, stored),
                                  torch.zeros_like(cost_f))
            total = total + contrib.sum()
            n_inv = n_inv + _count(~now_ok)
            n_prev = n_prev + _count(~prev_ok)
            n_tot = n_tot + (_count(data["_pad"] < 0.5) if "_pad" in data
                             else valid.shape[0])
        else:
            total = total + cost_f.sum()
    return CostStats(total, n_inv, n_prev, n_tot)


def comparable_from_linearized(cfgs, lg_old: LinearizedGraph,
                               lg_new: LinearizedGraph) -> CostStats:
    """`comparable_cost(v_new, lg_old)` from a full linearization at v_new:
    bookkeeping over the two linearizations' stored costs and validity.
    Empty cfgs give a zero total (the JAX package returns None there,
    ROADMAP queue C fault 3)."""
    total = None
    for cfg, st_old, v0_old, st_new, v0_new in zip(
            cfgs, lg_old.stored_cost, lg_old.valid0, lg_new.stored_cost, lg_new.valid0):
        if fct.REGISTRY[cfg.kind]["optional"]:
            prev_ok = v0_old > 0.5
            now_ok = v0_new > 0.5
            t = torch.where(prev_ok, torch.where(now_ok, st_new, st_old),
                            torch.zeros_like(st_new)).sum()
        else:
            t = st_new.sum()
        total = t if total is None else total + t
    if total is None:
        total = torch.zeros((), device=lg_new.num_invalid.device)
    return CostStats(total, lg_new.num_invalid, lg_old.num_invalid, lg_new.num_optional)


def gradient_tangent(cfgs, datas, v, masks: Masks):
    """Exact robust-cost gradient at v (step-factor interpolation, reference
    Optimizer.cpp:917-930), as J^T (w * res) from a fresh linearization —
    the same value the JAX package takes by reverse-mode AD through the cost,
    without differentiating through a kernel. Blocked visual batches reduce
    through the assembly kernel (rcs.assemble)."""
    from . import rcs

    lg = linearize(cfgs, datas, v, masks)
    asm = rcs.assemble(cfgs, datas, lg, v, masks)
    return asm.g_r, asm.g_l


# ---------------------------------------------------------------------------
# Block accumulation primitives (generic layout)
# ---------------------------------------------------------------------------


def _accumulate_grad(lg: LinearizedGraph, v: VariableTables):
    """grad = J^T (w * res) over all batches -> (Tangent, points (L,3))."""
    g = zero_tangent(v)._asdict()
    gp = torch.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        wres = lin.res * w[None, :]  # (d, N)
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            contrib = (J * wres[:, None, :]).sum(0)  # (dim, N)
            if group == fct.POINTS:
                gp = gp + fct.scatter_rows(ell, idx, contrib, gp.shape[0])
            elif group == fct.GRAVITY:
                g[group] = g[group] + contrib.sum(-1)
            else:
                g[group] = g[group] + fct.scatter_rows(ell, idx, contrib, g[group].shape[0])
    return Tangent(**g), gp


def _hess_diag(lg: LinearizedGraph, v: VariableTables):
    """Diagonal ENTRIES of the (undamped) GN Hessian, as (Tangent, (L,3))."""
    d = zero_tangent(v)._asdict()
    dp = torch.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            contrib = (J * J * w[None, None, :]).sum(0)  # (dim, N)
            if group == fct.POINTS:
                dp = dp + fct.scatter_rows(ell, idx, contrib, dp.shape[0])
            elif group == fct.GRAVITY:
                d[group] = d[group] + contrib.sum(-1)
            else:
                d[group] = d[group] + fct.scatter_rows(ell, idx, contrib, d[group].shape[0])
    return Tangent(**d), dp


def _hmatvec(lg: LinearizedGraph, v, x: Tangent, xp):
    """Undamped GN Hessian matvec on the FULL state (incl. landmarks)."""
    y = zero_tangent(v)._asdict()
    yp = torch.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        u = torch.zeros_like(lin.res)  # (d, N)
        for group, idx, J in zip(lin.groups, lin.idx, lin.jac):
            if group == fct.POINTS:
                xvT = xp.index_select(0, idx).T
            elif group == fct.GRAVITY:
                xvT = x.gravity[:, None].expand(2, J.shape[-1])
            else:
                xvT = getattr(x, group).index_select(0, idx).T
            u = u + (J * xvT[None]).sum(1)
        wu = u * w[None, :]
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            contrib = (J * wu[:, None, :]).sum(0)
            if group == fct.POINTS:
                yp = yp + fct.scatter_rows(ell, idx, contrib, yp.shape[0])
            elif group == fct.GRAVITY:
                y[group] = y[group] + contrib.sum(-1)
            else:
                y[group] = y[group] + fct.scatter_rows(ell, idx, contrib, y[group].shape[0])
    return Tangent(**y), yp


# ---------------------------------------------------------------------------
# Small dense inverses
# ---------------------------------------------------------------------------


def _inv3(H):
    """Closed-form symmetric 3x3 inverse (adjugate / det), elementwise."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e = H[..., 1, 1], H[..., 1, 2]
    f = H[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    rows = torch.stack([torch.stack([A, B, C], -1), torch.stack([B, D, E], -1),
                        torch.stack([C, E, F], -1)], -2)
    return rows / det[..., None, None]


def _chol_solve(H_ll_inv, b):
    """Apply the precomputed landmark-block inverses."""
    return (H_ll_inv * b[..., None, :]).sum(-1)


def _cholesky_columns(B, track_min_pivot=False):
    """Column-vectorized Cholesky of a batch of SPD blocks with the JAX
    package's pivot floor (max(s, 1e-30)); optionally also the smallest raw
    pivot per block."""
    d = B.shape[-1]
    L = torch.zeros_like(B)
    mp = None
    for j in range(d):
        Lj = L[..., j, :j]
        s = B[..., j, j] - (Lj * Lj).sum(-1)
        if track_min_pivot:
            mp = s if mp is None else torch.minimum(mp, s)
        Ljj = torch.sqrt(torch.clamp(s, min=1e-30))
        L[..., j, j] = Ljj
        if j + 1 < d:
            t = B[..., j + 1:, j] - (L[..., j + 1:, :j] * Lj[..., None, :]).sum(-1)
            L[..., j + 1:, j] = t / Ljj[..., None]
    return L, mp


def _inv_spd_small(B):
    """Batched SPD inverse through a column-vectorized Cholesky: B^-1 =
    M^T M with M = L^-1 (plain elementwise tensor ops, as the JAX package's
    unrolled version)."""
    d = B.shape[-1]
    L, _ = _cholesky_columns(B)
    M = torch.zeros_like(B)
    eye = torch.eye(d, dtype=B.dtype, device=B.device)
    for i in range(d):
        acc = eye[i].expand(B.shape[:-2] + (d,))
        if i:
            acc = acc - (L[..., i, :i, None] * M[..., :i, :]).sum(-2)
        M[..., i, :] = acc / L[..., i, i, None]
    return (M[..., :, :, None] * M[..., :, None, :]).sum(-3)


def _spd_min_pivot(B):
    """Smallest Cholesky pivot per block (same recursion as _inv_spd_small)."""
    return _cholesky_columns(B, track_min_pivot=True)[1]


# column-vectorized Cholesky inverse up to this dim; LU beyond (the few-row
# 23x23 IMU-calibration windows)
_INV_UNROLL_MAX_DIM = 17


def _precond_inv(B):
    """Inverse of block-Jacobi preconditioner blocks, with the
    LowerPrecSolvePrecond definiteness safeguard (Preconditioner.h:186-219):
    escalating diagonal bumps only for blocks whose Cholesky pivots fail."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    diag = torch.diagonal(B, dim1=-2, dim2=-1)
    scale = torch.clamp(diag.abs().amax(-1), min=1e-30)
    tol = 10.0 * torch.finfo(B.dtype).eps
    for bump in (1e-4, 1e-2, 1.0):
        bad = ~(_spd_min_pivot(B) > scale * tol)
        B = B + (torch.where(bad, bump * scale, torch.zeros_like(scale)))[..., None, None] * eye
    if B.shape[-1] <= _INV_UNROLL_MAX_DIM:
        return _inv_spd_small(B)
    return torch.linalg.inv(B)
