"""Gauss-Newton engine: cost, gradient, small-block inverses, generic Schur solve.

Port of `visual_inertial_bundle_adjustment_tpu/problem/engine.py`: the
per-iteration linearization state, comparable costs (reference
Factor.h:391-417), gradient accumulation, the closed-form 3x3 landmark
inverses, the block-Jacobi preconditioner inverses with the
LowerPrecSolvePrecond definiteness safeguard (Preconditioner.h:186-219), the
generic Hessian matvec (the small rest graph of the blocked solver, and the
point-coupled small batches' Schur cross terms), and the generic
Schur-reduced system that solves a problem with no blocked batch
(build_reduced_system ... solve_step). The blocked solver lives in
problem/rcs.py; both share the packed PCG loop (packed_pcg).

Every scatter into variable rows goes through a transpose plan
(factors.scatter_rows): sums run in a fixed order, with no float atomics.

Damping follows reference Optimizer::addDamping (Optimizer.cpp:135-146):
diag *= (1 + lambda); diag += lambda.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import losses
from . import factors as fct
from .structure import (Masks, Tangent, VariableTables, has_columns, pack_blocks, pack_info,
                        pack_t, t_dot, t_sub, unpack_t, zero_tangent)


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


def prune_cfgs(cfgs, masks: Masks):
    """Set static active_groups from the given masks: Problem._build's
    constant-group pruning, for direct linearize callers (the covariance
    and condensed-factor paths). A fully-masked group's Jacobians are exact
    zeros, so dropping the group skips its AD columns and its matvec
    traffic."""
    import dataclasses

    active = {g: bool(getattr(masks, g).any()) for g in fct.GROUP_DIMS}
    return tuple(
        dataclasses.replace(c, active_groups=tuple(
            g for g, _ in fct.REGISTRY[c.kind]["tangents"] if active[g]))
        for c in cfgs)


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
    if not any(c.block_info is not None for c in cfgs):
        return _accumulate_grad(lg, v)
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


# ---------------------------------------------------------------------------
# Generic Schur-reduced damped system (a problem with no blocked batch)
# ---------------------------------------------------------------------------


def _point_blocks(lg: LinearizedGraph, v: VariableTables, lam):
    """Damped landmark Hessian blocks H_ll (L, 3, 3)."""
    L = v.points.shape[0]
    H = torch.zeros((L, 3, 3), dtype=v.points.dtype, device=v.points.device)
    for lin, w in zip(lg.lins, lg.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group != fct.POINTS:
                continue
            Jw = J * w[None, None, :]
            contrib = (Jw[:, :, None, :] * J[:, None, :, :]).sum(0)  # (3, 3, N)
            H = H + fct.scatter_rows(ell, idx, contrib, L)
    # damping diag*(1+lam)+lam; masked/unobserved dims get identity via +lam
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    return H + eye * (lam * diag + lam)[..., None, :] * eye


class ReducedSystem(NamedTuple):
    """Damped Schur-reduced operator state for one (linearization, lambda)."""

    H_ll: torch.Tensor  # (L, 3, 3) damped landmark blocks
    H_ll_inv: torch.Tensor  # (L, 3, 3) closed-form inverses
    diag_r: Tangent  # undamped reduced diagonal entries
    lam: torch.Tensor
    precond_inv: Tangent | None  # block-Jacobi inverse blocks per group


def build_reduced_system(lg, v, masks: Masks, lam, precond_blocks=True,
                         precond="gauss_seidel"):
    """`precond` picks the preconditioner family (reference Preconditioner.h):
      - "gauss_seidel": block-Jacobi + per-observation Schur self-correction on
        rig blocks (the corner Gauss-Seidel analog, Preconditioner.h:117-160)
      - "jacobi": plain block-Jacobi (Preconditioner.h:53-114)
      - "lower_prec": gauss_seidel blocks from bfloat16-rounded per-factor
        products (the analog of the fp32 LowerPrecSolvePrecond,
        Preconditioner.h:163-246)
      - "identity": no preconditioning (IdentityPrecond)
    """
    lam = torch.as_tensor(lam, dtype=v.points.dtype, device=v.points.device)
    H_ll = _point_blocks(lg, v, lam)
    H_ll_inv = _inv3(H_ll)
    diag_r, _ = _hess_diag(lg, v)
    precond_inv = None
    if precond_blocks and precond != "identity":
        precond_inv = _build_preconditioner(
            lg, v, masks, lam, H_ll_inv, schur_corr=precond in ("gauss_seidel", "lower_prec"),
            low_precision=precond == "lower_prec")
    return ReducedSystem(H_ll, H_ll_inv, diag_r, lam, precond_inv)


def _build_preconditioner(lg, v, masks: Masks, lam, H_ll_inv, schur_corr=True,
                          low_precision=False):
    """Block-Jacobi blocks per variable group (damped, masked, inverted).

    With `schur_corr`, rig blocks additionally subtract the per-observation
    Schur self-correction J_rig^T w J_pt H_ll^-1 J_pt^T w J_rig. With
    `low_precision` each per-factor block product is rounded to bfloat16
    before the sum (the JAX package also sums them in bfloat16; the port sums
    in the problem's type, so the two agree to bfloat16 rounding)."""
    acc = (lambda x: x.to(torch.bfloat16).to(x.dtype)) if low_precision else (lambda x: x)
    dims = fct.GROUP_DIMS
    kw = dict(dtype=v.points.dtype, device=v.points.device)
    blocks = {g: torch.zeros((getattr(masks, g).shape[0] if getattr(masks, g).ndim > 1 else 1,
                              dims[g], dims[g]), **kw)
              for g in (fct.RIG, fct.CAM_INTR, fct.CAM_EXTR, fct.IMU_CALIB, fct.IMU_EXTR,
                        fct.DET_BIAS, fct.GRAVITY)}
    for lin, w in zip(lg.lins, lg.w):
        pt_entry = None
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                pt_entry = (idx, J)
                continue
            Jw = J * w[None, None, :]
            B = acc((Jw[:, :, None, :] * J[:, None, :, :]).sum(0))  # (dim, dim, N)
            if group == fct.GRAVITY:
                blocks[group] = blocks[group] + B.sum(-1)[None]
            else:
                blocks[group] = blocks[group] + fct.scatter_rows(ell, idx, B,
                                                                 blocks[group].shape[0])
        # rig Schur self-correction from landmark elimination
        if pt_entry is not None and schur_corr:
            pidx, Jp = pt_entry
            HinvT = H_ll_inv.index_select(0, pidx).permute(1, 2, 0)  # (3, 3, N)
            for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
                if group != fct.RIG:
                    continue
                A = ((J * w[None, None, :])[:, :, None, :] * Jp[:, None, :, :]).sum(0)  # (12,3,N)
                C = (A[:, :, None, :] * HinvT[None]).sum(1)  # (12, 3, N) = A H^-1
                corr = acc((C[:, None, :, :] * A[None, :, :, :]).sum(2))  # (12, 12, N)
                blocks[group] = blocks[group] - fct.scatter_rows(ell, idx, corr,
                                                                 blocks[group].shape[0])
    inv = {}
    for g, B in blocks.items():
        dim = B.shape[-1]
        eye = torch.eye(dim, dtype=B.dtype, device=B.device)
        diag = torch.diagonal(B, dim1=-2, dim2=-1)
        B = B + eye * (lam * torch.clamp(diag, min=0.0) + lam)[..., None, :] * eye
        m = getattr(masks, g)
        if m.ndim == 1:
            m = m[None, :]
        B = B * m[:, :, None] * m[:, None, :] + eye * (1.0 - m)[..., None, :] * eye
        # SPD safeguard: tiny ridge relative to trace
        tr = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        B = B + eye * tr * 1e-12
        inv[g] = _precond_inv(B)
    return Tangent(rig=inv[fct.RIG], cam_intr=inv[fct.CAM_INTR], cam_extr=inv[fct.CAM_EXTR],
                   imu_calib=inv[fct.IMU_CALIB], imu_extr=inv[fct.IMU_EXTR],
                   det_bias=inv[fct.DET_BIAS], gravity=inv[fct.GRAVITY][0])


def _apply_precond(rs: ReducedSystem, r: Tangent) -> Tangent:
    p = rs.precond_inv
    if p is None:  # IdentityPrecond (Preconditioner.h:44-50)
        return r
    return Tangent(*((P * x[..., None, :]).sum(-1) for P, x in zip(p, r)))


def _w_transpose_x(lg, v, x: Tangent):
    """A_lr x: landmark rows of H applied to a reduced-only vector."""
    t = torch.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        if fct.POINTS not in lin.groups:
            continue
        u = torch.zeros_like(lin.res)  # (d, N)
        pt_idx = pt_J = pt_ell = None
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                pt_idx, pt_J, pt_ell = idx, J, ell
                continue
            xvT = (x.gravity[:, None].expand(2, J.shape[-1]) if group == fct.GRAVITY
                   else getattr(x, group).index_select(0, idx).T)
            u = u + (J * xvT[None]).sum(1)
        contrib = (pt_J * (u * w[None, :])[:, None, :]).sum(0)
        t = t + fct.scatter_rows(pt_ell, pt_idx, contrib, t.shape[0])
    return t


def _w_y(lg, v, yl):
    """A_rl y_l: reduced rows of H applied to a landmark-only vector."""
    y = zero_tangent(v)._asdict()
    for lin, w in zip(lg.lins, lg.w):
        if fct.POINTS not in lin.groups:
            continue
        u = torch.zeros_like(lin.res)  # (d, N)
        for group, idx, J in zip(lin.groups, lin.idx, lin.jac):
            if group == fct.POINTS:
                u = u + (J * yl.index_select(0, idx).T[None]).sum(1)
        wu = u * w[None, :]
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                continue
            contrib = (J * wu[:, None, :]).sum(0)
            if group == fct.GRAVITY:
                y[group] = y[group] + contrib.sum(-1)
            else:
                y[group] = y[group] + fct.scatter_rows(ell, idx, contrib, y[group].shape[0])
    return Tangent(**y)


def map_columns(fn, x: Tangent, group: int | None = None) -> Tangent:
    """A Tangent -> Tangent function of one column applied to every column
    of x (trailing column axis): torch.vmap over a copy with the columns
    leading, so every column's sums run as in a single-column call (the same
    bits on the CPU); `group` columns a vmap at most (bounds the batched
    temporaries)."""
    C = x.gravity.shape[-1]
    group = C if group is None else max(1, min(group, C))
    outs = []
    for c in range(0, C, group):
        y = torch.vmap(fn)(Tangent(*(a[..., c:c + group].movedim(-1, 0).contiguous()
                                     for a in x)))
        outs.append(Tangent(*(a.movedim(0, -1) for a in y)))
    return outs[0] if len(outs) == 1 else Tangent(*(torch.cat(a, dim=-1) for a in zip(*outs)))


def reduced_matvec(lg, v, rs: ReducedSystem, x: Tangent) -> Tangent:
    """S x = (H_rr + damping) x - W H_ll^-1 W^T x (x with or without
    columns)."""
    if has_columns(x):
        return map_columns(lambda xc: reduced_matvec(lg, v, rs, xc), x)
    hx, _ = _hmatvec(lg, v, x, torch.zeros_like(v.points))
    # damping on reduced diagonal: diag*(1+lam)+lam => +lam*diag.x + lam*x
    damped = Tangent(*(h + rs.lam * (d * xv) + rs.lam * xv
                       for h, d, xv in zip(hx, rs.diag_r, x)))
    corr = _w_y(lg, v, _chol_solve(rs.H_ll_inv, _w_transpose_x(lg, v, x)))
    return t_sub(damped, corr)


def reduce_rhs(lg, v, rs: ReducedSystem, b_r: Tangent, b_l):
    """b~ = b_r - W H_ll^-1 b_l."""
    return t_sub(b_r, _w_y(lg, v, _chol_solve(rs.H_ll_inv, b_l)))


def back_substitute(lg, v, rs: ReducedSystem, x_r: Tangent, b_l):
    """x_l = H_ll^-1 (b_l - W^T x_r)."""
    return _chol_solve(rs.H_ll_inv, b_l - _w_transpose_x(lg, v, x_r))


def packed_pcg(mv, precond_inv, b: Tangent, max_iters: int, rel_tol):
    """Packed-state PCG (reference PCG.cpp:15-97) of the operator `mv`
    (Tangent -> Tangent) with block-Jacobi inverse blocks `precond_inv` (or
    None: identity).

    Runs exactly `max_iters` iterations with no host synchronization; the
    stop test rr > rel_tol^2 |b|^2 (checked before each iteration, as the
    JAX package's while_loop does) is an on-device mask that freezes x, r, p
    once met. Returns (x, rel, iters) with rel and iters as 0-d tensors.

    A right-hand side with columns (structure.has_columns: every field with
    a trailing axis of C columns) solves each column as its own system, one
    `mv` call on all of them an iteration; rel and iters are then (C,).
    Every column keeps its own dot products, alpha, beta, stop mask and
    iteration count. The state runs packed as (C, nb, K) (C = 1 without
    columns), so each column's dots and preconditioner sums reduce a
    contiguous row in the single-column order: a column's trajectory is
    that of its single-column solve (bit-equal on the CPU when `mv` is
    column-exact)."""
    cols = has_columns(b)
    counts, dims, K = pack_info(b)

    def pack(t):
        if cols:
            return pack_t(t, counts, dims, K).permute(2, 0, 1).contiguous()
        return pack_t(t, counts, dims, K)[None]

    def unpack(xp):
        return unpack_t(xp.permute(1, 2, 0) if cols else xp[0], counts, dims, K)

    def dot(a, c):
        return (a * c).reshape(a.shape[0], -1).sum(-1)  # (C,)

    def col(s):
        return s[:, None, None]

    bp = pack(b)
    Pm = pack_blocks(precond_inv, counts, dims, K) if precond_inv is not None else None

    def prec(rp):
        return rp if Pm is None else (Pm[None] * rp[:, :, None, :]).sum(-1)

    tol2 = float(rel_tol) ** 2
    x = torch.zeros_like(bp)
    r = bp
    p = prec(bp)
    rz = dot(bp, p)
    b_norm2 = dot(bp, bp)
    rr = b_norm2
    iters = torch.zeros(bp.shape[:1], dtype=torch.int64, device=bp.device)
    for _ in range(max_iters):
        active = rr > tol2 * b_norm2
        Ap = pack(mv(unpack(p)))
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x_n = x + col(alpha) * p
        r_n = r - col(alpha) * Ap
        z_n = prec(r_n)
        rz_n = dot(r_n, z_n)
        rr_n = dot(r_n, r_n)
        beta = rz_n / torch.where(rz == 0, torch.ones_like(rz), rz)
        p_n = z_n + col(beta) * p
        x = torch.where(col(active), x_n, x)
        r = torch.where(col(active), r_n, r)
        p = torch.where(col(active), p_n, p)
        rz = torch.where(active, rz_n, rz)
        rr = torch.where(active, rr_n, rr)
        iters = iters + active.to(torch.int64)
    rel = torch.sqrt(rr / torch.where(b_norm2 == 0, torch.ones_like(b_norm2), b_norm2))
    return (unpack(x), rel, iters) if cols else (unpack(x), rel[0], iters[0])


def pcg_solve(lg, v, rs: ReducedSystem, b: Tangent, max_iters: int, rel_tol):
    """Returns (x, final_rel_residual, iters) of the generic reduced system."""
    return packed_pcg(lambda x: reduced_matvec(lg, v, rs, x), rs.precond_inv, b, max_iters,
                      rel_tol)


def solve_step(cfgs, datas, lg, v, masks, lam, max_iters=250, rel_tol=1e-10,
               precond="gauss_seidel"):
    """Full damped GN solve: returns (step_tangent, step_points, model_cost_
    reduction, pcg_rel, pcg_iters, rs, (g_r, g_l)). Step is H^-1 grad (NOT
    yet negated), matching the reference convention (Optimizer.cpp:829-834)."""
    g_r, g_l = _accumulate_grad(lg, v)
    rs = build_reduced_system(lg, v, masks, lam, precond=precond)
    b = reduce_rhs(lg, v, rs, g_r, g_l)
    x_r, rel, iters = pcg_solve(lg, v, rs, b, max_iters, rel_tol)
    x_l = back_substitute(lg, v, rs, x_r, g_l)
    model_red = 0.5 * (t_dot(x_r, g_r) + (x_l * g_l).sum())
    return x_r, x_l, model_red, rel, iters, rs, (g_r, g_l)


def solve_with_system(lg, v, rs: ReducedSystem, g_r, g_l, max_iters=250, rel_tol=1e-10):
    """Re-solve with an existing reduced system (reference sub-step reusing
    the factorization, Optimizer.cpp:958-1000)."""
    b = reduce_rhs(lg, v, rs, g_r, g_l)
    x_r, _, _ = pcg_solve(lg, v, rs, b, max_iters, rel_tol)
    return x_r, back_substitute(lg, v, rs, x_r, g_l)
