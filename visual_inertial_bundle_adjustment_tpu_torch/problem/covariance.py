"""Covariances and marginal problems over the reduced camera system.

Port of `visual_inertial_bundle_adjustment_tpu/problem/covariance.py`
(reference lib/small_thing/Optimizer.cpp:356-696
sparseElimMarginalInformation, computeMarginalProblem,
computeJointCovariances, computeCovariances, and
viba/problem/SingleSessionProblem.cpp:66-138): the reference reorders
variables last and solves identity-seeded triangular systems against the
supernodal factor; here covariance columns are Schur-reduced PCG solves with
unit right-hand sides against one linearization.

The columns of a chunk solve together: the right-hand side carries a
trailing column axis (structure.has_columns) through engine.packed_pcg, so
one PCG iteration serves every column of the chunk. On the blocked engine a
single-pass visual batch runs the column-batched K4 or K9
(ops/segments.py seg_schur_pcg_cols / seg_schur_pcg_cal_cols) over the
batch's point-sorted slot records, made once in prepare_system
(rcs.with_column_records), each record read once a pass for a tile of 32
columns; the generic engine batches its matvec over the columns.
(The JAX package scans the columns one after another on its blocked engine
and vmaps PCG on its generic one.) Every column still runs its own PCG: its
own dots, step sizes, stop mask and iteration count.

The gauge must be fixed first: SingleSessionProblem::computeCovariances adds
a position+yaw prior on the first rig (PriorFactor.cpp:17-32) and removes it
after; `with_gauge_prior` does the same on the problem's batch list.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import engine, rcs
from . import factors as fct
from .structure import Masks, Tangent, apply_masks, full_masks, retract, zero_tangent

GAUGE_POS_STD = 1e-4  # tight position prior
GAUGE_YAW_STD = 1e-4  # tight yaw-about-gravity prior


@contextlib.contextmanager
def with_gauge_prior(problem, rig_index: int = 0):
    """Temporarily constrain position+yaw of one rig (PriorFactor.cpp:17-32)."""
    v = problem.variables
    kw = dict(dtype=v.points.dtype, device=v.points.device)
    data = {
        "rig": torch.tensor([rig_index], dtype=torch.int32, device=v.points.device),
        "ref_q": v.pose_q[rig_index][None].clone(),
        "ref_t": v.pose_t[rig_index][None].clone(),
        "sqrt_h_pos": torch.full((1, 3), 1.0 / GAUGE_POS_STD, **kw),
        "sqrt_h_yaw": torch.full((1, 1), 1.0 / GAUGE_YAW_STD, **kw),
    }
    problem.add_batch(fct.BatchCfg(kind="position_yaw_prior", label="gauge"), data)
    try:
        yield problem
    finally:
        problem.pop_batch()


def _unit_tangents(v, entries):
    """Tangent of K unit columns (trailing column axis) for
    [(group, row, dim), ...]."""
    K = len(entries)
    t = {f: a.new_zeros(a.shape + (K,)) for f, a in zero_tangent(v)._asdict().items()}
    for k, (group, row, dim) in enumerate(entries):
        if group == fct.GRAVITY:
            t[group][dim, k] = 1.0
        else:
            t[group][row, dim, k] = 1.0
    return Tangent(**t)


def prepare_system(problem, lam=1e-9):
    """Linearize ONCE and build the damped reduced system: the analog of the
    reference's single factorization reused for every covariance column
    (Optimizer.cpp:574-604).

    When the problem carries a blocked layout (large visual batches through
    rcs.finalize_blocks, unless `problem.use_blocked_engine` is off) the
    system is assembled by the blocked engine (rcs.assemble +
    with_damping) and the columns solve against its Schur matvec; small
    problems keep the generic engine."""
    problem._build()  # blocks large visual batches
    datas = tuple(problem.datas)
    v, masks = problem.variables, problem.masks
    cfgs = engine.prune_cfgs(tuple(problem.cfgs), masks)
    lg = engine.linearize(cfgs, datas, v, masks)
    if any(c.block_info is not None for c in cfgs):
        rs = rcs.with_damping(rcs.assemble(cfgs, datas, lg, v, masks), v, masks, lam)
        return lg, rcs.with_column_records(rs)
    return lg, engine.build_reduced_system(lg, v, masks, lam)


def system_is_blocked(system) -> bool:
    return isinstance(system[1], rcs.RcsSystem)


def solve_columns(problem, entries, lam=1e-9, pcg_iters=800, pcg_tol=1e-12, system=None,
                  chunk=256):
    """Columns of H^-1 (reduced part) for the requested tangent entries.

    One linearization for ALL columns; they solve in chunks of `chunk`
    columns, each chunk one column-batched PCG (memory: chunk x the reduced
    state, and on the blocked engine the column kernels' z and window
    partials, chunk x (3 a landmark + kc a (rig, window row) pair)).
    Returns a Tangent whose fields carry a trailing axis of K = len(entries)
    columns (rig (R, 12, K), gravity (2, K))."""
    v = problem.variables
    lg, rs = system if system is not None else prepare_system(problem, lam)
    if isinstance(rs, rcs.RcsSystem):
        def solve(b):
            return rcs.pcg(rs, v, b, pcg_iters, pcg_tol)[0]
    else:
        def solve(b):
            return engine.pcg_solve(lg, v, rs, b, pcg_iters, pcg_tol)[0]
    outs = [solve(_unit_tangents(v, entries[i:i + chunk]))
            for i in range(0, len(entries), chunk)]
    if len(outs) == 1:
        return outs[0]
    return Tangent(*(torch.cat(a, dim=-1) for a in zip(*outs)))


def _numpy(t: Tangent):
    return Tangent(*(a.detach().to(torch.float64).cpu().numpy() for a in t))


def _extract_cov(cols, entries):
    K = len(entries)
    cols = _numpy(cols)
    cov = np.zeros((K, K))
    for j in range(K):
        for i, (gi, ri, di) in enumerate(entries):
            a = getattr(cols, gi)
            cov[i, j] = a[di, j] if gi == fct.GRAVITY else a[ri, di, j]
    # symmetrize (PCG solves are only approximately symmetric)
    return 0.5 * (cov + cov.T)


def joint_covariance(problem, entries, **kw):
    """K x K covariance over the requested tangent entries (gauge-fixed).

    entries: [(group, row, dim), ...]. The caller should use with_gauge_prior
    when the problem has unconstrained gauge freedom."""
    return _extract_cov(solve_columns(problem, entries, **kw), entries)


def rig_covariances(problem, rig_indices, lam=1e-9, **kw):
    """Per-rig 12x12 joint covariance blocks (pose+vel+omega), gauge-fixed.

    Reference SingleSessionProblem::computeCovariances (.cpp:66-138): ONE
    linearization for the whole request; all 12*len(rig_indices) columns run
    as chunked column-batched PCG against the same reduced system."""
    out = {}
    with with_gauge_prior(problem):
        system = prepare_system(problem, lam)
        entries = [(fct.RIG, int(r), d) for r in rig_indices for d in range(12)]
        rig = _numpy(solve_columns(problem, entries, lam=lam, system=system, **kw)).rig
        for k, r in enumerate(rig_indices):
            block = rig[int(r), :, 12 * k:12 * (k + 1)]
            out[int(r)] = 0.5 * (block + block.T)
    return out


def calib_covariances(problem, group: str, rows, lam=1e-9, **kw):
    """Joint covariance blocks of calibration-window variables.

    Reference SingleSessionProblem::computeCovariances (.cpp:66-138) also
    extracts per-calibration-variable joint covariances; `group` is one of
    'cam_intr', 'cam_extr', 'imu_calib', 'imu_extr', 'det_bias'. Disabled
    tangent dims (mask 0) are skipped; the returned block covers only the
    enabled dims, with `dims` listing them. One linearization serves every
    requested row."""
    marr = getattr(problem.masks, group).detach().cpu().numpy()
    out = {}
    with with_gauge_prior(problem):
        all_entries, row_dims = [], {}
        for r in rows:
            dims = [d for d in range(marr.shape[1]) if marr[int(r), d] > 0.5]
            row_dims[int(r)] = dims
            all_entries += [(group, int(r), d) for d in dims]
        if not all_entries:
            return {int(r): (np.zeros((0, 0)), []) for r in rows}
        system = prepare_system(problem, lam)
        arr = getattr(_numpy(solve_columns(problem, all_entries, lam=lam, system=system, **kw)),
                      group)
        pos = 0
        for r in rows:
            dims = row_dims[int(r)]
            if not dims:
                out[int(r)] = (np.zeros((0, 0)), [])
                continue
            block = arr[int(r)][np.ix_(dims, range(pos, pos + len(dims)))]
            out[int(r)] = (0.5 * (block + block.T), dims)
            pos += len(dims)
    return out


def update_under_conditioning(problem, cond_t, cond_points, cond_masks, lam=1e-9,
                              pcg_iters=800, pcg_tol=1e-12):
    """Apply `cond_t`/`cond_points` to the conditioned dims (cond_masks=1)
    and move every other free variable to the conditional optimum of the
    quadratic model: x_o = -H_oo^-1 H_oc u.

    Reference Optimizer::updateUnderConditioning (Optimizer.cpp:381-420):
    partial Cholesky up to the non-conditioned block + back-substitution of
    the conditioned update. Returns the updated VariableTables (the caller
    decides whether to store them on the problem)."""
    v, masks = problem.variables, problem.masks
    cfgs, datas = tuple(problem.cfgs), tuple(problem.datas)
    # free dims excluding the conditioned ones
    m_o = Masks(*(a * (1.0 - c) for a, c in zip(masks, cond_masks)))
    u_t = apply_masks(cond_t, cond_masks)
    u_p = cond_points * cond_masks.points

    # H_oc u needs Jacobian columns for the conditioned dims -> full masks;
    # the H_oo solve must NOT move them -> re-linearize with them masked out
    lg_full = engine.linearize(engine.prune_cfgs(cfgs, masks), datas, v, masks)
    y_r, y_p = engine._hmatvec(lg_full, v, u_t, u_p)
    y_r = apply_masks(y_r, m_o)
    y_p = y_p * m_o.points
    lg = engine.linearize(engine.prune_cfgs(cfgs, m_o), datas, v, m_o)
    rs = engine.build_reduced_system(lg, v, m_o, lam)
    b = engine.reduce_rhs(lg, v, rs, Tangent(*(-a for a in y_r)), -y_p)
    x_r, _, _ = engine.pcg_solve(lg, v, rs, b, pcg_iters, pcg_tol)
    x_l = engine.back_substitute(lg, v, rs, x_r, -y_p)

    step_t = Tangent(*(a + bb for a, bb in zip(u_t, apply_masks(x_r, m_o))))
    step_p = u_p + x_l * m_o.points
    return retract(v, step_t, step_p, full_masks(v))


def marginal_information(problem, entries, **kw):
    """Marginal information over the entries: inv(E^T H^-1 E).

    Reference computeMarginalProblem (Optimizer.cpp:422-494): the marginal of
    the full problem onto a variable subset, re-injectable as a condensed
    factor."""
    return np.linalg.inv(joint_covariance(problem, entries, **kw))
