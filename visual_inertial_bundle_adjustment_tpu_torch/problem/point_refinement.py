"""Per-landmark 3x3 mini-LM run before the full optimization.

Port of `visual_inertial_bundle_adjustment_tpu/problem/point_refinement.py`
(reference viba/problem/PointRefinement.cpp:22-196): five damped 3x3
Gauss-Newton iterations per landmark, all landmarks as one batch, with two
cost-increase step-halving retries.

The same function on what the card has: of the four evaluations in an
iteration only the first needs the landmark Jacobian, so the other three
(and the two of the log line) are residual-only passes (`residual_batch`:
K1 / K7 residual-only on a blocked batch); a blocked batch whose active
groups reach a fused linearizer (K1, K7, K11) takes it for the Jacobian and
keeps the landmark columns, any other differentiates the landmark columns
alone (AD). The per-landmark sums of cost, gradient and Gauss-Newton block
go through K13c (`seg_reduce_table`) over one landmark plan per batch, built
once per call on the batch's device: no atomics, a fixed summation order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops import losses
from ..ops import segments as seg
from . import factors as fct

NUM_ITERATIONS = 5  # reference PointRefinement.cpp
DAMPING = 1e-5
NUM_STEP_RETRIES = 2


class _PointBatch(NamedTuple):
    cfg: fct.BatchCfg  # residual-only passes
    lin_cfg: fct.BatchCfg  # the pass with the landmark Jacobian
    data: dict
    plan: seg.RowPlan  # the landmark lists of the batch's real slots
    real: torch.Tensor | None  # (N,) 1 on real slots of a blocked batch


def landmark_plan(point, pad, n_points) -> seg.RowPlan:
    """The landmark family of a batch's real slots (pad: 1 on padded slots,
    or None): each landmark's slots in slot order, built on their device."""
    pt = point.to(torch.int64)
    real = (torch.arange(pt.shape[0], device=pt.device) if pad is None
            else torch.nonzero(pad < 0.5).reshape(-1))
    pr = pt.index_select(0, real)
    obs = real.index_select(0, torch.argsort(pr, stable=True))
    ptr = torch.zeros(n_points + 1, dtype=torch.int64, device=pt.device)
    ptr[1:] = torch.cumsum(torch.bincount(pr, minlength=n_points), 0)
    i32 = torch.int32
    return seg.RowPlan(pt.to(i32), ptr.to(i32), obs.to(i32), scattered=True)


def point_batches(problem):
    """The batches with a landmark tangent, each with its landmark plan."""
    out = []
    L = problem.variables.points.shape[0]
    active_cfgs = getattr(problem, "active_cfgs", None) if problem._kernels else None
    for i, (cfg, data) in enumerate(zip(problem.cfgs, problem.datas)):
        if not any(g == fct.POINTS for g, _ in fct.REGISTRY[cfg.kind]["tangents"]):
            continue
        lin_cfg = dataclasses.replace(cfg, active_groups=(fct.POINTS,))
        if active_cfgs is not None and fct.fused_linearizer(active_cfgs[i]):
            lin_cfg = active_cfgs[i]
        pad = data.get("_pad")
        out.append(_PointBatch(cfg, lin_cfg, data, landmark_plan(data["point"], pad, L),
                               None if pad is None else 1.0 - pad))
    return out


def point_contrib(problem, b: _PointBatch, points, with_jac):
    """The per-slot table K13c sums over b's landmark plan: (1, N) robust
    cost, and with_jac (13, N) cost, gradient (3) and Gauss-Newton block (9);
    0 on padded slots."""
    v = problem.variables._replace(points=points)
    if with_jac:
        lin = fct.linearize_batch(b.lin_cfg, b.data, v, problem.masks)
        res, valid = lin.res, lin.valid  # (d, N)
        J = lin.jac[lin.groups.index(fct.POINTS)]  # (d, 3, N)
    else:
        res, valid = fct.residual_batch(b.cfg, b.data, v)
        res = res.T
    kind, a, k = b.cfg.loss
    val, der = losses.loss_jet2(int(kind), float(a), float(k), (res * res).sum(0))
    parts = [(0.5 * val * valid)[None]]
    if with_jac:
        w = der * valid
        parts.append((J * (w * res)[:, None, :]).sum(0))  # (3, N)
        Jw = J * w[None, None, :]
        parts.append((Jw[:, :, None, :] * J[:, None, :, :]).sum(0).reshape(9, -1))
    contrib = torch.cat(parts)
    if b.real is not None:
        contrib = contrib * b.real[None]
    return contrib.contiguous()


def _point_sums(problem, batches, points, with_jac):
    """Robust cost (L,) per landmark, and with_jac its gradient (L, 3) and
    Gauss-Newton block (L, 3, 3)."""
    L = points.shape[0]
    cost = points.new_zeros(L)
    grad = points.new_zeros((L, 3))
    hess = points.new_zeros((L, 3, 3))
    for b in batches:
        sums = seg.seg_reduce_table(point_contrib(problem, b, points, with_jac),
                                    b.plan)  # (L, 1 or 13)
        cost = cost + sums[:, 0]
        if with_jac:
            grad = grad + sums[:, 1:4]
            hess = hess + sums[:, 4:].reshape(L, 3, 3)
    return cost, grad, hess


def refine_points(problem, log=None):
    """Refine all landmarks in place; returns (new_points, info dict)."""
    pts0 = problem.variables.points
    if pts0.shape[0] == 0:
        return pts0, {}
    batches = point_batches(problem)
    eye = torch.eye(3, dtype=pts0.dtype, device=pts0.device)
    pts = pts0
    for _ in range(NUM_ITERATIONS):
        cost, grad, hess = _point_sums(problem, batches, pts, True)
        diag = torch.diagonal(hess, dim1=-2, dim2=-1)
        hd = hess + eye * (DAMPING * diag + DAMPING)[..., None, :]
        step = -torch.linalg.solve_ex(hd, grad[..., None])[0][..., 0]
        step = torch.where(torch.isfinite(step), step, torch.zeros_like(step))
        new_pts = pts + step
        new_cost = _point_sums(problem, batches, new_pts, False)[0]
        # reduced-step retry for landmarks whose cost increased
        for _ in range(NUM_STEP_RETRIES):
            step = torch.where((new_cost > cost)[:, None], step * 0.5, step)
            new_pts = pts + step
            new_cost = _point_sums(problem, batches, new_pts, False)[0]
        pts = torch.where((new_cost <= cost)[:, None], new_pts, pts)
    problem.variables = problem.variables._replace(points=pts)
    if log:
        c0 = _point_sums(problem, batches, pts0, False)[0]
        c1 = _point_sums(problem, batches, pts, False)[0]
        log(f"refinePoints: cost {float(c0.sum()):.6g} -> {float(c1.sum()):.6g}")
    return pts, {}
