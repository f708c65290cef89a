"""Runtime self-verification: numeric-vs-analytic Jacobians and the
nonlinearity debugger.

Port of `visual_inertial_bundle_adjustment_tpu/problem/verify.py`
(reference Optimizer::verifyJacobians, Factor.h:256-387,
Optimizer.cpp:73-86: a numeric check over a sample of every factor type in
a built problem; and the predicted-vs-actual cost-delta inspection,
--debug-nonlinearities-at, Optimizer.cpp:702-766).
"""

from __future__ import annotations

import numpy as np
import torch

from . import engine
from . import factors as fct
from .structure import retract, t_scale


def verify_jacobians(problem, sample=100, eps=1e-6, tol=1e-4, log=print):
    """Numeric-vs-analytic check over a factor sample of every batch.

    Returns True if every sampled Jacobian column matches central differences
    within `tol` (column-scaled)."""
    rng = np.random.default_rng(0)
    v = problem.variables
    masks = problem.masks
    ok_all = True
    for cfg, data in zip(problem.cfgs, problem.datas):
        lin = fct.linearize_batch(cfg, data, v, masks)
        n = lin.res.shape[-1]
        rows = rng.choice(n, size=min(sample, n), replace=False)
        spec = fct.REGISTRY[cfg.kind]
        args = spec["args"](v, data)
        jac = [J.double().cpu().numpy() for J in lin.jac]
        idx = [ix.cpu().numpy() for ix in lin.idx]
        mask = {g: getattr(masks, g).double().cpu().numpy() for g in set(lin.groups)}
        worst = 0.0
        for r in rows:
            ar = {k: a[r] for k, a in args.items()}
            zeros = tuple(torch.zeros(fct.GROUP_DIMS[g], dtype=v.points.dtype,
                                      device=v.points.device) for g, _ in spec["tangents"])
            for t_i, (g, _) in enumerate(spec["tangents"]):
                # this tangent among the (possibly filtered) lin entries: the
                # occurrence of group g it is
                positions = [k for k, gg in enumerate(lin.groups) if gg == g]
                occ = sum(1 for gg, _ in spec["tangents"][:t_i] if gg == g)
                if occ >= len(positions):
                    continue  # tangent dropped (constant group)
                k = positions[occ]
                m = mask[g]
                mrow = m if m.ndim == 1 else m[int(idx[k][r])]
                for d in range(fct.GROUP_DIMS[g]):
                    if mrow[d] == 0:  # analytic is mask-scaled: skip masked dims
                        continue

                    def f(x):
                        ts = list(zeros)
                        ts[t_i] = ts[t_i].clone()
                        ts[t_i][d] = x
                        res, _ = spec["local"](tuple(ts), ar, cfg)[1]
                        return res.double().cpu().numpy()

                    num = (f(eps) - f(-eps)) / (2 * eps)
                    ana = jac[k][:, d, r]
                    scale = max(np.abs(num).max(), 1.0)
                    worst = max(worst, np.abs(ana - num).max() / scale)
        status = "OK" if worst < tol else "MISMATCH"
        ok_all &= worst < tol
        log(f"verifyJacobians[{cfg.label or cfg.kind}]: worst col-rel err {worst:.2e} {status}")
    return ok_all


def debug_nonlinearities(problem, lam=1e-4, top=5, log=print):
    """Predicted-vs-actual per-batch cost deltas for one damped GN step
    (reference Optimizer.cpp:702-766): the factor classes whose actual cost
    change deviates most from the quadratic model."""
    cfgs, datas = tuple(problem.cfgs), tuple(problem.datas)
    v, masks = problem.variables, problem.masks
    lg = engine.linearize(cfgs, datas, v, masks)
    x_r, x_l, model_red, *_ = engine.solve_step(cfgs, datas, lg, v, masks, lam, max_iters=400,
                                                rel_tol=1e-12)
    v2 = retract(v, t_scale(x_r, -1.0), -x_l, masks)
    rows = []
    for cfg, data, stored in zip(cfgs, datas, lg.stored_cost):
        res, valid = fct.residual_batch(cfg, data, v2)
        cost_new, _ = engine._batch_cost_terms(cfg, res, valid)
        actual = float(cost_new.sum() - stored.sum())
        rows.append((cfg.label or cfg.kind, float(stored.sum()), actual))
    rows.sort(key=lambda r: r[2])
    log("nonlinearity debug (per batch cost deltas for one GN step):")
    for name, c0, dc in rows[: top + len(rows)]:
        log(f"  {name}: cost {c0:.6g}, actual delta {dc:+.6g}")
    log(f"  total model reduction: {float(model_red):.6g}")
    return rows
