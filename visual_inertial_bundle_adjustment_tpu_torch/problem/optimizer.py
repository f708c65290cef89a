"""Levenberg-Marquardt driver with reference-parity control flow.

Port of `visual_inertial_bundle_adjustment_tpu/problem/optimizer.py`
(reference lib/small_thing/Optimizer.cpp:768-1106):

  - damping schedule: init 1e-5, x2.5 on fail, x0.7 on good, x1.5 on average,
    abort above 1e8 (Settings, Optimizer.h:40-91)
  - model-cost-reduction sanity retry (Optimizer.cpp:835-854)
  - step-factor retries with gradient-interpolated shrink factor and the
    optional sub-step re-solve reusing the damped system (Optimizer.cpp:907-1011)
  - failure-rate policy (Optimizer.cpp:888-891), comparable-cost caching
    (Factor.h:391-417), dontRetryFailed freezing (Optimizer.cpp:1002-1007)
  - troubled-sequence accounting and the tolerance-held-for-N-iterations stop
    (Optimizer.cpp:1032-1096)

One iteration: linearize (K1 or K7 + AD of the small batches) -> assemble
(K2 or K8) -> damp and precondition (K3) -> Schur RHS (K5 or K10 up) ->
packed PCG (K4 or K9) -> back-substitute (K6 or K10 down) -> retract ->
comparable cost (K1 or K7 residual-only). PyTorch runs eagerly:
`Problem._build` returns plain callables in place of jits.

Divergences from the JAX package, fixing its queue-C faults (ROADMAP §C):
the linearization + assembly survive damping retries and are recomputed
only at an accepted point, so a rejected step pays no discarded linearize
(fault 2); there is no compile-failure fallback to misfire (fault 1); the
new cost comes from the residual-only pass, equal to the JAX carry path's
bookkeeping value (engine.comparable_from_linearized) up to rounding.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from . import engine
from . import factors as fct
from . import rcs
from .structure import (Masks, VariableTables, retract, step_to_var_ratios, t_dot,
                        t_scale, tables_to)


@dataclasses.dataclass
class LMSettings:
    """Reference lib/small_thing/Optimizer.h:40-91 defaults."""

    max_iterations: int = 50
    pcg_max_iterations: int = 40
    pcg_tol: float = 1e-10
    direct_mode: bool = True  # small problems: PCG to tight tolerance
    direct_pcg_iterations: int = 500
    # preconditioner family: gauss_seidel | jacobi | lower_prec | identity
    preconditioner: str = "gauss_seidel"

    absolute_cost_tolerance: float = 1e-8
    relative_cost_tolerance: float = 1e-10
    variables_tolerance: float = 1e-5

    stop_if_no_improvement_for: int = 3
    distance_from_troubled_iteration: int = 3
    damping: float = 1e-5
    damping_adjust_on_fail: float = 2.5
    damping_adjust_on_good_step: float = 0.7
    damping_adjust_on_average_step: float = 1.5
    damping_max: float = 1e8
    damping_min: float = 1e-9

    min_relative_cost_reduction: float = 0.3
    step_factor_decrease: float = 0.3
    max_step_factor_attempts: int = 2
    try_sub_step: bool = True
    min_step_factor_for_good: float = 0.7

    log: Optional[Callable[[str], None]] = None
    pre_step_callback: Optional[Callable[[int, "Problem"], None]] = None
    # called at the end of every iteration with a monitoring dict
    iteration_callback: Optional[Callable[[dict], None]] = None


@dataclasses.dataclass
class Summary:
    initial_cost: float = 0.0
    final_cost: float = 0.0
    num_troubled_seqs: int = 0
    largest_troubled_seq: int = 0
    num_iterations: int = 0
    iteration_times: list = dataclasses.field(default_factory=list)


class Problem:
    """A factor graph: variable tables + masks + factor batches (reference
    SingleSessionProblem + Optimizer ownership of stores, Optimizer.h:332-335).
    Batches with zero factors are dropped. `use_blocked_engine = False`
    keeps _build from blocking the visual batches (the JAX package's switch,
    its optimizer.py:144): the generic engine then solves the problem."""

    def __init__(self, variables: VariableTables, masks: Masks):
        self.variables = variables
        self.masks = masks
        self.cfgs: list = []
        self.datas: list = []
        self.use_blocked_engine = True
        # parallel/sharding.py: the mesh of a sharded problem (None: one
        # device) and its landmark and table halo plans
        self.mesh = None
        self.pt_plan = None
        self.t_plans = {}
        self._kernels = None
        self.active_cfgs = None

    def add_batch(self, cfg, data):
        n = 0
        for a in data.values():
            if isinstance(a, torch.Tensor) and a.ndim >= 1:
                n = a.shape[0]
                break
        if n == 0:
            return
        self.cfgs.append(cfg)
        self.datas.append(data)
        self._invalidate()

    def pop_batch(self):
        """Remove the last batch (covariance.with_gauge_prior's prior)."""
        self.cfgs.pop()
        self.datas.pop()
        self._invalidate()

    def _invalidate(self):
        """Drop the iteration callables and resolved cfgs: the next _build
        re-resolves them and adds the transpose plans of new batches."""
        self._kernels = None
        self.active_cfgs = None

    def to(self, device=None, dtype=None):
        """Move every table and batch to `device`, floats to `dtype` (a
        batch's NamedTuple payloads, such as the RS tables, field by field)."""

        def move(a):
            if isinstance(a, tuple):
                return type(a)(*(move(x) for x in a))
            return a.to(device=device, dtype=dtype) if a.is_floating_point() else a.to(device)

        self.variables = tables_to(self.variables, device, dtype)
        self.masks = tables_to(self.masks, device, dtype)
        self.datas = [{k: move(a) for k, a in d.items()} for d in self.datas]
        self._kernels = None
        return self

    def _build(self):
        """Block the visual batches (host, once), resolve the static active
        groups from the masks, build the small batches' transpose plans, and
        return the iteration callables (the blocked solver's, or the generic
        engine's when no batch is blocked) (k_linearize, k_solve, k_resolve,
        k_cost, k_grad, k_retract, k_assemble, k_step). A sharded problem
        (parallel/sharding.py) takes build_sharded_kernels' (the JAX
        package's choice, its optimizer.py:133-141)."""
        if self._kernels is not None:
            return self._kernels
        if self.mesh is not None:
            from ..parallel.sharding import build_sharded_kernels

            self._kernels = build_sharded_kernels(self)
            return self._kernels
        if self.use_blocked_engine:
            rcs.finalize_blocks(self)
        # no blocked batch: the generic Schur-reduced engine solves the
        # problem (the JAX package's choice, its optimizer.py:182-212)
        blocked = any(c.block_info is not None for c in self.cfgs)
        self._kernels = iteration_kernels(self.resolve_cfgs(), blocked)
        return self._kernels

    def resolve_cfgs(self):
        """Build the small batches' transpose plans and resolve the static
        active groups from the masks: the cfgs the iteration callables run
        (also kept as `active_cfgs`)."""
        v = self.variables
        rows = {
            fct.RIG: v.pose_q.shape[0], fct.POINTS: v.points.shape[0],
            fct.CAM_INTR: v.cam_intr.shape[0], fct.CAM_EXTR: v.cam_extr_q.shape[0],
            fct.IMU_CALIB: v.imu_calib.shape[0], fct.IMU_EXTR: v.imu_extr_q.shape[0],
            fct.DET_BIAS: v.det_bias.shape[0], fct.GRAVITY: 1,
        }
        fct.build_transpose_plans(self.cfgs, self.datas, rows)
        self.active_cfgs = engine.prune_cfgs(self.cfgs, self.masks)
        return self.active_cfgs

    def initial_alive(self):
        return tuple(torch.ones(fct._batch_size(d), dtype=self.variables.points.dtype,
                                device=self.variables.points.device) for d in self.datas)


def iteration_kernels(cfgs, blocked, axis=None):
    """The iteration callables (k_linearize, k_solve, k_resolve, k_cost,
    k_grad, k_retract, k_assemble, k_step) of resolved cfgs: the blocked
    solver's, or the generic engine's when no batch is blocked.

    Sharded (`axis` a mesh, parallel/sharding.py), the batches are the
    rank's and the tables replicated: every scalar and table summed over the
    factors is all-reduced where the JAX package psums it (the cost and the
    failure counts, the assembly, the preconditioner blocks, the Schur
    right-hand side and back-substitution, the comparable cost, the
    gradient), and the PCG rides the mesh's halo plans. Every accept or
    reject decision of optimize() then reads the same sums on every rank,
    and the ranks keep bit-equal variables."""

    def all_sum(*xs):
        return xs if axis is None else tuple(axis.all_reduce(list(xs)))

    def k_linearize(datas, v, masks, alive):
        lg = engine.linearize(cfgs, datas, v, masks, alive)
        if axis is None:
            return lg
        cost, n_inv, n_opt = all_sum(lg.cost, lg.num_invalid, lg.num_optional)
        return lg._replace(cost=cost, num_invalid=n_inv, num_optional=n_opt)

    def k_assemble(datas, lg, v, masks):
        # the generic engine assembles inside its solve
        return rcs.assemble(cfgs, datas, lg, v, masks, axis) if blocked else None

    def k_solve(asm, datas, lg, v, masks, lam, max_iters, rel_tol, precond="gauss_seidel"):
        if blocked:
            return rcs.solve_assembled(asm, v, masks, lam, max_iters, rel_tol, precond, axis)
        return engine.solve_step(cfgs, datas, lg, v, masks, lam, max_iters, rel_tol, precond,
                                 axis=axis)

    def k_resolve(lg, v, rs, g_r, g_l, max_iters, rel_tol):
        if blocked:
            return rcs.solve_with_system(lg, v, rs, g_r, g_l, max_iters, rel_tol, axis)
        return engine.solve_with_system(lg, v, rs, g_r, g_l, max_iters, rel_tol, axis=axis)

    def k_cost(datas, v, lg):
        return engine.CostStats(*all_sum(*engine.comparable_cost(cfgs, datas, v, lg)))

    def k_grad(datas, v, masks):
        return engine.gradient_tangent(cfgs, datas, v, masks, axis)

    def k_retract(v, t, tp, masks, scale):
        t2 = t_scale(t, scale)
        return retract(v, t2, tp * scale, masks), step_to_var_ratios(v, t2, tp * scale)

    def k_step(asm, datas, lg, v, masks, lam, max_iters, rel_tol, precond="gauss_seidel"):
        """Solve + retract + comparable cost + norms of one LM attempt."""
        out = k_solve(asm, datas, lg, v, masks, lam, max_iters, rel_tol, precond)
        x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l) = out
        step_r, step_l = t_scale(x_r, -1.0), -x_l
        v_new = retract(v, step_r, step_l, masks)
        ratios = step_to_var_ratios(v, step_r, step_l)
        stats = k_cost(datas, v_new, lg)
        grad_norm = torch.sqrt(t_dot(g_r, g_r) + (g_l * g_l).sum())
        step_norm = torch.sqrt(t_dot(step_r, step_r) + (step_l * step_l).sum())
        return (x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l),
                v_new, ratios, stats, grad_norm, step_norm)

    return (k_linearize, k_solve, k_resolve, k_cost, k_grad, k_retract, k_assemble, k_step)


def _host(*xs):
    """Fetch a group of 0-d device values in one transfer."""
    return [float(a) for a in torch.stack([torch.as_tensor(x, dtype=torch.float64)
                                           .to(xs[0].device) for x in xs]).cpu()]


def optimize(problem: Problem, settings: LMSettings) -> Summary:
    (k_lin, k_solve, k_resolve, k_cost, k_grad, k_retract,
     k_assemble, k_step) = problem._build()
    log = settings.log or (lambda s: None)
    datas = tuple(problem.datas)
    masks = problem.masks
    v = problem.variables
    alive = problem.initial_alive()

    damping = settings.damping
    pcg_iters = (settings.direct_pcg_iterations if settings.direct_mode
                 else settings.pcg_max_iterations)

    summary = Summary()
    iteration = 0
    last_improvement_iteration = 0
    last_troubled_iteration = -10
    troubled_seq_start_damping = damping
    troubled_seq_start = 0
    dont_retry_failed = False
    initial_cost = None
    final_cost = None
    linearized = None  # (lg, asm) at the current v, kept across rejected steps

    while True:
        t_it = time.time()
        if settings.pre_step_callback is not None:
            settings.pre_step_callback(iteration, problem)
            datas = tuple(problem.datas)
            linearized = None  # the callback may mutate factor data in place
        if linearized is None:
            lg = k_lin(datas, v, masks, alive if dont_retry_failed else None)
            linearized = (lg, k_assemble(datas, lg, v, masks))
        lg, asm = linearized
        if dont_retry_failed:
            alive = lg.valid0

        # solve + retract + cost, with the model-cost sanity retry
        # (Optimizer.cpp:835-854); one host transfer per attempt
        while True:
            (x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l), v_new,
             (ratio_inf, ratio_2), stats, grad_norm, step_norm) = k_step(
                asm, datas, lg, v, masks, damping, pcg_iters, settings.pcg_tol,
                settings.preconditioner)
            (prev_cost, model_red, pcg_rel, pcg_it, new_cost, grad_norm, step_norm,
             ratio_inf, ratio_2, s_inv, s_pinv, s_tot) = _host(
                lg.cost, model_red, pcg_rel, pcg_it, stats.cost, grad_norm, step_norm,
                ratio_inf, ratio_2, stats.num_invalid, stats.num_prev_invalid,
                stats.num_total)
            stats = engine.CostStats(new_cost, s_inv, s_pinv, s_tot)
            if model_red >= 0:
                break
            damping *= settings.damping_adjust_on_fail
            log(f" ?:# quadratic model failing numerically, retrying... (damping: {damping:g})")
            if damping > settings.damping_max:
                break
        if initial_cost is None:
            initial_cost = prev_cost
        if final_cost is None:
            final_cost = prev_cost
        if model_red < 0:
            log("damping out of range, quadratic model failing?!")
            break

        # step = -H^-1 g
        step_r, step_l = t_scale(x_r, -1.0), -x_l
        cost_reduction = prev_cost - new_cost
        ratio_reduction_to_cost = cost_reduction / new_cost if new_cost else 0.0
        ratio_reduction_to_expected = cost_reduction / model_red if model_red else 0.0
        applied_step_factor = 1.0

        def failure_rate_ok(st):
            inv, prev_inv, tot = float(st.num_invalid), float(st.num_prev_invalid), \
                float(st.num_total)
            return (inv / (tot + 1.0) < 0.03) and (inv < prev_inv * 2.0 + 50)

        failure_ok = failure_rate_ok(stats)

        # step-factor retries (Optimizer.cpp:907-1011)
        if settings.max_step_factor_attempts > 0 and (
            ratio_reduction_to_expected < settings.min_relative_cost_reduction or not failure_ok
        ):
            g_new_r, g_new_l = k_grad(datas, v_new, masks)
            back_red = -0.5 * float(t_dot(g_new_r, step_r) + (g_new_l * step_l).sum())
            step_factor = (model_red / (model_red + back_red) if back_red > 0
                           else settings.step_factor_decrease)
            for _ in range(settings.max_step_factor_attempts):
                applied_step_factor *= step_factor
                v_new, (ratio_inf, ratio_2) = k_retract(v, step_r, step_l, masks,
                                                        applied_step_factor)
                stats_f = k_cost(datas, v_new, lg)
                new_cost_f = float(stats_f.cost)
                red_f = prev_cost - new_cost_f
                rel_f = red_f / (model_red * applied_step_factor) if model_red else 0.0
                if rel_f >= settings.min_relative_cost_reduction and failure_rate_ok(stats_f):
                    new_cost, stats = new_cost_f, stats_f
                    cost_reduction = red_f
                    ratio_reduction_to_expected = rel_f
                    failure_ok = True
                    log(f" \\!/ cost reduction obtained applying factor {applied_step_factor:.2f}")
                    break

                if settings.try_sub_step:
                    g2_r, g2_l = k_grad(datas, v_new, masks)
                    s2_r, s2_l = k_resolve(lg, v, rs, g2_r, g2_l, pcg_iters, settings.pcg_tol)
                    v_sub, _ = k_retract(v_new, t_scale(s2_r, -1.0), -s2_l, masks, 1.0)
                    stats_s = k_cost(datas, v_sub, lg)
                    new_cost_s = float(stats_s.cost)
                    red_s = prev_cost - new_cost_s
                    rel_s = red_s / (model_red * applied_step_factor) if model_red else 0.0
                    if rel_s >= settings.min_relative_cost_reduction and failure_rate_ok(stats_s):
                        v_new = v_sub
                        new_cost, stats = new_cost_s, stats_s
                        cost_reduction = red_s
                        ratio_reduction_to_expected = rel_s
                        failure_ok = True
                        log(f" \\!/ cost reduction obtained applying factor "
                            f"{applied_step_factor:.2f} + sub-step")
                        break

                if not dont_retry_failed:
                    dont_retry_failed = True
                    log(" \\!/ failing factors will no longer be retried!")
                step_factor = settings.step_factor_decrease

        tolerance_hit = None
        if ratio_reduction_to_cost < settings.relative_cost_tolerance:
            tolerance_hit = "relative cost"
        elif cost_reduction < settings.absolute_cost_tolerance:
            tolerance_hit = "absolute cost"
        elif float(ratio_2) < settings.variables_tolerance:
            tolerance_hit = "variable"

        if new_cost > prev_cost or not failure_ok:  # failure: v and (lg, asm) kept
            if last_troubled_iteration != iteration - 1:
                troubled_seq_start_damping = damping
                troubled_seq_start = iteration
            smiley = ":'("
            damping *= settings.damping_adjust_on_fail
            if damping > settings.damping_max:
                log("damping out of range, quadratic model failing?!")
                iteration += 1
                break
            last_troubled_iteration = iteration
        else:
            if last_troubled_iteration == iteration - 1:
                if troubled_seq_start_damping < 1e1 and damping > 1e-3:
                    summary.num_troubled_seqs += 1
                    summary.largest_troubled_seq = max(
                        summary.largest_troubled_seq, iteration - troubled_seq_start)
            if (ratio_reduction_to_expected >= settings.min_relative_cost_reduction
                    and applied_step_factor > settings.min_step_factor_for_good):
                smiley = ";-|" if tolerance_hit else ":-)"
                damping = max(damping * settings.damping_adjust_on_good_step,
                              settings.damping_min)
            else:
                smiley = ":-/"
                damping *= settings.damping_adjust_on_average_step
            v = v_new
            final_cost = new_cost
            linearized = None  # re-linearize at the accepted point (Optimizer.cpp:809)

        iteration += 1
        dt = time.time() - t_it
        summary.iteration_times.append(dt)
        if settings.iteration_callback is not None:
            settings.iteration_callback(dict(
                iteration=iteration,
                cost=new_cost if new_cost <= prev_cost else prev_cost,
                prev_cost=prev_cost,
                new_cost=new_cost,
                damping=damping,
                accepted=new_cost <= prev_cost and failure_ok,
                model_cost_reduction=model_red,
                applied_step_factor=applied_step_factor,
                pcg_iters=int(pcg_it),
                pcg_rel_residual=float(pcg_rel),
                grad_norm=grad_norm,
                step_norm=step_norm,
                num_failing=int(stats.num_invalid),
                num_failing_prev=int(stats.num_prev_invalid),
                num_optional_total=int(stats.num_total),
                iter_time_sec=dt,
            ))
        log(
            f" {smiley} cost: {prev_cost:.6g} -> {new_cost:.6g} "
            f"({(new_cost / prev_cost - 1.0) * 100:.2f}%), t: {dt:.3f}s\n"
            f"     n.{iteration}; pcg: {int(pcg_it)} iters, rel {float(pcg_rel):.2e}\n"
            f"     lmbd: {damping:.3g}, relRed: {ratio_reduction_to_expected * 100:.1f}%, "
            f"improv: {cost_reduction:.6g}, modelImprov: {model_red:.6g}\n"
            f"    |G|: {grad_norm:.4g}, |S|: {step_norm:.4g}, "
            f"|s/v|_inf: {float(ratio_inf):.3g}, |_2: {float(ratio_2):.3g}\n"
            f"    Failing factors: {int(stats.num_prev_invalid)} -> {int(stats.num_invalid)}"
            f" / {int(stats.num_total)}"
        )

        if not tolerance_hit:
            last_improvement_iteration = iteration
        if (iteration >= last_improvement_iteration + settings.stop_if_no_improvement_for
                and iteration >= last_troubled_iteration
                + settings.distance_from_troubled_iteration):
            log(f" >_< converged! (hit {tolerance_hit} tolerance, for "
                f"{settings.stop_if_no_improvement_for} iterations)")
            break
        if iteration >= settings.max_iterations:
            log(f" X-| iteration limit reached! ({settings.max_iterations} iterations)")
            break

    problem.variables = v
    summary.initial_cost = initial_cost or 0.0
    summary.final_cost = final_cost if final_cost is not None else (initial_cost or 0.0)
    summary.num_iterations = iteration
    return summary


# reference viba/common/Settings.cpp:296-320 + Constants.h:15: the direct
# solver is used below 20000 rigs, Gauss-Seidel-preconditioned PCG above
PCG_NUM_RIGS_THRESHOLD = 20_000


def pick_solver(settings: LMSettings, num_rigs: int, solver_type: str = "auto") -> LMSettings:
    """Resolve the solver choice (auto/direct/gauss-seidel/jacobi/identity/
    lower-prec) into LMSettings, mirroring pickSolverType."""
    st = solver_type.replace("-", "_")
    if st == "auto":
        st = "direct" if num_rigs < PCG_NUM_RIGS_THRESHOLD else "gauss_seidel"
    if st == "direct":
        settings.direct_mode = True
        settings.preconditioner = "gauss_seidel"
    else:
        settings.direct_mode = False
        settings.preconditioner = st
    return settings
