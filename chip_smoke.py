#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's four main paths through the entry points a user calls:

  bias-only    the 120 s headline (1,200 rigs, 20,000 landmarks, ~394k
               Fisheye624 observations, one inertial chain with IMU bias)
               through `pipeline.builder.build_synthetic_problem` and
               `problem.optimizer.optimize` (kernels K1-K6);
  full-sensor  a 600 s Aria-style session with two IMUs and a rolling-shutter
               camera, readout and time offset estimated (6,000 rigs, 120
               five-second calibration windows, ~60k landmarks, ~1.75M
               observations) through `pipeline.synthetic_io.write_session_dir`
               -> `pipeline.session_data.load_session` ->
               `pipeline.adapter.SessionAdapter(...).build()` -> `optimize`
               (kernels K7-K10 and K3 at rig_k = 9);
  gs_cal       the same session recorded by a global-shutter camera (written
               with `readout_time_sec=None`), built with the adapter's default
               options, which estimate the camera intrinsics and extrinsics:
               K11 linearizes, K1 gives the cost, K8-K10 and K3 run at
               rig_k = 6;
  two_grid     the bias-only build on a 120 s session whose 6,000 landmarks are
               re-observed over the whole session (`track_lifetime_sec=None`,
               ~3.1M observations): no per-tile landmark window fits, so the
               solver takes its general path (K1, K12, K13a-c);
  profile      on the two_grid problem, the general-path Schur matvec composed
               from the tile-partials kernels K14a-e on the rig-sorted grid
               and the point-sorted second grid
               (`profile_matvec.setup` / `check` / `profile`), held against
               rcs.matvec and timed component by component against the
               K12/K13 route.

Phases, one printed line each (per path):

  device       the card's name and power limit (nvidia-smi); TF32 off
  build        nvcc build of csrc/*.cu (one nvcc per source, in parallel);
               ptxas registers and spills of the kernels
  problem      the problem build, per stage
  kernels      each CUDA kernel against its plain PyTorch version on the card
               at the problem's real shapes (J from one linearization): error
               relative to the max-abs of the plain version evaluated in
               float64 on the same inputs; median times of the kernel and of
               the plain version in float32; the kernel's device time and
               device operations per call (torch.profiler; no host copy may
               be among them); the least time the card could take (bound).
               K1 (with the Jacobian and residual-only, at the bias, two_grid
               and gs_cal shapes) and K11 against the designs they replaced
               (C entries only this script reaches), in turns: residuals
               bit-equal, Jacobians within 1e-5; K4 and K9 beside their two-pass
               floors; K13a on the two-grid landmark rows against the walk on
               the same rows; K13c on those rows (D 9, D 3) against the walk
               and index_add_
  consistency  one LM iteration through the kernels vs the plain versions,
               from the initial state: new cost, reduced step and the step of
               the well-conditioned landmarks; and the kernel-path attempt run
               twice, bit-equal (no float atomics anywhere on the path). On
               gs_cal a second time with the extrinsics held constant, so the
               batch folds cam_intr alone (K8-K10 at kc = 17)
  phases       where one LM attempt's time goes: host time of each phase
               (synchronized, median of 3), and the device's busy share over
               one attempt (torch.profiler)
  main         5 LM iterations through optimize() with the launch counts set
               to 0 just before; every kernel of the path must launch and the
               cost must fall

Then a JSON line of per-kernel results, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Any failure raises and exits
nonzero; without a CUDA device it exits nonzero and prints no result.

Usage: python3 chip_smoke.py  (from the repository root; needs one CUDA card)
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

PKG = "visual_inertial_bundle_adjustment_tpu_torch"
JAXPKG = "visual_inertial_bundle_adjustment_tpu"
# kernel wrapper name -> (K#, CUDA source, the TPU Pallas kernel it replaces, path)
KERNELS = {
    "visual_linearize": ("K1", f"{PKG}/csrc/visual_linearize.cu",
                         f"{JAXPKG}/ops/visual_fused.py:139", "bias+gs_cal+two_grid"),
    "assemble_rig": ("K2", f"{PKG}/csrc/assemble_rig.cu", f"{JAXPKG}/ops/segments.py:840", "bias"),
    "precond_rig": ("K3", f"{PKG}/csrc/precond_rig.cu", f"{JAXPKG}/ops/segments.py:1861",
                    "bias+full+gs_cal"),
    "schur_pcg": ("K4", f"{PKG}/csrc/schur.cu", f"{JAXPKG}/ops/segments.py:1318,1347", "bias"),
    "schur_up": ("K5", f"{PKG}/csrc/schur.cu", f"{JAXPKG}/ops/segments.py:725", "bias"),
    "schur_down": ("K6", f"{PKG}/csrc/schur.cu", f"{JAXPKG}/ops/segments.py:586", "bias"),
    "rs_linearize": ("K7", f"{PKG}/csrc/rs_linearize.cu", f"{JAXPKG}/ops/rs_fused.py:131",
                     "full"),
    "assemble_cal": ("K8", f"{PKG}/csrc/cal_segments.cu", f"{JAXPKG}/ops/segments.py:1674",
                     "full+gs_cal"),
    "schur_pcg_cal": ("K9", f"{PKG}/csrc/cal_segments.cu",
                      f"{JAXPKG}/ops/segments.py:1468,1519", "full+gs_cal"),
    "schur_down_cal": ("K10", f"{PKG}/csrc/cal_segments.cu", f"{JAXPKG}/ops/segments.py:1005",
                       "full+gs_cal"),
    "schur_up_cal": ("K10", f"{PKG}/csrc/cal_segments.cu", f"{JAXPKG}/ops/segments.py:1146",
                     "full+gs_cal"),
    "visual_cal_linearize": ("K11", f"{PKG}/csrc/visual_cal_linearize.cu",
                             f"{JAXPKG}/ops/visual_fused.py:347", "gs_cal"),
    "mv_fused_table": ("K12", f"{PKG}/csrc/table_segments.cu", f"{JAXPKG}/ops/segments.py:304",
                       "two_grid"),
    "mv_scatter_table": ("K13a", f"{PKG}/csrc/table_segments.cu",
                         f"{JAXPKG}/ops/segments.py:366", "two_grid"),
    "mv_gather_table": ("K13b", f"{PKG}/csrc/table_segments.cu",
                        f"{JAXPKG}/ops/segments.py:406", "two_grid"),
    "reduce_table": ("K13c", f"{PKG}/csrc/table_segments.cu", f"{JAXPKG}/ops/segments.py:441",
                     "two_grid+profile"),
    "reduce_partials": ("K14a", f"{PKG}/csrc/tile_segments.cu", f"{JAXPKG}/ops/segments.py:97",
                        "profile"),
    "gather_from_tiles": ("K14b", f"{PKG}/csrc/tile_segments.cu",
                          f"{JAXPKG}/ops/segments.py:135", "profile"),
    "mv_fused": ("K14c", f"{PKG}/csrc/tile_segments.cu", f"{JAXPKG}/ops/segments.py:170",
                 "profile"),
    "mv_gather": ("K14d", f"{PKG}/csrc/tile_segments.cu", f"{JAXPKG}/ops/segments.py:221",
                  "profile"),
    "mv_scatter": ("K14e", f"{PKG}/csrc/tile_segments.cu", f"{JAXPKG}/ops/segments.py:249",
                   "profile"),
}
PATHS = ("bias", "full", "gs_cal", "two_grid", "profile")
# bounds relative to the plain version's max-abs (tests/test_tpu_accuracy.py)
TOL_RES, TOL_J, TOL_SEG = 1e-5, 2e-4, 1e-5
# kernels whose ptxas report must show no register spill (the kernels
# redesigned for this card: K4's down and up passes, K9's, the landmark pass
# the two share, K13a's and K13c's slot-major routes on landmark rows, K8's
# window and sum passes, the instantiations per mode of K7, K1 and K11), by
# the names ptxas gives them
NO_SPILL = ("pcg_down", "pcg_up", "pcg_cal_down", "pcg_cal_up", "point_range_sum",
            "jtu_slot_major", "reduce_gather4", "to_slot_major", "reduce_gather",
            "assemble_cal_window", "sum_cal", "rs_linearize_mode", "visual_linearize_mode",
            "visual_cal_linearize_mode")
TOL_RS_RES, TOL_RS_J = 1e-4, 3e-4
TOL_CAL_J = 3e-4  # K11's Jacobian (its residual: TOL_RES)
# K1 and K11 against the designs they replaced: the same float64 residual
# chain (bit-equal), the chain below A in float32 instead of float64
TOL_OLD_J = 1e-5
# kernel vs plain LM iteration, relative (see the consistency phases)
TOL_ITER = 1e-3
# the K14-composed Schur matvec vs rcs.matvec (K12/K13) on the same x, relative
TOL_PROFILE = 1e-5
COND_MAX = 1e4  # landmarks whose step float32 resolves (see consistency)
LM_ITERATIONS = 5
PCG_ITERATIONS = 40
# one NVIDIA H100 SXM: HBM rate; float32 outside the tensor cores and
# float64 (NVIDIA's data sheet) for the two linearization kernels, which
# compute in float64 registers
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS, F64_FLOPS = 67e12, 34e12


def path_kernels(path):
    """The kernels a path must launch."""
    return [name for name, spec in KERNELS.items() if path in spec[3].split("+")]


T0 = time.time()


def phase(name, msg):
    print(f"[{name} +{time.time() - T0:.0f}s] {msg}", flush=True)


def rel_err(a, b):
    """max |a - b| relative to max |b| (the plain version), and max |a - b|."""
    d = (a.double() - b.double()).abs().max().item()
    return d / max(b.double().abs().max().item(), 1e-30), d


def cuda_time(fn, reps=20, warmup=3):
    """Median milliseconds of fn() over reps, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(fns):
    """Device time of each fn, its sessions run in turns a, b, ..., b, a and
    read as profile_matvec.device_ms reads them (torch.profiler, CUDA
    activity: the card's own time in each kernel and memset, without the
    host's enqueue time): (device ms per call, device operations per call,
    {kernel: ms per call}) of each. A session that recorded no device time
    at all is run again, up to three times."""
    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm

    sessions = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        for _ in range(3):  # a session that recorded nothing (seen on the H100) is taken again
            rows = pm.device_rows(fns[i])
            if rows:
                break
        sessions[i].append(rows)
    out = []
    for rows in sessions:
        per = pm.per_call(rows, pm.DEVICE_REPS)
        out.append((sum(ms for _, ms in per.values()), sum(n for n, _ in per.values()),
                    {key: ms for key, (_, ms) in per.items()}))
    return out


def walk_plan(plan):
    """The arrays of a SegPlan that the walking segment kernels read."""
    return [plan.rig, plan.point, plan.rig_ptr, plan.rig_obs, plan.pt_ptr, plan.pt_obs]


def nbytes(*xs):
    """Bytes of every tensor in xs (through tuples, lists, NamedTuples)."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total


def flat(out):
    """Kernel outputs as a flat list of tensors (lists of blocks expanded)."""
    items = out if isinstance(out, tuple) else (out,)
    res = []
    for x in items:
        res.extend(x if isinstance(x, list) else [x])
    return [x for x in res if x is not None]


class Bench:
    """Holds each kernel against its plain version and times both."""

    def __init__(self):
        self.results = {}

    def compare(self, name, fn, args, labels_tol, read, flops, f64=False, library=None):
        """fn(*args) -> outputs. The kernel's outputs are held against the
        plain version evaluated in float64 on the same inputs (so the bound
        measures the kernel's own error, not the float32 rounding of two
        summation orders); the kernel is timed against the plain version in
        float32, the type the main path runs. `read` lists the tensors the
        function reads (each counted once), `flops` its arithmetic, `library`
        one PyTorch call computing the same function (timed, used nowhere)."""
        from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
        import torch

        out_k = flat(fn(*args))
        with _kernels.plain_reference():
            out_p = flat(fn(*_kernels.to_f64(args)))
        torch.cuda.synchronize()
        errs = []
        for (label, tol), a, b in zip(labels_tol, out_k, out_p):
            r, d = rel_err(a, b)
            errs.append((label, r, d))
            if not (r <= tol):
                raise AssertionError(f"{name}.{label}: rel err {r:.3e} > {tol:g}")
        ms = cuda_time(lambda: fn(*args))
        with _kernels.plain_reference():  # fewer repetitions: the plain K7 takes seconds
            plain_ms = cuda_time(lambda: fn(*args), reps=5, warmup=1)
        library_ms = cuda_time(library, reps=5, warmup=1) if library is not None else None
        (dev_ms, dev_ops, dev_kern), = in_turns([lambda: fn(*args)])
        copies = [key for key in dev_kern if "Memcpy" in key]
        if copies:  # a copy from the host inside a wrapper: not capturable, not needed
            raise AssertionError(f"{name}: host copies among its device operations: {copies}")
        byte_ms = (nbytes(read) + nbytes(out_k)) / HBM_BYTES_PER_S * 1e3
        flop_ms = flops / (F64_FLOPS if f64 else F32_FLOPS) * 1e3
        bound_ms = max(byte_ms, flop_ms)
        bound_by = "bytes" if byte_ms >= flop_ms else "operations"
        phase("kernels", f"{name}: " + ", ".join(f"{lb} rel {r:.2e}" for lb, r, _ in errs)
              + f" | {ms:.4f} ms vs plain {plain_ms:.4f} ms | device {dev_ms:.4f} ms in "
              f"{dev_ops:g} ops | bound {bound_ms:.4f} ms ({bound_by}) | {dev_ms / bound_ms:.1f}x "
              "bound by device time"
              + (f" | library {library_ms:.4f} ms" if library is not None else "")
              + " | kernels: " + ", ".join(f"{key[:40]} {t:.4f}" for key, t in dev_kern.items()))
        row = dict(max_abs_err=max(d for _, _, d in errs), ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, device_ms=dev_ms,
                   device_ops=dev_ops, device_kernels=dev_kern)
        self.results[name] = row
        return row


def against_old(name, row, new, old, labels_tol):
    """The redesigned kernel `new` against the design it replaced, `old`
    (a branch only this script reaches), on the same inputs: each output
    within its tolerance, relative to max-abs; device time and operations
    per call in turns; old's CUDA-event time. Recorded in row["old"]."""
    outs_new, outs_old = flat(new()), flat(old())
    diffs = {}
    for (label, tol), a, b in zip(labels_tol, outs_new, outs_old):
        diffs[label] = rel_err(a, b)[0]
        if not diffs[label] <= tol:
            raise AssertionError(f"{name}.{label}: the old design differs by "
                                 f"{diffs[label]:.3e} > {tol:g}")
    (dev_n, ops_n, kern_n), (dev_o, ops_o, kern_o) = in_turns([new, old])
    row["old"] = dict(ms=cuda_time(old), device_ms=dev_o, device_ops=ops_o,
                      device_kernels=kern_o, rel_diff=diffs, device_ms_in_turns=dev_n)
    phase("kernels", f"{name}: device {dev_n:.4f} ms in {ops_n:g} ops vs the old design "
          f"{dev_o:.4f} ms in {ops_o:g} ops, in turns (events {row['ms']:.4f} vs "
          f"{row['old']['ms']:.4f} ms; rel diff "
          + ", ".join(f"{lb} {d:.1e}" for lb, d in diffs.items()) + ") | old: "
          + ", ".join(f"{key[:40]} {ms:.4f}" for key, ms in kern_o.items()))


def vis_read(data):
    """The per-observation arrays K1 and K11 read."""
    return [data[k] for k in ("rig", "point", "intr", "extr", "bias", "bias_on", "obs_uv",
                              "sqrt_h", "_pad")]


def vis_tables(v):
    """The variable tables K1 and K11 gather from."""
    return [v.pose_q, v.pose_t, v.points, v.cam_intr, v.cam_extr_q, v.cam_extr_t, v.det_bias]


def k1_rows(bench, shape, cfg, data, v, masks, N, modes=(True, False)):
    """K1 at a path's shapes, with the Jacobian (masks applied) and
    residual-only (`modes`), against its float64 plain version and, in turns,
    against the design it replaced (visual_linearize_v1): residuals
    bit-equal, Jacobians within TOL_OLD_J. Rows `visual_linearize(<shape>,
    residual-only)`."""
    from visual_inertial_bundle_adjustment_tpu_torch.ops import visual_fused

    for with_jac in modes:
        tag = ",".join(t for t in (shape, "" if with_jac else "residual-only") if t)
        name = "visual_linearize" + (f"({tag})" if tag else "")
        args = (cfg.camera_kind, data, v, masks if with_jac else None, with_jac)
        tols = [("res", TOL_RES), ("valid", TOL_RES)]
        read = vis_read(data) + vis_tables(v)
        if with_jac:
            tols += [("J_pt", TOL_J), ("J_r", TOL_J)]
            read += [masks.rig, masks.points]
        row = bench.compare(name, visual_fused.visual_linearize, args, tols, read,
                            (400.0 if with_jac else 150.0) * N, f64=True)
        against_old(name, row, lambda: visual_fused.visual_linearize(*args),
                    lambda: visual_fused._launch_visual(*args, entry="viba_visual_linearize_v1"),
                    [(label, 0.0 if label in ("res", "valid") else TOL_OLD_J)
                     for label, _ in tols])


def lm_iteration(problem, settings):
    """One LM attempt (linearize -> assemble -> solve -> retract -> cost) from
    the problem's current state: (new cost, |step|, pcg relative residual,
    reduced step x_r, landmark step x_l, damped landmark inverses)."""
    ks = problem._build()
    k_lin, k_assemble, k_step = ks[0], ks[6], ks[7]
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    lg = k_lin(datas, v, masks, None)
    asm = k_assemble(datas, lg, v, masks)
    out = k_step(asm, datas, lg, v, masks, settings.damping, PCG_ITERATIONS, settings.pcg_tol,
                 "gauss_seidel")
    return float(out[9].cost), float(out[11]), float(out[3]), out[0], out[1], out[5].H_ll_inv


def consistency(path, problem, settings, tol):
    """One LM iteration through the kernels, twice (bit-equal: every sum on
    the path runs in a fixed order), against the same iteration through the
    plain versions: the new cost, the reduced step |x_r| and the
    landmark step |x_l| within `tol`, relative. The landmark step is taken
    over the landmarks whose damped 3x3 block has a condition number below
    COND_MAX: float32 resolves the inverse of those to better than 1e-3
    (6e-8 x 1e4). Every session holds some near-degenerate landmarks; one
    triangulated from its own observations holds a few (condition 1e5-5e5,
    steps of metres) whose float32 steps move by percents with the summation
    order alone, between two calls of the plain path too, and they carry
    most of |step|. |step| over all landmarks, the number left out and the
    share of the landmark difference that the ten worst carry are printed
    beside."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.problem.structure import t_dot

    cost_k, step_k, rel_k, xr_k, xl_k, hinv = lm_iteration(problem, settings)
    cost_2, step_2, _, xr_2, xl_2, _ = lm_iteration(problem, settings)
    same = (cost_2 == cost_k and step_2 == step_k and torch.equal(xl_2, xl_k)
            and all(torch.equal(a, b) for a, b in zip(xr_2, xr_k)))
    phase(f"{path}:consistency", f"kernel path twice: new cost {cost_k!r} / {cost_2!r}, |step| "
          f"{step_k!r} / {step_2!r}: {'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError(f"{path}: two kernel-path LM attempts from one state differ")
    with _kernels.plain_reference():
        cost_p, step_p, rel_p, xr_p, xl_p, _ = lm_iteration(problem, settings)
    cond = torch.linalg.cond(hinv.double())
    well = cond < COND_MAX
    d2 = (xl_k.double() - xl_p.double()).pow(2).sum(-1)
    top = torch.topk(d2, min(10, d2.shape[0])).indices
    top_share = float(d2[top].sum() / d2.sum().clamp_min(1e-300))
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    dc, ds = rel(cost_k, cost_p), rel(step_k, step_p)
    dr = rel(float(t_dot(xr_k, xr_k)) ** 0.5, float(t_dot(xr_p, xr_p)) ** 0.5)
    dl = rel(float(xl_k[well].double().norm()), float(xl_p[well].double().norm()))
    phase(f"{path}:consistency",
          f"new cost {cost_k:.8g} vs plain {cost_p:.8g} (rel {dc:.2e}); |x_r| rel {dr:.2e}; "
          f"|x_l| over {int(well.sum())} landmarks of condition < {COND_MAX:g} rel {dl:.2e} "
          f"({int((~well).sum())} left out); |step| over all {step_k:.6g} vs plain {step_p:.6g} "
          f"(rel {ds:.2e}); the 10 landmarks that differ most carry {top_share:.3f} of "
          f"|x_l - plain x_l|^2, their condition {float(cond[top].min()):.3g}-"
          f"{float(cond[top].max()):.3g}; pcg rel {rel_k:.2e} vs plain {rel_p:.2e}")
    if not (dc <= tol and dr <= tol and dl <= tol):
        raise AssertionError(f"{path}: kernel and plain LM iterations disagree beyond {tol:g}")


def phase_times(path, problem, settings):
    """Host milliseconds of each phase of one LM attempt from the current
    state (each synchronized, median of 3), per-kind linearize times, and
    the device-busy share of one whole attempt under torch.profiler."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm
    from visual_inertial_bundle_adjustment_tpu_torch.problem import engine, rcs
    from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as fct
    from visual_inertial_bundle_adjustment_tpu_torch.problem.structure import (retract,
                                                                                t_scale, t_sub)

    def timed(fn):
        out, times = None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    ks = problem._build()
    k_lin, k_asm, k_step = ks[0], ks[6], ks[7]
    cfgs, datas, v, masks = problem.active_cfgs, tuple(problem.datas), problem.variables, \
        problem.masks
    lg, t_lin = timed(lambda: k_lin(datas, v, masks, None))
    asm, t_asm = timed(lambda: k_asm(datas, lg, v, masks))
    rs, t_damp = timed(lambda: rcs.with_damping(asm, v, masks, settings.damping))
    b, t_rhs = timed(lambda: t_sub(asm.g_r, rcs.w_y(rs, v, engine._chol_solve(rs.H_ll_inv,
                                                                                asm.g_l))))
    (x_r, _, _), t_pcg = timed(lambda: rcs.pcg(rs, v, b, PCG_ITERATIONS, settings.pcg_tol))
    x_l, t_back = timed(lambda: engine._chol_solve(rs.H_ll_inv,
                                                  asm.g_l - rcs.w_transpose_x(rs, v, x_r)))
    v_new, t_ret = timed(lambda: retract(v, t_scale(x_r, -1.0), -x_l, masks))
    _, t_cost = timed(lambda: engine.comparable_cost(cfgs, datas, v_new, lg))
    kinds = {}
    for c, d in zip(cfgs, datas):
        kinds[c.kind] = timed(lambda: fct.linearize_batch(c, d, v, masks))[1]
    phase(f"{path}:phases", f"linearize {t_lin:.1f} ms, assemble {t_asm:.1f}, damp+precond "
          f"{t_damp:.1f}, Schur RHS {t_rhs:.1f}, PCG x{PCG_ITERATIONS} {t_pcg:.1f}, "
          f"back-substitution {t_back:.1f}, retract {t_ret:.1f}, comparable cost {t_cost:.1f} | "
          "linearize by kind: " + ", ".join(f"{k} {ms:.1f}" for k, ms in kinds.items()))

    def attempt():
        lg_ = k_lin(datas, v, masks, None)
        asm_ = k_asm(datas, lg_, v, masks)
        return k_step(asm_, datas, lg_, v, masks, settings.damping, PCG_ITERATIONS,
                      settings.pcg_tol, "gauss_seidel")

    attempt()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        attempt()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = pm.device_kernels(prof.key_averages())
    if not rows:
        raise AssertionError(f"{path}: the profiler recorded no device time in an LM attempt")
    busy = sum(us for _, _, us in rows) / 1e3
    n_ops = sum(n for _, n, _ in rows)
    top = sorted(rows, key=lambda r: -r[2])[:6]
    phase(f"{path}:phases", f"one attempt {wall:.1f} ms: {n_ops} device ops, {busy:.1f} ms "
          f"device time, busy share {busy / wall:.2f} | top: " + ", ".join(
              f"{key[:40]} {us / 1e3:.2f} ms x{n}" for key, n, us in top))


def run_main(path, problem, settings, kernels):
    """5 LM iterations through optimize(), launch counts set to 0 just before
    and read just after; returns the counts."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import optimize

    iters = []

    def on_iter(d):
        iters.append(d)
        phase(f"{path}:main", f"iter {d['iteration']}: cost {d['prev_cost']:.6g} -> "
              f"{d['new_cost']:.6g} {'accepted' if d['accepted'] else 'rejected'} | pcg "
              f"{d['pcg_iters']} iters rel {d['pcg_rel_residual']:.2e} | "
              f"{d['iter_time_sec'] * 1e3:.1f} ms")

    settings.iteration_callback = on_iter
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.time()
    summary = optimize(problem, settings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _kernels.launch_counts()
    costs = [d["prev_cost"] for d in iters] + [summary.final_cost]
    phase(f"{path}:main", f"{summary.num_iterations} LM iterations in {wall:.2f} s: cost "
          f"{summary.initial_cost:.6g} -> {summary.final_cost:.6g} | launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    if not all(math.isfinite(c) for c in costs):
        raise AssertionError(f"{path}: non-finite cost in {costs}")
    if not summary.final_cost < summary.initial_cost:
        raise AssertionError(f"{path}: cost did not fall: {summary.initial_cost} -> "
                             f"{summary.final_cost}")
    missing = [k for k in kernels if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{path}: kernels not launched on the main path: {missing}")
    return launches


def lm_settings():
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import LMSettings

    return LMSettings(max_iterations=LM_ITERATIONS, direct_mode=False,
                      pcg_max_iterations=PCG_ITERATIONS, preconditioner="gauss_seidel")


# ---------------------------------------------------------------------------
# bias-only path (K1-K6)
# ---------------------------------------------------------------------------


def bias_only(dev, bench):
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.builder import (
        BuildOptions, build_synthetic_problem)
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    t0 = time.time()
    s = SyntheticSession(duration=120.0, keyframe_hz=10.0, gyro_hz=800.0, accel_hz=800.0,
                         num_points=20000, seed=17, pixel_noise=0.3, track_lifetime_sec=10.0)
    problem = build_synthetic_problem(
        s, BuildOptions(init_pose_noise=0.005, init_point_noise=0.03, init_vel_noise=0.03,
                        estimate_imu_calib=True,
                        imu_calib_options=dict(accelBias=True, gyroBias=True)),
        device=dev, dtype=torch.float32)
    ks = problem._build()
    k_lin, k_assemble = ks[0], ks[6]
    vi = next(i for i, c in enumerate(problem.cfgs) if c.block_info is not None)
    info, vdata = problem.cfgs[vi].block_info, problem.datas[vi]
    n_real = int((vdata["_pad"] < 0.5).sum())
    phase("bias:problem", f"R={s.num_rigs} L={len(s.points_w)} N={n_real} (padded "
          f"{info.nt * info.ts}) nt={info.nt} ts={info.ts} rb={info.rb} prb2={info.prb2} "
          f"nhg={info.nhg} built in {time.time() - t0:.1f} s")

    v, masks, datas = problem.variables, problem.masks, tuple(problem.datas)
    cfg = problem.active_cfgs[vi]
    gen = torch.Generator(device=dev).manual_seed(0)
    N = info.nt * info.ts
    k1_rows(bench, "", cfg, vdata, v, masks, N)

    lg = k_lin(datas, v, masks, None)
    asm = k_assemble(datas, lg, v, masks)
    (b, lin), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    rs = rcs.with_damping(asm, v, masks, 1e-4)
    k = b.rig_k
    x = torch.randn((s.num_rigs, k), generator=gen, device=dev)
    zl = torch.randn((len(s.points_w), 3), generator=gen, device=dev)
    plan = walk_plan(b.plan)
    bench.compare("assemble_rig", seg.seg_assemble_rig, (b.J, b.J_pt, lin.res, b.w, b.plan),
                  [("g_r", TOL_SEG), ("diag_r", TOL_SEG), ("g_l", TOL_SEG), ("H_ll0", TOL_SEG)],
                  [b.J, b.J_pt, lin.res, b.w] + plan, (8 * k + 36) * n_real)
    bench.compare("precond_rig", seg.seg_precond_rig, (b.J, b.J_pt, b.w, rs.H_ll_inv, b.plan),
                  [("blocks", TOL_SEG)], [b.J, b.J_pt, b.w, rs.H_ll_inv] + plan,
                  (30 * k + 5 * k * (k + 1)) * n_real)
    bench.compare("schur_down", seg.seg_schur_down, (b.J, b.J_pt, b.w, x, b.plan),
                  [("y", TOL_SEG), ("t", TOL_SEG), ("wu", TOL_SEG)],
                  [b.J, b.J_pt, b.w, x] + plan, (8 * k + 16) * n_real)
    bench.compare("schur_up", seg.seg_schur_up, (b.J, b.J_pt, b.w, zl, b.plan), [("y", TOL_SEG)],
                  [b.J, b.J_pt, b.w, zl] + plan, (4 * k + 14) * n_real)
    args4 = (b.J, b.J_pt, b.w, x, rs.H_ll_inv, b.plan)
    index4 = [b.plan.rig, b.plan.point, b.plan.pt_pos, b.plan.pt_ptr, b.plan.rig_ptr,
              b.plan.rig_obs]
    row4 = bench.compare("schur_pcg", seg.seg_schur_pcg, args4, [("y", TOL_SEG)],
                         [b.J, b.J_pt, b.w, x, rs.H_ll_inv] + index4, (8 * k + 30) * n_real)

    # the least bytes with the landmark solve between two passes: J_r, J_p
    # and w read twice, p (16 B a slot) written and read once, each index
    # array, x and hinv read once, z and y written once
    floor4 = (2 * nbytes([b.J, b.J_pt, b.w]) + 2 * 16 * n_real
              + nbytes(index4, x, rs.H_ll_inv) + 4 * (3 * len(s.points_w) + s.num_rigs * k))
    row4.update(two_pass_floor_ms=floor4 / HBM_BYTES_PER_S * 1e3)
    phase("kernels", f"schur_pcg: two-pass floor {row4['two_pass_floor_ms']:.4f} ms")
    if row4["device_ops"] > 3:
        raise AssertionError(f"schur_pcg: {row4['device_ops']} device operations per call")
    del lg, asm, rs, lin, b

    # One LM iteration from the initial state, through the kernels and
    # through the plain versions (before the main path: after a few
    # iterations the 40-iteration PCG stops far from convergence and its
    # step follows the float32 summation order). 1e-3: both are float32,
    # summed in other orders; K1's float64 registers round J differently,
    # and the unconverged PCG amplifies that (PERF.md §6).
    settings = lm_settings()
    consistency("bias", problem, settings, TOL_ITER)
    phase_times("bias", problem, settings)
    return run_main("bias", problem, settings,
                    path_kernels("bias"))


# ---------------------------------------------------------------------------
# full-sensor path (K7-K10, K3 at rig_k = 9)
# ---------------------------------------------------------------------------


def session_600():
    """The 600 s Aria-style session both adapter paths record (built once)."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession

    t0 = time.time()
    s = SyntheticSession(duration=600.0, keyframe_hz=10.0, gyro_hz=800.0, accel_hz=800.0,
                         num_points=60000, seed=23, pixel_noise=0.3, track_lifetime_sec=10.0)
    s.observations()
    return s, time.time() - t0


def adapter_problem(path, dev, session, session_sec, readout_time_sec, options):
    """write_session_dir -> load_session -> SessionAdapter.build -> blocking;
    prints the path's problem line and returns (problem, adapter, index of the
    blocked visual batch)."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as sio
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import SessionAdapter
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic_io import (
        write_session_dir)

    times = {"session": session_sec}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        write_session_dir(session, tmp, num_imus=2, readout_time_sec=readout_time_sec, seed=23)
        times["write"] = time.time() - t0
        t0 = time.time()
        sd = sio.load_session(tmp)
        times["load"] = time.time() - t0
    t0 = time.time()
    adapter = SessionAdapter(sd, options, log=lambda *a: None, device=dev, dtype=torch.float32)
    problem = adapter.build()
    torch.cuda.synchronize()
    times["adapter"] = time.time() - t0
    times.update({f"  {k}": val for k, val in adapter.timings.items()})
    t0 = time.time()
    problem._build()
    times["blocking"] = time.time() - t0
    vi = next(i for i, c in enumerate(problem.cfgs) if c.block_info is not None)
    info, data, v = problem.cfgs[vi].block_info, problem.datas[vi], problem.variables
    phase(f"{path}:problem", f"R={v.pose_q.shape[0]} L={v.points.shape[0]} "
          f"N={int((data['_pad'] < 0.5).sum())} (padded {info.nt * info.ts}) "
          f"n_c={v.cam_intr.shape[0]} W={adapter.num_windows} nt={info.nt} ts={info.ts} "
          f"rb={info.rb} wb={info.wb} prb2={info.prb2} nhg={info.nhg} "
          f"batches={[c.kind for c in problem.cfgs]} | "
          + " ".join(f"{k.strip()} {val:.1f} s" for k, val in times.items()))
    return problem, adapter, vi


def cal_segment_kernels(bench, problem, dev, suffix=""):
    """K3 and K8-K10 against their plain versions on the problem's blocked
    calibration-coupled batch, at its rig_k and window width kc (results
    named `<kernel><suffix>`)."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    v, masks, datas = problem.variables, problem.masks, tuple(problem.datas)
    ks = problem._build()
    lg = ks[0](datas, v, masks, None)
    asm = ks[6](datas, lg, v, masks)
    (b, lin), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    if not rcs._cal_fast(b):
        raise AssertionError("the blocked batch is not calibration-coupled single-pass")
    rs = rcs.with_damping(asm, v, masks, 1e-4)
    k = b.rig_k
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    n_real = int(b.plan.rig_obs.shape[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((R, k), generator=gen, device=dev)
    xc = torch.randn((n_c, b.J_cal.shape[1]), generator=gen, device=dev)
    zl = torch.randn((L, 3), generator=gen, device=dev)
    plan, cplan = walk_plan(b.plan), list(b.cplan)[:4]  # K8, K10: the window chunk lists
    jread = [b.J, b.J_pt, b.J_cal, b.w]
    kc = b.J_cal.shape[1]
    n_out = seg.n_cal_out(seg.CAL_SPLITS[kc])
    seg_tol = lambda *names: [(nm, TOL_SEG) for nm in names]  # noqa: E731
    if kc == 23:  # K3 does not depend on the window columns
        bench.compare(f"precond_rig{suffix or f'(k={k})'}", seg.seg_precond_rig,
                      (b.J, b.J_pt, b.w, rs.H_ll_inv, b.plan), seg_tol("blocks"),
                      [b.J, b.J_pt, b.w, rs.H_ll_inv] + plan,
                      (30 * k + 5 * k * (k + 1)) * n_real)
    args8 = (b.J, b.J_cal, b.J_pt, lin.res, b.w, b.plan, b.cplan)
    row8 = bench.compare(f"assemble_cal{suffix}", seg.seg_assemble_cal, args8,
                         seg_tol("g_r", "diag_r", "g_c", "diag_c",
                                 *(f"blocks_{g}" for g, _ in b.cal_groups), "g_l", "H_ll0"),
                         jread + [lin.res] + plan + cplan,
                         (8 * k + 36 + 4 * kc + 5 * (n_out - kc)) * n_real)
    if row8["device_ops"] > 3:
        raise AssertionError(f"assemble_cal{suffix}: {row8['device_ops']} device operations "
                             "per call")
    cp = b.cplan
    index9 = [b.plan.rig, cp.win, b.plan.point, b.plan.pt_pos, b.plan.pt_ptr, cp.rig_pair,
              cp.pair_ptr, cp.pair_obs, cp.pair_part, cp.win_pair]
    args9 = (b.J, b.J_cal, b.J_pt, b.w, x, xc, rs.H_ll_inv, b.plan, b.cplan)
    row9 = bench.compare(f"schur_pcg_cal{suffix}", seg.seg_schur_pcg_cal, args9,
                         seg_tol("y_r", "y_c"), jread + [x, xc, rs.H_ll_inv] + index9,
                         (8 * k + 8 * kc + 24) * n_real)
    ops_new = row9["device_ops"]
    # the least bytes of any design with the landmark solve between two
    # passes: J_r, J_c, J_p and w read twice, p (16 B a slot) written and
    # read once, each index array read once, the outputs written once
    floor_bytes = 2 * nbytes(jread) + 2 * 16 * n_real + nbytes(index9) + 4 * (R * k + n_c * kc)
    row9.update(two_pass_floor_ms=floor_bytes / HBM_BYTES_PER_S * 1e3)
    phase("kernels", f"schur_pcg_cal{suffix}: two-pass floor {row9['two_pass_floor_ms']:.4f} ms")
    if ops_new > 4:
        raise AssertionError(f"schur_pcg_cal{suffix}: {ops_new} device operations per call")
    bench.compare(f"schur_down_cal{suffix}", seg.seg_schur_down_cal,
                  (b.J, b.J_cal, b.J_pt, b.w, x, xc, b.plan, b.cplan),
                  seg_tol("y_r", "y_c", "t", "wu"), jread + [x, xc] + plan + cplan,
                  (8 * k + 8 * kc + 16) * n_real)
    # as the main path calls it (rcs.w_transpose_x): t = W^T x alone
    bench.compare(f"schur_down_cal{suffix}(want_y=False)", seg.seg_schur_down_cal,
                  (b.J, b.J_cal, b.J_pt, b.w, x, xc, b.plan, b.cplan, False),
                  seg_tol("t", "wu"), jread + [x, xc] + plan + cplan[:1],
                  (4 * k + 4 * kc + 16) * n_real)
    bench.compare(f"schur_up_cal{suffix}", seg.seg_schur_up_cal,
                  (b.J, b.J_cal, b.J_pt, b.w, zl, b.plan, b.cplan), seg_tol("y_r", "y_c"),
                  jread + [zl] + plan + cplan, (4 * k + 4 * kc + 14) * n_real)


def full_sensor(dev, bench, session, session_sec):
    from visual_inertial_bundle_adjustment_tpu_torch.ops import rs_fused
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import AdapterOptions

    problem, adapter, vi = adapter_problem(
        "full", dev, session, session_sec, 0.03,
        AdapterOptions(estimate_readout=True, estimate_cam_time_offset=True))
    cfg, data = problem.active_cfgs[vi], problem.datas[vi]
    info = cfg.block_info
    v, masks = problem.variables, problem.masks
    N = info.nt * info.ts
    tab = data["rs_tables"]
    phase("full:problem", f"K={tab.dt.shape[1]} samples per RS table")

    rs_read = [data[k] for k in ("rig", "rs_row", "point", "intr", "extr", "_pad", "rs_tpf",
                                 "obs_uv", "sqrt_h")]
    rs_tables = [v.pose_q, v.pose_t, v.vel, v.points, v.cam_intr, v.cam_extr_q, v.cam_extr_t,
                 list(tab)]
    rs_masks = [masks.rig, masks.points, masks.cam_intr, masks.cam_extr]
    for mode, args7, tols7, read7, flops7 in (
            ("", (cfg.camera_kind, data, v, masks, True, True),
             [("res", TOL_RS_RES), ("valid", TOL_RS_RES), ("J_pt", TOL_RS_J), ("J_r", TOL_RS_J),
              ("J_cal", TOL_RS_J)], rs_read + rs_tables + rs_masks, 1500.0 * N),
            ("(residual-only)", (cfg.camera_kind, data, v, None, False, False),
             [("res", TOL_RS_RES), ("valid", TOL_RS_RES)], rs_read + rs_tables, 500.0 * N)):
        bench.compare(f"rs_linearize{mode}", rs_fused.rs_linearize, args7, tols7, read7, flops7,
                      f64=True)

    cal_segment_kernels(bench, problem, dev)

    # 1e-3, as for the bias-only path: float32 kernel and plain versions sum
    # in other orders and K7 rounds res and J from float64 registers; the
    # 40-iteration PCG does not converge, so the step carries that rounding
    settings = lm_settings()
    consistency("full", problem, settings, TOL_ITER)
    phase_times("full", problem, settings)
    return run_main("full", problem, settings,
                    path_kernels("full"))


# ---------------------------------------------------------------------------
# global-shutter calibration path (K11; K1 residual-only; K8-K10, K3 at rig_k = 6)
# ---------------------------------------------------------------------------


def gs_cal(dev, bench, session, session_sec):
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import visual_fused
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import AdapterOptions

    problem, adapter, vi = adapter_problem("gs_cal", dev, session, session_sec, None,
                                           AdapterOptions())
    kinds = [c.kind for c in problem.cfgs]
    if "rs_visual" in kinds or any("rs_tables" in d for d in problem.datas):
        raise AssertionError(f"gs_cal: rolling-shutter batch or tables in {kinds}")
    cfg, data = problem.active_cfgs[vi], problem.datas[vi]
    if cfg.kind != "visual" or set(cfg.active_groups) != {"points", "rig", "cam_extr", "cam_intr"}:
        raise AssertionError(f"gs_cal: blocked batch {cfg.kind} with groups {cfg.active_groups}")
    info = cfg.block_info
    v, masks = problem.variables, problem.masks
    N = info.nt * info.ts
    args11 = (cfg.camera_kind, data, v, masks)
    row11 = bench.compare(
        "visual_cal_linearize", visual_fused.visual_cal_linearize, args11,
        [("res", TOL_RES), ("valid", TOL_RES), ("J_pt", TOL_CAL_J), ("J_r", TOL_CAL_J),
         ("J_cal", TOL_CAL_J)],
        vis_read(data) + vis_tables(v) + [masks.rig, masks.points, masks.cam_intr,
                                          masks.cam_extr],
        700.0 * N, f64=True)
    against_old("visual_cal_linearize", row11, lambda: visual_fused.visual_cal_linearize(*args11),
                lambda: visual_fused._launch_visual_cal(*args11,
                                                        entry="viba_visual_cal_linearize_v1"),
                [("res", 0.0), ("valid", 0.0), ("J_pt", TOL_OLD_J), ("J_r", TOL_OLD_J),
                 ("J_cal", TOL_OLD_J)])
    k1_rows(bench, "gs_cal", cfg, data, v, None, N, modes=(False,))
    cal_segment_kernels(bench, problem, dev, suffix="(gs_cal,k=6)")

    # 1e-3, as for the other paths: float32 kernel and plain versions sum in
    # other orders, K11 rounds res and J from float64 registers, and the
    # 40-iteration PCG does not converge
    settings = lm_settings()
    consistency("gs_cal", problem, settings, TOL_ITER)

    # the extrinsics held constant: the batch folds cam_intr alone into the
    # window kernels (K8-K10 at kc = 17; the generic AD linearizer, as in the
    # JAX package, since K11 takes both groups)
    masks0 = problem.masks
    problem.masks = masks0._replace(cam_extr=torch.zeros_like(masks0.cam_extr))
    problem._kernels = None
    cal_segment_kernels(bench, problem, dev, suffix="(gs_cal,kc=17)")
    consistency("gs_cal(kc=17)", problem, settings, TOL_ITER)
    problem.masks = masks0
    problem._kernels = None
    phase_times("gs_cal", problem, settings)
    return run_main("gs_cal", problem, settings,
                    path_kernels("gs_cal"))


# ---------------------------------------------------------------------------
# general two-grid path (K1, K12, K13a-c)
# ---------------------------------------------------------------------------


def two_grid(dev, bench):
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.problem import engine, rcs
    from visual_inertial_bundle_adjustment_tpu_torch.profile_matvec import build_two_grid_problem

    t0 = time.time()
    problem = build_two_grid_problem(dev, torch.float32)
    ks = problem._build()
    vi = next(i for i, c in enumerate(problem.cfgs) if c.block_info is not None)
    info, vdata = problem.cfgs[vi].block_info, problem.datas[vi]
    v, masks, datas = problem.variables, problem.masks, tuple(problem.datas)
    R, L = v.pose_q.shape[0], v.points.shape[0]
    N = info.nt * info.ts
    n_real = int((vdata["_pad"] < 0.5).sum())
    phase("two_grid:problem", f"R={R} L={L} N={n_real} (padded {N}) nt={info.nt} ts={info.ts} "
          f"rb={info.rb} prb2={info.prb2} nhg={info.nhg} built in {time.time() - t0:.1f} s")
    if info.prb2 != 0 or info.nhg != 0:
        raise AssertionError("two_grid: the batch has a landmark window (single-pass)")

    # K1 at the general path's size: linearize and cost of 3.1M slots
    k1_rows(bench, "two_grid", problem.active_cfgs[vi], vdata, v, masks, N)

    lg = ks[0](datas, v, masks, None)
    asm = ks[6](datas, lg, v, masks)
    (b, lin), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    if rcs._single_pass(b) or b.groups != ("rig",):
        raise AssertionError(f"two_grid: batch groups {b.groups} on a single-pass route")
    rs = rcs.with_damping(asm, v, masks, 1e-4)
    k = b.rig_k
    rig, pts = seg.rig_rows(b.plan), seg.point_rows(b.plan)
    gen = torch.Generator(device=dev).manual_seed(0)
    real = (1.0 - vdata["_pad"])[None]
    x = torch.randn((R, k), generator=gen, device=dev)
    zl = torch.randn((L, 3), generator=gen, device=dev)
    u = torch.randn((2, N), generator=gen, device=dev) * real
    seg_tol = lambda *names: [(nm, TOL_SEG) for nm in names]  # noqa: E731

    def library_sum(contrib, rows):
        out = torch.zeros((rows.n_rows, contrib.shape[0]), dtype=contrib.dtype, device=dev)
        idx = rows.row.long()
        return lambda: out.zero_().index_add_(0, idx, contrib.T)

    # per PCG matvec: K12 on the rig rows, K13a on the landmark rows, the 3x3
    # solve, K13b on the landmark rows, K13a on the rig rows
    bench.compare("mv_fused_table", seg.seg_mv_fused_table, (b.J, b.w, x, rig),
                  seg_tol("wu", "y"), [b.J, b.w, x] + list(rig), (8 * k + 2) * n_real)
    row13 = bench.compare("mv_scatter_table", seg.seg_mv_scatter_table, (b.J_pt, u, pts),
                          seg_tol("y"), [b.J_pt, u, pts.ptr, pts.obs], 12 * n_real)
    # K13a on the landmark rows through the slot-major copy against the walk
    # on the same rows (the RowPlan not marked scattered), in turns
    walk13 = pts._replace(scattered=False)
    r_walk13, _ = rel_err(seg.seg_mv_scatter_table(b.J_pt, u, walk13),
                          seg.seg_mv_scatter_table(b.J_pt, u, pts))
    (d13, o13, kern13), (d_walk13, _, _) = in_turns(
        [lambda: seg.seg_mv_scatter_table(b.J_pt, u, pts),
         lambda: seg.seg_mv_scatter_table(b.J_pt, u, walk13)])
    row13.update(device_ms=d13, device_ops=o13, device_kernels=kern13,
                 walk_ms=cuda_time(lambda: seg.seg_mv_scatter_table(b.J_pt, u, walk13)),
                 walk_device_ms=d_walk13, rel_diff_walk=r_walk13)
    phase("kernels", f"mv_scatter_table(landmark rows): device {d13:.4f} ms in {o13:g} ops ("
          + ", ".join(f"{key[:30]} {ms:.4f}" for key, ms in kern13.items())
          + f") vs the walk {d_walk13:.4f} ms (events {row13['ms']:.4f} vs "
          f"{row13['walk_ms']:.4f}; rel diff {r_walk13:.1e})")
    if o13 > 2:
        raise AssertionError(f"mv_scatter_table(landmark rows): {o13} device operations per call")
    if not r_walk13 <= TOL_SEG:
        raise AssertionError(f"mv_scatter_table(landmark rows): the walk differs by "
                             f"{r_walk13:.1e}")
    bench.compare("mv_scatter_table(rig rows)", seg.seg_mv_scatter_table, (b.J, u, rig),
                  seg_tol("y"), [b.J, u, rig.ptr, rig.obs], 4 * k * n_real)
    bench.compare("mv_gather_table", seg.seg_mv_gather_table, (b.J_pt, zl, pts), seg_tol("u"),
                  [b.J_pt, zl, pts.row], 12 * N)
    bench.compare("mv_gather_table(rig rows)", seg.seg_mv_gather_table, (b.J, x, rig),
                  seg_tol("u"), [b.J, x, rig.row], 4 * k * N)
    # K13c at the widths of the assembly and of the preconditioner: the rig
    # blocks (k^2 wide, the widest; they walk the rig lists), the landmark
    # blocks (9) and gradient (3), a scattered family (slot-major copy and
    # gather); on those, device times of the walk on the same rows (the
    # RowPlan not marked scattered) and of index_add_, in turns
    for name, D, rows in (("reduce_table", k * k, rig), ("reduce_table(landmark rows,D=9)", 9, pts),
                          ("reduce_table(landmark rows,D=3)", 3, pts)):
        contrib = torch.randn((D, N), generator=gen, device=dev) * real
        lib = library_sum(contrib, rows)
        row = bench.compare(name, seg.seg_reduce_table, (contrib, rows), seg_tol("y"),
                            [contrib, rows.ptr, rows.obs], D * n_real, library=lib)
        if rows.scattered:
            walk = rows._replace(scattered=False)
            r_walk, _ = rel_err(seg.seg_reduce_table(contrib, walk),
                                seg.seg_reduce_table(contrib, rows))
            (d_new, o_new, k_new), (d_walk, _, _), (d_lib, _, k_lib) = in_turns(
                [lambda: seg.seg_reduce_table(contrib, rows),
                 lambda: seg.seg_reduce_table(contrib, walk), lib])
            row.update(device_ms=d_new, device_ops=o_new, device_kernels=k_new, walk_ms=cuda_time(
                lambda: seg.seg_reduce_table(contrib, walk)), walk_device_ms=d_walk,
                library_device_ms=d_lib, library_device_kernels=k_lib, rel_diff_walk=r_walk)
            phase("kernels", f"{name}: device {d_new:.4f} ms in {o_new:g} ops ("
                  + ", ".join(f"{key[:30]} {ms:.4f}" for key, ms in k_new.items())
                  + f") vs the walk "
                  f"{d_walk:.4f} ms (events {row['walk_ms']:.4f}; rel diff {r_walk:.1e}) vs "
                  f"index_add_ {d_lib:.4f} ms (" + ", ".join(
                      f"{key[:30]} {ms:.4f}" for key, ms in k_lib.items()) + ")")
            if not r_walk <= TOL_SEG:
                raise AssertionError(f"{name}: the walk differs by {r_walk:.1e}")
        del contrib

    # K4 (the single-pass rig-only matvec, which walks the same CSR lists)
    # on this batch beside the general path's composition of K12 and K13
    def general_matvec():
        wu, y = seg.seg_mv_fused_table(b.J, b.w, x, rig)
        z = engine._chol_solve(rs.H_ll_inv, rcs._pt_reduce(b, wu))
        return y - seg.seg_mv_scatter_table(b.J, rcs._pt_expand(b, z), rig)

    y_k4 = seg.seg_schur_pcg(b.J, b.J_pt, b.w, x, rs.H_ll_inv, b.plan)
    r, _ = rel_err(general_matvec(), y_k4)
    if not (r <= 1e-4):  # float32 sums in other orders, cancellation in y - W z
        raise AssertionError(f"two_grid: K12/K13 matvec vs K4 on the same batch: {r:.3e}")
    k4 = dict(k4_ms=cuda_time(lambda: seg.seg_schur_pcg(b.J, b.J_pt, b.w, x, rs.H_ll_inv,
                                                        b.plan)),
              general_ms=cuda_time(general_matvec), rel_diff=r)
    bench.results["mv_fused_table"]["matvec_vs_k4"] = k4
    phase("kernels", f"visual Schur matvec on the two-grid batch: K4 {k4['k4_ms']:.4f} ms vs "
          f"K12 + 2 x K13a + K13b + 3x3 solve {k4['general_ms']:.4f} ms (rel diff {r:.2e})")
    del lg, asm, rs, lin, b, u
    profile_launches = tile_profile(dev, bench, problem)

    # 1e-3, as for the other paths (float32, other summation orders, K1's
    # float64 registers, an unconverged 40-iteration PCG)
    settings = lm_settings()
    consistency("two_grid", problem, settings, TOL_ITER)
    phase_times("two_grid", problem, settings)
    return {"two_grid": run_main("two_grid", problem, settings, path_kernels("two_grid")),
            "profile": profile_launches}


# ---------------------------------------------------------------------------
# profile: the general-path matvec on the two grids of tiles (K14a-e)
# ---------------------------------------------------------------------------


def tile_profile(dev, bench, problem):
    """K14a-e against their plain versions at the two_grid problem's shapes
    (the rig grid at k 6, the point-sorted grid at k 3), then the profile
    path: the launch counts set to 0, the Schur matvec composed from the
    tile kernels held against rcs.matvec (and K14a's landmark blocks against
    K13c's, K14b's slot steps against an index_select), the counts read;
    then each component timed. Returns the profile path's launch counts."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm
    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    t0 = time.time()
    ctx = pm.setup(problem)
    (tb,) = ctx.batches
    b, g, p = tb.b, tb.rig, tb.pt
    L, k = ctx.v.points.shape[0], b.rig_k
    n_rig, n_pt = g.nt * g.ts, p.nt * p.ts
    phase("profile", f"rig grid nt={g.nt} ts={g.ts} rb={g.rb} ({g.plan.run_len.shape[0]} runs), "
          f"point grid pnt={p.nt} ts={p.ts} prb={p.rb} ({p.plan.run_len.shape[0]} runs), set up "
          f"in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = pm.random_tangent(ctx.v, 4)
    x_l = torch.randn((L, 3), generator=gen, device=dev)
    xt = g.gather(x.rig[:, :k].contiguous())
    zt = p.gather(torch.randn((L, 3), generator=gen, device=dev))
    u_pt = torch.randn((2, n_pt), generator=gen, device=dev)
    u_rig = torch.randn((2, n_rig), generator=gen, device=dev)
    A = rcs._outer(tb.J_pt_po * tb.w_po[None, None, :], tb.J_pt_po).reshape(9, -1).contiguous()
    key = (torch.arange(n_pt, device=dev) // p.ts) * p.rb + p.local.long()
    part_lib = torch.zeros((p.nt * p.rb, 9), device=dev)
    seg_tol = lambda *names: [(nm, TOL_SEG) for nm in names]  # noqa: E731
    runs_g, runs_p = list(g.plan), list(p.plan)
    bench.compare("mv_fused", seg.seg_mv_fused, (b.J, b.w, xt, g.local, g.nt, g.ts, g.rb, g.plan),
                  seg_tol("wu", "part"), [b.J, b.w, xt] + runs_g, (8 * k + 2) * n_rig)
    bench.compare("mv_scatter", seg.seg_mv_scatter,
                  (tb.J_pt_po, u_pt, p.local, p.nt, p.ts, p.rb, p.plan), seg_tol("part"),
                  [tb.J_pt_po, u_pt] + runs_p, 12 * n_pt)
    bench.compare("mv_scatter(rig grid)", seg.seg_mv_scatter,
                  (b.J, u_rig, g.local, g.nt, g.ts, g.rb, g.plan), seg_tol("part"),
                  [b.J, u_rig] + runs_g, 4 * k * n_rig)
    bench.compare("mv_gather", seg.seg_mv_gather, (tb.J_pt_po, zt, p.local, p.nt, p.ts, p.rb),
                  seg_tol("u"), [tb.J_pt_po, zt, p.local], 12 * n_pt)
    bench.compare("mv_gather(rig grid)", seg.seg_mv_gather, (b.J, xt, g.local, g.nt, g.ts, g.rb),
                  seg_tol("u"), [b.J, xt, g.local], 4 * k * n_rig)
    bench.compare("reduce_partials", seg.seg_reduce_partials,
                  (A, p.local, p.nt, p.ts, p.rb, p.plan), seg_tol("part"), [A] + runs_p, 9 * n_pt,
                  library=lambda: part_lib.zero_().index_add_(0, key, A.T))
    bench.compare("gather_from_tiles", seg.seg_gather_from_tiles,
                  (zt, p.local, p.nt, p.ts, p.rb), seg_tol("rows"), [zt, p.local], 0,
                  library=lambda: zt.reshape(-1, 3).index_select(0, key))

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    errs = pm.check(ctx, x, x_l)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    phase("profile", f"tile-composed matvec vs rcs.matvec: rel {errs['matvec']:.3e}; K14a "
          f"landmark blocks vs K13c: rel {errs['point_blocks']:.3e}; K14b slot steps vs "
          f"index_select: rel {errs['slot_steps']:.3e} | launches "
          f"{ {n: c for n, c in launches.items() if c} }")
    if not (errs["matvec"] <= TOL_PROFILE and errs["point_blocks"] <= TOL_SEG
            and errs["slot_steps"] <= TOL_SEG):
        raise AssertionError(f"profile: tile route disagrees with the solver route: {errs}")
    missing = [n for n in path_kernels("profile") if launches.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"profile: kernels not launched on the profile path: {missing}")
    ms = pm.profile(ctx, x)
    for name, t in ms.items():
        phase("profile", f"{name}: {t:.4f} ms")
    dev_ms = pm.visual_device_ms(ctx, x)
    for route, kernels in dev_ms.items():
        phase("profile", f"device time of the visual matvec, {route} route: "
              f"{sum(kernels.values()):.4f} ms: " + ", ".join(
                  f"{k[:60]} {t:.4f}" for k, t in sorted(kernels.items(), key=lambda kv: -kv[1])))
    bench.results["mv_fused"]["profile_ms"] = ms
    bench.results["mv_fused"]["profile_device_ms"] = dev_ms
    bench.results["mv_fused"]["profile_errors"] = errs
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | tf32 off")

    t0 = time.time()
    _kernels.lib()
    phase("build", f"{_kernels.library_path().name} in {time.time() - t0:.1f} s")
    usage = _kernels.resource_usage()
    for name, regs, spill_st, spill_ld in usage:
        phase("build", f"ptxas {name}: {regs} registers, spill stores {spill_st} B, "
              f"loads {spill_ld} B")
    # the kernels redesigned for this card (K9, K13c's slot-major route) must
    # not spill: each instantiation is named, and each reports 0 bytes
    redesigned = [u for u in usage if any(k in u[0] for k in NO_SPILL)]
    spilled = [u[0] for u in redesigned if u[2] or u[3]]
    missing = [k for k in NO_SPILL if not any(k in u[0] for u in redesigned)]
    if spilled or missing:
        raise AssertionError(f"ptxas: spills in {spilled}; no report for {missing}")
    phase("build", f"no spill in the {len(redesigned)} instantiations of "
          + ", ".join(NO_SPILL))

    bench = Bench()
    launches = {"bias": bias_only(dev, bench)}
    torch.cuda.empty_cache()
    launches.update(two_grid(dev, bench))
    torch.cuda.empty_cache()
    session, session_sec = session_600()
    launches["full"] = full_sensor(dev, bench, session, session_sec)
    torch.cuda.empty_cache()
    launches["gs_cal"] = gs_cal(dev, bench, session, session_sec)

    rows = []
    for name, (kid, src, rep, path) in KERNELS.items():
        per_path = {p: launches[p].get(name, 0) for p in PATHS if p in path.split("+")}
        if not all(per_path.values()):
            raise AssertionError(f"{name}: not launched on every path of {per_path}")
        row = dict(name=name, k=kid, route="cuda", source=src, replaces=rep, path=path,
                   launches=sum(per_path.values()), launches_by_path=per_path,
                   **bench.results[name])
        # the same kernel at another path's shapes (rig_k, row family, width)
        row["also"] = {key: res for key, res in bench.results.items()
                       if key.startswith(name + "(")}
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
