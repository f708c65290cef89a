#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the bias-only headline problem (a 120 s
synthetic session: 1,200 rigs, 20,000 landmarks, 394,062 Fisheye624
observations, one inertial chain with IMU bias) through
`pipeline.builder.build_synthetic_problem`, `problem.optimizer.Problem` and
`problem.optimizer.optimize` — in phases, one printed line each:

  device       the card's name and power limit (nvidia-smi); TF32 off
  build        nvcc build of csrc/*.cu into the package's _build/ directory
  problem      host build of the headline problem, moved to the card as f32
  kernels      each CUDA kernel against its plain PyTorch version on the card,
               at the problem's real shapes (J from one linearization):
               error relative to the max-abs of the plain version evaluated
               in float64 on the same inputs; median times of the kernel and
               of the plain version in float32
  consistency  one LM iteration through the kernels vs the plain versions
               from the initial state: new cost and |step| within 1e-3
  main         5 LM iterations through optimize(); every kernel must launch
               and the cost must fall

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
import time

PKG = "visual_inertial_bundle_adjustment_tpu_torch"
# kernel name -> (CUDA source, the TPU Pallas kernel it replaces)
KERNELS = {
    "visual_linearize": (f"{PKG}/csrc/visual_linearize.cu",
                         "visual_inertial_bundle_adjustment_tpu/ops/visual_fused.py:139"),
    "assemble_rig": (f"{PKG}/csrc/assemble_rig.cu",
                     "visual_inertial_bundle_adjustment_tpu/ops/segments.py:840"),
    "precond_rig": (f"{PKG}/csrc/precond_rig.cu",
                    "visual_inertial_bundle_adjustment_tpu/ops/segments.py:1861"),
    "schur_down": (f"{PKG}/csrc/schur.cu",
                   "visual_inertial_bundle_adjustment_tpu/ops/segments.py:586,1318"),
    "schur_up": (f"{PKG}/csrc/schur.cu",
                 "visual_inertial_bundle_adjustment_tpu/ops/segments.py:725,1347"),
}
# bounds relative to the plain version's max-abs (tests/test_tpu_accuracy.py)
TOL_RES, TOL_J, TOL_SEG = 1e-5, 2e-4, 1e-5
LM_ITERATIONS = 5
PCG_ITERATIONS = 40


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.ops import visual_fused
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.builder import (
        BuildOptions, build_synthetic_problem)
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import (
        LMSettings, optimize)

    # --- device -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | tf32 off")

    # --- build --------------------------------------------------------------
    t0 = time.time()
    _kernels.lib()
    phase("build", f"{_kernels.library_path().name} in {time.time() - t0:.1f} s")

    # --- problem ------------------------------------------------------------
    t0 = time.time()
    s = SyntheticSession(duration=120.0, keyframe_hz=10.0, gyro_hz=800.0, accel_hz=800.0,
                         num_points=20000, seed=17, pixel_noise=0.3, track_lifetime_sec=10.0)
    problem = build_synthetic_problem(
        s, BuildOptions(init_pose_noise=0.005, init_point_noise=0.03, init_vel_noise=0.03,
                        estimate_imu_calib=True,
                        imu_calib_options=dict(accelBias=True, gyroBias=True)),
        device=dev, dtype=torch.float32)
    ks = problem._build()
    k_lin, k_assemble, k_step = ks[0], ks[6], ks[7]
    vi = next(i for i, c in enumerate(problem.cfgs) if c.block_info is not None)
    info, vdata = problem.cfgs[vi].block_info, problem.datas[vi]
    n_real = int((vdata["_pad"] < 0.5).sum())
    phase("problem", f"R={s.num_rigs} L={len(s.points_w)} N={n_real} (padded {info.nt * info.ts}) "
          f"nt={info.nt} ts={info.ts} rb={info.rb} prb2={info.prb2} nhg={info.nhg} "
          f"built in {time.time() - t0:.1f} s")

    # --- kernels vs plain ---------------------------------------------------
    v, masks, datas = problem.variables, problem.masks, tuple(problem.datas)
    cfg = problem.active_cfgs[vi]
    results = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(name, fn, args, outputs_tol):
        """fn(*args) -> outputs. The kernel's outputs are held against the
        plain version evaluated in float64 on the same inputs (so the bound
        measures the kernel's own error, not the float32 rounding of two
        summation orders); the kernel is timed against the plain version in
        float32, the type the main path runs."""
        out = fn(*args)
        out_k = out if isinstance(out, tuple) else (out,)
        with _kernels.plain_reference():
            out = fn(*_kernels.to_f64(args))
        out_p = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        errs = []
        for (label, tol), a, b in zip(outputs_tol, out_k, out_p):
            r, d = rel_err(a, b)
            errs.append((label, r, d))
            if not (r <= tol):
                raise AssertionError(f"{name}.{label}: rel err {r:.3e} > {tol:g}")
        ms = cuda_time(lambda: fn(*args))
        with _kernels.plain_reference():
            plain_ms = cuda_time(lambda: fn(*args))
        phase("kernels", f"{name}: " + ", ".join(f"{lb} rel {r:.2e}" for lb, r, _ in errs)
              + f" | {ms:.4f} ms vs plain {plain_ms:.4f} ms")
        return dict(max_abs_err=max(d for _, _, d in errs), ms=ms, plain_ms=plain_ms)

    results["visual_linearize"] = compare(
        "visual_linearize", visual_fused.visual_linearize,
        (cfg.camera_kind, vdata, v, masks, True),
        [("res", TOL_RES), ("valid", TOL_RES), ("J_pt", TOL_J), ("J_r", TOL_J)])
    compare("visual_linearize(residual-only)", visual_fused.visual_linearize,
            (cfg.camera_kind, vdata, v, None, False), [("res", TOL_RES), ("valid", TOL_RES)])

    lg = k_lin(datas, v, masks, None)
    asm = k_assemble(datas, lg, v, masks)
    (b, lin), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    rs = rcs.with_damping(asm, v, masks, 1e-4)
    x = torch.randn((s.num_rigs, 6), generator=gen, device=dev)
    zl = torch.randn((len(s.points_w), 3), generator=gen, device=dev)
    results["assemble_rig"] = compare(
        "assemble_rig", seg.seg_assemble_rig, (b.J, b.J_pt, lin.res, b.w, b.plan),
        [("g_r", TOL_SEG), ("diag_r", TOL_SEG), ("g_l", TOL_SEG), ("H_ll0", TOL_SEG)])
    results["precond_rig"] = compare(
        "precond_rig", seg.seg_precond_rig, (b.J, b.J_pt, b.w, rs.H_ll_inv, b.plan),
        [("blocks", TOL_SEG)])
    results["schur_down"] = compare(
        "schur_down", seg.seg_schur_down, (b.J, b.J_pt, b.w, x, b.plan),
        [("y", TOL_SEG), ("t", TOL_SEG), ("wu", TOL_SEG)])
    results["schur_up"] = compare(
        "schur_up", seg.seg_schur_up, (b.J, b.J_pt, b.w, zl, b.plan), [("y", TOL_SEG)])
    compare("schur_pcg(K4 = down + 3x3 solve + up)", seg.seg_schur_pcg,
            (b.J, b.J_pt, b.w, x, rs.H_ll_inv, b.plan), [("y", TOL_SEG)])
    del lg, asm, rs, lin, b

    # --- consistency --------------------------------------------------------
    # One LM iteration from the initial state, through the kernels and
    # through the plain versions. It runs before the main path: after a few
    # iterations the 40-iteration PCG stops far from convergence (relative
    # residual ~0.5), and its step then follows the float32 summation order.
    iters = []

    def on_iter(d):
        iters.append(d)
        phase("main", f"iter {d['iteration']}: cost {d['prev_cost']:.6g} -> {d['new_cost']:.6g} "
              f"{'accepted' if d['accepted'] else 'rejected'} | pcg {d['pcg_iters']} iters "
              f"rel {d['pcg_rel_residual']:.2e} | {d['iter_time_sec'] * 1e3:.1f} ms")

    settings = LMSettings(max_iterations=LM_ITERATIONS, direct_mode=False,
                          pcg_max_iterations=PCG_ITERATIONS, preconditioner="gauss_seidel",
                          iteration_callback=on_iter)

    def one_iteration():
        lg = k_lin(datas, v, masks, None)
        asm = k_assemble(datas, lg, v, masks)
        out = k_step(asm, datas, lg, v, masks, settings.damping, PCG_ITERATIONS,
                     settings.pcg_tol, "gauss_seidel")
        return float(out[9].cost), float(out[11]), float(out[3])

    cost_k, step_k, rel_k = one_iteration()
    with _kernels.plain_reference():
        cost_p, step_p, rel_p = one_iteration()
    dc = abs(cost_k - cost_p) / abs(cost_p)
    ds = abs(step_k - step_p) / abs(step_p)
    phase("consistency", f"new cost {cost_k:.8g} vs plain {cost_p:.8g} (rel {dc:.2e}); "
          f"|step| {step_k:.6g} vs plain {step_p:.6g} (rel {ds:.2e}); "
          f"pcg rel {rel_k:.2e} vs plain {rel_p:.2e}")
    if not (dc <= 1e-3 and ds <= 1e-3):
        raise AssertionError("kernel and plain LM iterations disagree beyond 1e-3")

    # --- main path ----------------------------------------------------------
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.time()
    summary = optimize(problem, settings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _kernels.launch_counts()
    costs = [d["prev_cost"] for d in iters] + [summary.final_cost]
    phase("main", f"{summary.num_iterations} LM iterations in {wall:.2f} s: cost "
          f"{summary.initial_cost:.6g} -> {summary.final_cost:.6g} | launches {launches}")
    if not all(math.isfinite(c) for c in costs):
        raise AssertionError(f"non-finite cost in {costs}")
    if not summary.final_cost < summary.initial_cost:
        raise AssertionError(f"cost did not fall: {summary.initial_cost} -> {summary.final_cost}")
    missing = [k for k in KERNELS if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep, launches=launches[k],
             max_abs_err=results[k]["max_abs_err"], ms=results[k]["ms"],
             plain_ms=results[k]["plain_ms"])
        for k, (src, rep) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
