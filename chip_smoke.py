#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths through the entry points a user calls:

  bias-only    the 120 s headline (1,200 rigs, 20,000 landmarks, ~394k
               Fisheye624 observations, one inertial chain with IMU bias)
               through `pipeline.builder.build_synthetic_problem` and
               `problem.optimizer.optimize` (kernels K1-K6);
  cap          bench.py's capacity configuration (build_capacity_problem's
               settings, CAP_*): a 1,800 s recording at 10 Hz, 18,000 rigs,
               60,000 landmarks, ~3.13M observations, 150 Hz IMU, 12 s
               tracks, IMU bias estimated, built on the card in float32; it
               must take the rig-only single-pass route (per-tile landmark
               windows: prb2, nhg > 0), with K1-K6 at its shapes, and run 3
               LM iterations at 40 PCG iterations (bench's timed
               iterations); peak device memory over the build and, apart,
               over consistency, phases and main;
  cap:cov      run_capacity_covariance's counterpart on the state cap
               reached: the gauge prior, prepare_system(lam=1e-6) on the
               blocked engine, the middle rig's 12 tangent columns at 200
               PCG iterations as one solve_columns call (columns/s, the
               column K4), the 12 x 12 block symmetric positive definite;
               over the dimensions the problem observes, its entries and
               standard deviations within COV_CAP_BOUNDS of a float64 solve
               through the plain versions (a float32 solve through them
               read beside it);
  :bf16        the bf16 J storage of the PCG loop (rcs.MATVEC_BF16: bf16
               copies of the single-pass batch's Jacobians read by K3, K4,
               K5, K9, K10's up pass): `cap:bf16`, `bias:bf16` and
               `full:bf16`, each on the problem its float32 path built,
               from its initial state, after that path's covariances: one
               LM step with the flag on against off (cosine, relative step
               difference, model reduction, new cost; the reference's
               bounds of tests/test_tpu_accuracy.py asserted on bias, printed
               on cap and full), consistency, the path's LM iterations
               (iteration ms beside the float32 run's; cap: peak memory),
               the bf16 instantiations launched; the bf16 kernel rows at
               cap's and full's shapes (K6 and K10's down pass with y too),
               each bit-equal to the float32 instantiation on the upcast
               copies and timed in turns with it on float32 J; on bias the
               column K4 over the records of the copies, bit-equal to the
               bf16 K4 column by column;
  pcg_switch   the same configuration at 12 Hz (21,600 rigs, ~3.76M
               observations), past pick_solver's switch at 20,000 rigs:
               pick_solver("auto") must pick Gauss-Seidel PCG, and 2 LM
               iterations run under exactly the settings it returned
               (single-pass route, K1-K6 at its shapes, consistency; peak
               device memory over the build and, apart, over consistency
               and main);
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
               K12/K13 route;
  cov          the covariance columns (`problem.covariance.rig_covariances`
               and `calib_covariances("imu_calib")`, 400 PCG iterations as
               the CLI's default) on the bias-only and full-sensor problems
               after their main runs, with the counts set to 0 just before:
               `cov:bias` 64 rigs (768 columns, chunks of 256) and every
               calibration row through the column K4, `cov:full` 4 rigs and
               the first window's 2 rows through the column K9 (K1 / K7, K2
               / K8 and K3 in each prepare_system); every block symmetric
               positive definite; a subset against the same columns in
               float64 through the plain versions (COV_BOUNDS; over the
               observed dimensions COV_OBS_BOUNDS, and within
               COV_PLAIN_RATIO of float32's own error: on cov:bias the
               medians over the problem and two copies at states moved by
               an ulp, each against its own float64 solve, of the median
               observed errors of the kernels and of a float32 solve
               through the plain versions, cov_probe.median_check; on
               cov:full one such solve); PCG device
               time an iteration, split into the column kernel and the
               rest; peak device memory beside the point-sorted records';
               one chunk in turns against a loop over its columns through
               the single-column kernel;
  multi        the full-sensor and gs_cal recordings of the 600 s session
               merged (`pipeline.multi_session.merge_sessions` of the two
               unblocked adapter problems): every landmark both adapters
               kept matched by its generated point id, gravity shared, and
               a base map (`make_base_map_batch`: constant keyrigs at the
               ground-truth camera poses of every 10th rig of the first
               recording, its observations there, factory intrinsics) as a
               point-coupled small batch; both blocked batches
               calibration-coupled single-pass, so the PCG takes the
               two-pass route: K10's down (with y) and up once per batch
               and matvec (2 x 40 launches each in one PCG, counted; the
               PCG's device time), K9 never; K10 at these shapes against
               its plain version; the
               consistency, phases and 5 LM iterations as on the other
               paths; peak device memory over the phase (K1 residual-only,
               K3, K7, K8, K10, K11);
  tools        on the host beside the multi path: a tracks CSV cut from
               the full-sensor directory's session_observations.csv (2.27M
               rows), `python -m ...tools.save_observations` on it with the
               closed-loop trajectory (stage seconds, rows kept), then
               load_session of its directory;
  cli          the command-line entry point `pipeline.cli.main` on the card
               (float32): `cli:golden` on the two committed sessions
               (tests/data/golden_session{,_full}) against their expected
               outputs, and again with --compute-covariances in float32 and
               float64 (COV_CLI_BOUNDS; over the observed dimensions
               COV_CLI_OBS_BOUNDS); `cli:full` on the full-sensor session directory
               with readout and time offset estimated, 3 LM iterations,
               --recompute-preint, the calibration evaluation, simple stats,
               a JSONL monitor and a JSON report: every output written, one
               row or record per rig, one monitor record per iteration, the
               cost falls, and K3, K7-K10 and K13c (point refinement's
               landmark sums) launch, with the counts set to 0 just before;
               then K13c on refinement's own tables of that session (D 13
               and D 1 over its landmark plan) against its plain version;
  shard        the tile-sharded blocked engine (`parallel.sharding`), two
               gloo ranks on the one card (NCCL refuses two ranks on one
               device; gloo's all_reduce takes CUDA tensors, the halo slabs
               go through pinned host buffers), spawned once while this
               process writes gs_cal's session directory (host only), each
               loading the problems from host files written by the cap and
               full paths (no rebuild): `shard:cap`, the
               capacity problem from its initial state (each rank's tiles
               and slots, the landmark and rig halo plans asserted engaged,
               the collective bytes of a PCG iteration against the (L, 3) +
               (R, 12) all-reduces they replace, none of those inside the
               loop; one LM step against the single-device step of the same
               state: cosine > 0.999, relative step difference and new cost
               within TOL_ITER; 3 LM iterations through optimize(): the
               cost falls and the ranks end with bit-equal variables;
               per-rank peak memory and iteration ms); `shard:full`, the
               full-sensor problem (K7, K8, K3, K10 on each rank's plans;
               the window tables' plans or their logged bail-outs; the step
               against one device); `shard:nccl`, the bias-only problem on a
               group of world size 1 on NCCL (its all-reduces on the card,
               the step against the fused single-device route). K1-K3, K5-K8
               and K10 must launch on every rank, K4 and K9 never (the
               sharded PCG is two-pass). Labelled "2 gloo ranks on one card,
               not multi-GPU": no multi-card run is made.

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
               K1 with the Jacobian and residual-only at the bias, cap,
               two_grid and gs_cal shapes; K2-K6 at bias and cap, K2 on
               K8's batches at full and gs_cal, K6 with y and as the main
               path calls it (t alone); K4 and K9 beside their two-pass
               floors; K13a on the two-grid landmark rows against the
               walk on the same rows;
               K13c on those rows (D 9, D 3) against the walk and
               index_add_, and on point refinement's tables (cli, D 13
               and D 1); a library call's device time read in turns with
               its kernel (K13c, K14a, K14b); the column K4 and K9
               over their point-sorted records at 1, 8, 48 and 256
               columns, each column also against the single-column kernel
               (bit-equal columns counted), their device operations a call
               the same at every C; K14a (point grid,
               D 9) and K14c (rig grid k 6) each in one device operation;
               K14a-e bit-equal across two calls; K10's down pass (with y
               and t alone) and up pass and K5 bit-equal across two calls
               in at most 3 / 2 / 2 / 1 device operations; K5 with the L2
               flushed before every timed call (its inputs fit the 50 MB
               L2)
  consistency  one LM iteration through the kernels vs the plain versions,
               from the initial state: new cost, reduced step and the step of
               the well-conditioned landmarks; and the kernel-path attempt run
               twice, bit-equal (no float atomics anywhere on the path). On
               gs_cal a second time with the extrinsics held constant, so the
               batch folds cam_intr alone (K8-K10 at kc = 17)
  phases       where one LM attempt's time goes: host time of each phase
               (synchronized, median of 3), and the device's busy share over
               one attempt (torch.profiler)
  main         5 LM iterations (cap: 3, pcg_switch: 2) through optimize()
               with the launch counts set to 0 just before; every kernel of
               the path must launch and the cost must fall

Then a JSON line of per-kernel results, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Any failure raises and exits
nonzero; without a CUDA device it exits nonzero and prints no result.

Usage: python3 chip_smoke.py  (from the repository root; needs one CUDA card)
"""

from __future__ import annotations

import contextlib
import json
import math
import resource
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
                         f"{JAXPKG}/ops/visual_fused.py:139",
                         "bias+cap+pcg_switch+gs_cal+two_grid+cov+multi+shard"),
    "assemble_rig": ("K2", f"{PKG}/csrc/assemble_rig.cu", f"{JAXPKG}/ops/segments.py:840",
                     "bias+cap+pcg_switch+cov+shard"),
    "precond_rig": ("K3", f"{PKG}/csrc/precond_rig.cu", f"{JAXPKG}/ops/segments.py:1861",
                    "bias+cap+pcg_switch+full+gs_cal+cli+cov+multi+shard"),
    "schur_pcg": ("K4", f"{PKG}/csrc/schur.cu", f"{JAXPKG}/ops/segments.py:1318,1347",
                  "bias+cap+pcg_switch"),
    "schur_pcg_cols": ("K4", f"{PKG}/csrc/schur.cu", f"{JAXPKG}/ops/segments.py:1318,1347",
                       "cov"),
    "schur_up": ("K5", f"{PKG}/csrc/schur.cu", f"{JAXPKG}/ops/segments.py:725",
                 "bias+cap+pcg_switch+shard"),
    "schur_down": ("K6", f"{PKG}/csrc/schur.cu", f"{JAXPKG}/ops/segments.py:586",
                   "bias+cap+pcg_switch+shard"),
    "rs_linearize": ("K7", f"{PKG}/csrc/rs_linearize.cu", f"{JAXPKG}/ops/rs_fused.py:131",
                     "full+cli+cov+multi+shard"),
    "assemble_cal": ("K8", f"{PKG}/csrc/cal_assemble.cu", f"{JAXPKG}/ops/segments.py:1674",
                     "full+gs_cal+cli+cov+multi+shard"),
    "schur_pcg_cal": ("K9", f"{PKG}/csrc/cal_pcg.cu",
                      f"{JAXPKG}/ops/segments.py:1468,1519", "full+gs_cal+cli"),
    "schur_pcg_cal_cols": ("K9", f"{PKG}/csrc/cal_pcg_cols.cuh",
                           f"{JAXPKG}/ops/segments.py:1468,1519", "cov"),
    "schur_down_cal": ("K10", f"{PKG}/csrc/cal_pcg.cu", f"{JAXPKG}/ops/segments.py:1005",
                       "full+gs_cal+cli+multi+shard"),
    "schur_up_cal": ("K10", f"{PKG}/csrc/cal_pcg.cu", f"{JAXPKG}/ops/segments.py:1146",
                     "full+gs_cal+cli+multi+shard"),
    "visual_cal_linearize": ("K11", f"{PKG}/csrc/visual_cal_linearize.cu",
                             f"{JAXPKG}/ops/visual_fused.py:347", "gs_cal+multi"),
    "mv_fused_table": ("K12", f"{PKG}/csrc/table_segments.cu", f"{JAXPKG}/ops/segments.py:304",
                       "two_grid"),
    "mv_scatter_table": ("K13a", f"{PKG}/csrc/table_segments.cu",
                         f"{JAXPKG}/ops/segments.py:366", "two_grid"),
    "mv_gather_table": ("K13b", f"{PKG}/csrc/table_segments.cu",
                        f"{JAXPKG}/ops/segments.py:406", "two_grid"),
    "reduce_table": ("K13c", f"{PKG}/csrc/table_segments.cu", f"{JAXPKG}/ops/segments.py:441",
                     "two_grid+profile+cli"),
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
PATHS = ("bias", "cap", "pcg_switch", "full", "gs_cal", "two_grid", "profile", "cli", "cov",
         "multi", "shard")
# the golden sessions' flags: a copy of tools_dev/gen_golden_session.py's
# CLI_ARGS / CLI_ARGS_FULL (which imports JAX; a CPU test holds them equal)
CLI_ARGS = [
    "--calib-constant", "cam-all",
    "--imu-calib-estimation-options", "gyro-bias,accel-bias",
    "--max-num-iterations", "6",
]
CLI_ARGS_FULL = [
    "--estimate-readout-time",
    "--estimate-time-offset",
    "--max-num-iterations", "6",
]
# bounds relative to the plain version's max-abs (tests/test_tpu_accuracy.py)
TOL_RES, TOL_J, TOL_SEG = 1e-5, 2e-4, 1e-5
# kernels whose ptxas report must show no register spill (the kernels
# redesigned for this card: K4's down and up passes, K9's, the landmark pass
# they share with K6, K13a's and K13c's slot-major routes on landmark rows,
# K8's window pass and its sum pass (which holds K2's landmark pass), the
# instantiations per mode of K7, K1 and K11, K2's two passes, K6's rig-row
# pass, K14b's flat gather, the tile pass of K14e, K14c and K14a, the
# column-batched K4 and K9 of the covariance columns (their fused landmark
# and rig passes), K10's rig-pair pass and its second launch, K5, and K3),
# by the names ptxas gives them: each name matches the float32 and the bf16
# instantiation (rcs.MATVEC_BF16) of the kernels of the PCG loop
NO_SPILL = ("pcg_down", "pcg_up", "pcg_cal_down", "pcg_cal_up", "point_range_sum",
            "jtu_slot_major", "reduce_gather4", "to_slot_major", "reduce_gather",
            "assemble_cal_window", "sum_cal_points", "rs_linearize_mode", "visual_linearize_mode",
            "visual_cal_linearize_mode", "assemble_rows_slots", "assemble_points",
            "schur_down_rows", "tile_gather_flat", "tile_scatter_staged", "tile_fused_staged",
            "tile_reduce_split", "point_pass_cols", "rig_row_pass_cols", "rig_pair_pass_cols",
            "rig_split_pass_cols", "cal_pair_pass", "cal_down_sums", "schur_up_rows",
            "precond_rig")
TOL_RS_RES, TOL_RS_J = 1e-4, 3e-4
TOL_CAL_J = 3e-4  # K11's Jacobian (its residual: TOL_RES)
# kernel vs plain LM iteration, relative (see the consistency phases)
TOL_ITER = 1e-3
# the K14-composed Schur matvec vs rcs.matvec (K12/K13) on the same x, relative
TOL_PROFILE = 1e-5
COND_MAX = 1e4  # landmarks whose step float32 resolves (see consistency)
LM_ITERATIONS = 5
# cli:full's LM iterations, cut from LM_ITERATIONS to hold chip_smoke's time
# once the multi path joined (direct mode: 500 PCG iterations an attempt,
# ~10 s an iteration)
CLI_FULL_ITERATIONS = 3
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


def cuda_time(fn, reps=20, warmup=3, pre=None):
    """Median milliseconds of fn() over reps, CUDA events around each call
    (pre(), if given, runs before each call, outside the events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if pre is not None:
            pre()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(fns):
    """Device time of each fn, read in turns (profile_matvec.in_turns): (device
    ms per call, device operations per call, {kernel: ms per call}) of each."""
    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm

    return pm.in_turns(fns)


def library_sum(contrib, rows):
    """K13c's library call: index_add_ of contrib's columns into their rows."""
    import torch

    out = torch.zeros((rows.n_rows, contrib.shape[0]), dtype=contrib.dtype,
                      device=contrib.device)
    idx = rows.row.long()
    return lambda: out.zero_().index_add_(0, idx, contrib.T)


def walk_plan(plan):
    """The arrays of a SegPlan that the walking segment kernels read."""
    return [plan.rig, plan.point, plan.rig_ptr, plan.rig_obs, plan.pt_ptr, plan.pt_obs]


def nbytes(*xs):
    """Bytes of every tensor in xs (through tuples, lists, NamedTuples); a
    (tensor, share) pair counts that share of the tensor's bytes."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], torch.Tensor)
              and isinstance(x[1], float)):
            total += x[0].numel() * x[0].element_size() * x[1]
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def l2_flush(clean=False):
    """A callable that evicts the L2: an in-place add over a 256 MB buffer,
    which leaves its lines dirty in the L2 (written back to device memory
    while the next kernel reads, as the LM path's kernels leave theirs),
    or, clean, a sum over it, which leaves them clean."""
    import torch

    buf = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    return (lambda: buf.sum()) if clean else (lambda: buf.add_(1.0))


def flushed_device_ms(fn, pre):
    """{kernel: (launches, device ms) per call} of fn with pre() (an L2
    flush) before every call, the flush's own kernels left out. They are
    named by a session of pre() alone; one that recorded nothing (seen on
    the H100) would leave the flush counted as fn's, so it is taken again,
    and the reading fails if none recorded the flush."""
    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm

    flush_keys = {key for key, _, _ in pm.recorded_rows(pre)}
    if not flush_keys:
        raise RuntimeError("the profiler recorded no L2 flush in three sessions")
    per = pm.per_call([pm.recorded_rows(lambda: (pre(), fn())) for _ in range(pm.SESSIONS)],
                      pm.DEVICE_REPS)
    return {key: val for key, val in per.items() if key not in flush_keys}


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

    def compare(self, name, fn, args, labels_tol, read, flops, f64=False, library=None,
                flush=False, poison=False):
        """fn(*args) -> outputs. The kernel's outputs are held against the
        plain version evaluated in float64 on the same inputs (so the bound
        measures the kernel's own error, not the float32 rounding of two
        summation orders); the kernel is timed against the plain version in
        float32, the type the main path runs. `read` lists the tensors the
        function reads (each counted once; a (tensor, share) pair counts that
        share of its bytes), `flops` its arithmetic, `library` one PyTorch
        call computing the same function (timed by events and, in turns with
        the kernel, by device time; used nowhere). flush: the L2
        is flushed before every timed call (outside the events; the flush's
        own kernel is left out of the device time), for a kernel whose
        inputs the L2 would otherwise hold across the calls; its device time
        is read again with the L2 flushed clean (no write-back of the
        flush's dirty lines in the kernel's time). poison: the outputs the
        kernel is held by are allocated (torch.empty in the wrappers) from
        blocks of the caching allocator just filled with NaN, so a row the
        kernel leaves unwritten fails the comparison."""
        from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
        import torch

        if poison:
            sizes = [(o.numel(), o.dtype) for o in flat(fn(*args))]
            torch.cuda.synchronize()
            nan = [torch.full((n,), float("nan"), dtype=dt, device="cuda") for n, dt in sizes]
            del nan
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
        pre = l2_flush() if flush else None
        ms = cuda_time(lambda: fn(*args), pre=pre)
        with _kernels.plain_reference():  # fewer repetitions: the plain K7 takes seconds
            plain_ms = cuda_time(lambda: fn(*args), reps=5, warmup=1, pre=pre)
        library_ms = (cuda_time(library, reps=5, warmup=1, pre=pre) if library is not None
                      else None)
        lib_dev = clean_ms = None
        if flush:
            per = flushed_device_ms(lambda: fn(*args), pre)
            dev_ms, dev_ops = sum(t for _, t in per.values()), sum(n for n, _ in per.values())
            dev_kern = {key: t for key, (_, t) in per.items()}
            clean = flushed_device_ms(lambda: fn(*args), l2_flush(clean=True))
            clean_ms = sum(t for _, t in clean.values())
        elif library is not None:  # the library call's device time, read in turns
            (dev_ms, dev_ops, dev_kern), (lib_dev, _, _) = in_turns([lambda: fn(*args), library])
        else:
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
              + (f" (device {lib_dev:.4f} ms in turns)" if lib_dev is not None else "")
              + (f" | device {clean_ms:.4f} ms with the L2 flushed clean ({bound_ms / clean_ms:.3f}"
                 " of the bound)" if clean_ms is not None else "")
              + " | kernels: " + ", ".join(f"{key[:40]} {t:.4f}" for key, t in dev_kern.items()))
        row = dict(max_abs_err=max(d for _, _, d in errs), ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, device_ms=dev_ms,
                   device_ops=dev_ops, device_kernels=dev_kern)
        if lib_dev is not None:
            row["library_device_ms"] = lib_dev
        if clean_ms is not None:
            row["device_ms_clean_flush"] = clean_ms
        self.results[name] = row
        return row


def vis_read(data):
    """The per-observation arrays K1 and K11 read."""
    return [data[k] for k in ("rig", "point", "intr", "extr", "bias", "bias_on", "obs_uv",
                              "sqrt_h", "_pad")]


def vis_tables(v):
    """The variable tables K1 and K11 gather from."""
    return [v.pose_q, v.pose_t, v.points, v.cam_intr, v.cam_extr_q, v.cam_extr_t, v.det_bias]


def k1_rows(bench, shape, cfg, data, v, masks, N, modes=(True, False)):
    """K1 at a path's shapes, with the Jacobian (masks applied) and
    residual-only (`modes`), against its float64 plain version. Rows
    `visual_linearize(<shape>,residual-only)`."""
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
        bench.compare(name, visual_fused.visual_linearize, args, tols, read,
                      (400.0 if with_jac else 150.0) * N, f64=True)


def assemble_rig_rows(bench, name, b, lin, n_real, poison=False):
    """K2 on a batch against its float64 plain version; at most 2 device
    operations a call."""
    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg

    args = (b.J, b.J_pt, lin.res, b.w, b.plan)
    tols = [(label, TOL_SEG) for label in ("g_r", "diag_r", "g_l", "H_ll0")]
    row = bench.compare(name, seg.seg_assemble_rig, args, tols,
                        [b.J, b.J_pt, lin.res, b.w] + walk_plan(b.plan)[2:],
                        (8 * b.rig_k + 36) * n_real, poison=poison)
    if row["device_ops"] > 2:
        raise AssertionError(f"{name}: {row['device_ops']} device operations per call")


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
    # the device's activity alone: with the host's too, summarising the
    # tracer's events of every operator took ~2 minutes of a run, and the
    # tracer slowed the attempt it measures
    acts = [torch.profiler.ProfilerActivity.CUDA]
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


# each main run's LM iteration ms, by path (run_main)
ITER_MS = {}


def run_main(path, problem, settings, kernels):
    """settings.max_iterations LM iterations through optimize(), launch
    counts set to 0 just before and read just after; returns the counts
    (the iteration ms into ITER_MS[path])."""
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
    ITER_MS[path] = [d["iter_time_sec"] * 1e3 for d in iters]
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


def lm_settings(iterations=LM_ITERATIONS):
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import LMSettings

    return LMSettings(max_iterations=iterations, direct_mode=False,
                      pcg_max_iterations=PCG_ITERATIONS, preconditioner="gauss_seidel")


# ---------------------------------------------------------------------------
# bias-only path (K1-K6)
# ---------------------------------------------------------------------------


def bias_only(dev, bench, smi):
    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.builder import (
        BuildOptions, build_synthetic_problem)
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession

    t0 = time.time()
    s = SyntheticSession(duration=120.0, keyframe_hz=10.0, gyro_hz=800.0, accel_hz=800.0,
                         num_points=20000, seed=17, pixel_noise=0.3, track_lifetime_sec=10.0)
    problem = build_synthetic_problem(
        s, BuildOptions(init_pose_noise=0.005, init_point_noise=0.03, init_vel_noise=0.03,
                        estimate_imu_calib=True,
                        imu_calib_options=dict(accelBias=True, gyroBias=True)),
        device=dev, dtype=torch.float32)
    problem._build()
    vi = next(i for i, c in enumerate(problem.cfgs) if c.block_info is not None)
    info, vdata = problem.cfgs[vi].block_info, problem.datas[vi]
    n_real = int((vdata["_pad"] < 0.5).sum())
    phase("bias:problem", f"R={s.num_rigs} L={len(s.points_w)} N={n_real} (padded "
          f"{info.nt * info.ts}) nt={info.nt} ts={info.ts} rb={info.rb} prb2={info.prb2} "
          f"nhg={info.nhg} built in {time.time() - t0:.1f} s")
    rig_kernel_rows(bench, problem, dev, "")

    # One LM iteration from the initial state, through the kernels and
    # through the plain versions (before the main path: after a few
    # iterations the 40-iteration PCG stops far from convergence and its
    # step follows the float32 summation order). 1e-3: both are float32,
    # summed in other orders; K1's float64 registers round J differently,
    # and the unconverged PCG amplifies that (PERF.md §6).
    settings = lm_settings()
    v0 = problem.variables
    consistency("bias", problem, settings, TOL_ITER)
    phase_times("bias", problem, settings)
    launches = run_main("bias", problem, settings, path_kernels("bias"))
    # the covariance columns on the state the LM run reached: 64 rigs spread
    # over the session (768 columns; rig 0, which carries the gauge prior,
    # left out: see cli_golden_covariances) and every IMU-calibration row
    R = s.num_rigs
    rigs = [int(r) for r in np.linspace(1, R - 1, 64).round()]
    rows = list(range(problem.variables.imu_calib.shape[0]))
    cov_launches = cov_path("bias", problem, dev, bench, rigs, rows, rigs[::16], rows[:2],
                            COV_CHUNK, rigs[::16], copies=COV_COPIES)
    # the flag on, from the initial state: the reference's step bounds asserted
    bf16 = bf16_path("bias", problem, v0, settings, bench, asserted=True)
    bf16_column_check(problem, dev)
    shard = shard_nccl(dev, problem, v0, smi)
    return launches, cov_launches, bf16, shard


def rig_kernel_rows(bench, problem, dev, tag):
    """K1-K6 against their float64 plain versions at the shapes of a blocked
    problem whose visual batch takes the rig-only single-pass route: K1
    with the Jacobian and residual-only, K2, K3, K6 with y and as the main
    path calls it (t alone), K5 with the L2 flushed, K4 beside its two-pass
    floor; K4 <= 3, K6 <= 2 and K5 = 1 device operations a call, K5
    repeating bit for bit. Rows `<kernel>` (tag "") or `<kernel>(<tag>)`."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    def named(kernel, mode=""):
        inner = ",".join(t for t in (tag, mode) if t)
        return kernel + (f"({inner})" if inner else "")

    ks = problem._build()
    vi = next(i for i, c in enumerate(problem.cfgs) if c.block_info is not None)
    info, vdata = problem.cfgs[vi].block_info, problem.datas[vi]
    v, masks, datas = problem.variables, problem.masks, tuple(problem.datas)
    R, L = v.pose_q.shape[0], v.points.shape[0]
    n_real = int((vdata["_pad"] < 0.5).sum())
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_rows(bench, tag, problem.active_cfgs[vi], vdata, v, masks, info.nt * info.ts)

    lg = ks[0](datas, v, masks, None)
    asm = ks[6](datas, lg, v, masks)
    (b, lin), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    rs = rcs.with_damping(asm, v, masks, 1e-4)
    k = b.rig_k
    x = torch.randn((R, k), generator=gen, device=dev)
    zl = torch.randn((L, 3), generator=gen, device=dev)
    rig_segment_rows(bench, named, b, lin, rs.H_ll_inv, x, zl, n_real, empty_rows=tag == "cap")
    args4 = (b.J, b.J_pt, b.w, x, rs.H_ll_inv, b.plan)
    index4 = [b.plan.rig, b.plan.point, b.plan.pt_pos, b.plan.pt_ptr, b.plan.rig_ptr,
              b.plan.rig_obs]
    name4 = named("schur_pcg")
    row4 = bench.compare(name4, seg.seg_schur_pcg, args4, [("y", TOL_SEG)],
                         [b.J, b.J_pt, b.w, x, rs.H_ll_inv] + index4, (8 * k + 30) * n_real)

    # the least bytes with the landmark solve between two passes: J_r, J_p
    # and w read twice, p (16 B a slot) written and read once, each index
    # array, x and hinv read once, z and y written once
    floor4 = (2 * nbytes([b.J, b.J_pt, b.w]) + 2 * 16 * n_real
              + nbytes(index4, x, rs.H_ll_inv) + 4 * (3 * L + R * k))
    row4.update(two_pass_floor_ms=floor4 / HBM_BYTES_PER_S * 1e3)
    phase("kernels", f"{name4}: two-pass floor {row4['two_pass_floor_ms']:.4f} ms")
    if row4["device_ops"] > 3:
        raise AssertionError(f"{name4}: {row4['device_ops']} device operations per call")
    del lg, asm, rs, lin, b


def rig_segment_rows(bench, named, b, lin, hinv, x, zl, n_real, poison=False, empty_rows=False):
    """K2, K3, K6 with y and as rcs.w_transpose_x calls it (t alone) and K5
    (the L2 flushed) on a rig-only single-pass batch against their float64
    plain versions (TOL_SEG), on x (R, k), z (L, 3) and the landmark
    inverses hinv; K2 <= 2, K6 <= 2 and K5 = 1 device operations a call, K5
    repeating bit for bit (K3: precond_rig_row, empty_rows there).
    `named(kernel, mode="")` names the rows; `poison`: see Bench.compare."""
    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg

    k = b.rig_k
    assemble_rig_rows(bench, named("assemble_rig"), b, lin, n_real, poison)
    precond_rig_row(bench, named("precond_rig"), b, hinv, n_real, empty_rows=empty_rows)
    # K6 with y (the multi-batch matvec) and as the main path calls it
    # (rcs.w_transpose_x: t = W^T x alone)
    for name, want_y, index6, flops6 in (
            (named("schur_down"), True, [b.plan.rig_ptr, b.plan.rig_obs], 8 * k + 17),
            (named("schur_down", "want_y=False"), False, [b.plan.rig], 4 * k + 17)):
        args6 = (b.J, b.J_pt, b.w, x, b.plan, want_y)
        tols6 = [("y", TOL_SEG)] * want_y + [("t", TOL_SEG)]
        row6 = bench.compare(name, seg.seg_schur_down, args6, tols6,
                             [b.J, b.J_pt, b.w, x, b.plan.pt_pos, b.plan.pt_ptr] + index6,
                             flops6 * n_real, poison=poison)
        if row6["device_ops"] > 2:
            raise AssertionError(f"{name}: {row6['device_ops']} device operations per call")
    # K5 walks the rig lists: it reads J_r, J_p and w of the real slots,
    # their landmark index, z, and writes y. Called once a solve, after the
    # preconditioner: its inputs would sit in the L2 across repeated calls
    # at the bias shapes (30 MB)
    real = n_real / b.J.shape[-1]
    args5 = (b.J, b.J_pt, b.w, zl, b.plan)
    row5 = bench.compare(named("schur_up"), seg.seg_schur_up, args5, [("y", TOL_SEG)],
                         [(b.J, real), (b.J_pt, real), (b.w, real), (b.plan.point, real), zl,
                          b.plan.rig_ptr, b.plan.rig_obs], (4 * k + 14) * n_real, flush=True,
                         poison=poison)
    check_repeat_and_ops(named("schur_up"), row5, seg.seg_schur_up, args5, 1)


# ---------------------------------------------------------------------------
# capacity and PCG-switch paths: 30-minute recordings on K1-K6
# ---------------------------------------------------------------------------

# bench.py's capacity configuration (build_capacity_problem, a CPU test
# holds these equal to bench.py's): 30 minutes at 10 Hz (18,000 rigs), and
# at 12 Hz (21,600 rigs), past pick_solver's switch at 20,000 rigs
CAP_DURATION = 1800.0
CAP_KEYFRAME_HZ = 10.0
CAP_POINTS = 60000
CAP_TIMED_ITERS = 3
PCGSW_DURATION = 1800.0
PCGSW_KEYFRAME_HZ = 12.0
PCGSW_POINTS = 60000
CAP_SESSION = {"gyro_hz": 150.0, "accel_hz": 150.0, "seed": 31, "pixel_noise": 0.3,
               "track_lifetime_sec": 12.0}
CAP_BUILD = {"init_pose_noise": 0.005, "init_point_noise": 0.03, "init_vel_noise": 0.03,
             "estimate_imu_calib": True,
             "imu_calib_options": {"accelBias": True, "gyroBias": True}}
# run_capacity_covariance's system and columns (bench.py): one rig's 12
# tangent columns on the damped blocked system
CAP_COV_LAM = 1e-6
CAP_COV_PCG_ITERATIONS = 200
CAP_COV_PCG_TOL = 1e-8
# the middle rig's dimensions the problem observes: all but the 3 of omega,
# which no factor of this configuration reaches (variance 1/lam)
CAP_COV_OBSERVED = 9
# cap:cov's float32 block against the float64 solve over those dimensions:
# each entry's error relative to sqrt(var_i var_j), and |std / std64 - 1|;
# ~10x the first measurement on an H100 (9.3e-5, 2.2e-5), which a float32
# solve through the plain versions gives as well (9.3e-5, 3.1e-5): the
# error is float32's at 200 PCG iterations, not the kernels'
COV_CAP_BOUNDS = {"corr": 1e-3, "std": 2e-4}


def capacity_problem(path, dev, duration, keyframe_hz, points):
    """build_capacity_problem's session on the card in float32, blocked:
    prints the path's problem line (shapes, seconds per stage) and fails
    unless R is duration x keyframe_hz and the visual batch has its
    per-tile landmark windows (prb2, nhg > 0: finalize_blocks kept it off
    the general two-grid path) and takes the rig-only single-pass route.
    Returns the problem."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.builder import (
        BuildOptions, build_synthetic_problem)
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession

    times = {}
    t0 = time.time()
    s = SyntheticSession(duration=duration, keyframe_hz=keyframe_hz, num_points=points,
                         **CAP_SESSION)
    s.observations()
    times["generator"] = time.time() - t0
    t0 = time.time()
    problem = build_synthetic_problem(s, BuildOptions(**CAP_BUILD), device=dev,
                                      dtype=torch.float32)
    torch.cuda.synchronize()
    times["build"] = time.time() - t0
    t0 = time.time()
    problem._build()
    torch.cuda.synchronize()
    times["_build"] = time.time() - t0
    vi = next(i for i, c in enumerate(problem.cfgs) if c.block_info is not None)
    info, vdata = problem.cfgs[vi].block_info, problem.datas[vi]
    R, L = problem.variables.pose_q.shape[0], problem.variables.points.shape[0]
    phase(f"{path}:problem", f"R={R} L={L} N={int((vdata['_pad'] < 0.5).sum())} (padded "
          f"{info.nt * info.ts}) nt={info.nt} ts={info.ts} rb={info.rb} prb2={info.prb2} "
          f"nhg={info.nhg} intervals={s.num_rigs - 1} | "
          + ", ".join(f"{k} {t:.1f} s" for k, t in times.items()))
    if R != int(duration * keyframe_hz):
        raise AssertionError(f"{path}: {R} rigs, not {int(duration * keyframe_hz)}")
    if not (info.prb2 > 0 and info.nhg > 0):
        raise AssertionError(f"{path}: prb2 {info.prb2}, nhg {info.nhg}: finalize_blocks sent "
                             "the visual batch to the general two-grid path")
    check_route(path, problem)
    return problem


def check_route(path, problem):
    """Fails unless the blocked visual batch takes the rig-only single-pass
    route (K4-K6) at the current state."""
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    lg = ks[0](datas, v, masks, None)
    (b, _), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    route = route_of(b)
    phase(f"{path}:problem", f"route {route} (rig_k {b.rig_k})")
    if route != "rig-only single-pass":
        raise AssertionError(f"{path}: the visual batch takes the {route} route")


def peak_memory(path, what):
    """Prints the peak device memory since the last reset of the peak
    statistics (allocated and reserved); returns both in GiB."""
    import torch

    alloc, res = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    phase(f"{path}:memory", f"peak device memory {alloc / 2**30:.2f} GiB allocated, "
          f"{res / 2**30:.2f} GiB reserved, over {what}")
    return dict(peak_allocated_gib=alloc / 2**30, peak_reserved_gib=res / 2**30)


def capacity(dev, bench, shard_dir):
    """The capacity path (bench.py's build_capacity_problem: 18,000 rigs,
    ~3.13M observations): the problem, K1-K6 at its shapes, consistency,
    phases, CAP_TIMED_ITERS LM iterations through optimize(); peak device
    memory over the build and, apart, over the LM work (the kernel rows'
    float64 plain references lie between the two readings); then cap:cov
    on the state the LM run reached; then cap:bf16 (bf16_kernel_rows,
    bf16_path) from the initial state. Returns (main's launch counts,
    cap:cov's, cap:bf16's launch and bf16 launch counts)."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    problem = capacity_problem("cap", dev, CAP_DURATION, CAP_KEYFRAME_HZ, CAP_POINTS)
    build = peak_memory("cap", "the build")
    rig_kernel_rows(bench, problem, dev, "cap")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # pick_solver("auto") would take direct mode here (18,000 < 20,000
    # rigs: 500 PCG iterations an attempt, problem/optimizer.py); the JAX
    # bench times this configuration at 40 (bench.timed_iterations), and so
    # does this path
    settings = lm_settings(CAP_TIMED_ITERS)
    v0 = problem.variables
    consistency("cap", problem, settings, TOL_ITER)
    phase_times("cap", problem, settings)
    launches = run_main("cap", problem, settings, path_kernels("cap"))
    bench.results["cap"] = dict(build=build,
                                lm=peak_memory("cap", "consistency, phases and main"))
    cov_launches = capacity_covariance(problem, bench)
    torch.cuda.empty_cache()
    bf16_kernel_rows(bench, problem, dev, "cap")
    bf16 = bf16_path("cap", problem, v0, settings, bench, peak=True)
    shard = shard_file("cap", problem, v0, shard_dir)
    shard_kernel_rows(bench, problem, dev, "cap")
    return launches, cov_launches, bf16, shard


def capacity_covariance(problem, bench):
    """cap:cov, run_capacity_covariance's counterpart (bench.py) on the
    state main reached: the gauge prior, prepare_system(lam=1e-6) on the
    blocked engine, the 12 tangent columns of the middle rig at 200 PCG
    iterations (warmed up on one column, then the 12 as one solve_columns
    call, synchronized): columns/s beside prepare_system's seconds; the
    12 x 12 block symmetric positive definite; over the dimensions the
    problem observes, its entries and standard deviations within
    COV_CAP_BOUNDS of the same columns solved in float64 through the plain
    versions (problem_f64), with a float32 solve through them read beside
    it. The column K4 must launch. Returns the launch counts."""
    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch import cov_probe
    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.problem import covariance as cov

    tag = "cap:cov"
    torch.cuda.empty_cache()
    R = problem.variables.pose_q.shape[0]
    entries = [("rig", R // 2, d) for d in range(12)]
    kw = dict(pcg_iters=CAP_COV_PCG_ITERATIONS, pcg_tol=CAP_COV_PCG_TOL)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with cov.with_gauge_prior(problem):
        t0 = time.time()
        system = cov.prepare_system(problem, lam=CAP_COV_LAM)
        torch.cuda.synchronize()
        t_prep = time.time() - t0
        if not cov.system_is_blocked(system):
            raise AssertionError(f"{tag}: prepare_system did not take the blocked engine")
        cov.solve_columns(problem, entries[:1], system=system, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        cols = cov.solve_columns(problem, entries, system=system, **kw)
        torch.cuda.synchronize()
        t_cols = time.time() - t0
        del system
    launches = _kernels.launch_counts()
    block = cov._extract_cov(cols, entries)
    phase(tag, f"rig {R // 2}: 12 columns in {t_cols:.3f} s, {12 / t_cols:.2f} columns/s "
          f"({CAP_COV_PCG_ITERATIONS} PCG iterations, tol {CAP_COV_PCG_TOL:g}); prepare_system "
          f"{t_prep:.2f} s | launches { {k: n for k, n in launches.items() if n} }")
    if not launches.get("schur_pcg_cols", 0):
        raise AssertionError(f"{tag}: the column K4 did not launch")
    cov_blocks_check(tag, {("rig", R // 2): block})
    ev = np.linalg.eigvalsh(block)
    phase(tag, f"the 12 x 12 block is finite, symmetric and positive definite: eigenvalues "
          f"{ev.min():.3e} to {ev.max():.3e}")
    del cols
    torch.cuda.empty_cache()

    def plain_block(p):
        t0 = time.time()
        with _kernels.plain_reference(), cov.with_gauge_prior(p):
            c = cov.solve_columns(p, entries, system=cov.prepare_system(p, lam=CAP_COV_LAM), **kw)
        torch.cuda.synchronize()
        return cov._extract_cov(c, entries), time.time() - t0

    block64, t64 = plain_block(cov_probe.problem_f64(problem))
    torch.cuda.empty_cache()
    # the same solve in float32 through the plain versions: what float32
    # alone gives at 200 PCG iterations, beside the kernels' error
    block32, t32 = plain_block(problem)
    torch.cuda.empty_cache()
    phase(tag, f"plain references: float64 in {t64:.1f} s, float32 in {t32:.1f} s")
    n_obs, corr, ratio = observed_errors(block, block64, CAP_COV_LAM)
    _, corr32, ratio32 = observed_errors(block32, block64, CAP_COV_LAM)
    phase(tag, f"float32 vs float64 over the {n_obs} observed dimensions of 12 (variance < "
          f"1/(2 lam)): entries {corr:.3e} of {COV_CAP_BOUNDS['corr']:g} (relative to "
          f"sqrt(var_i var_j)), std ratio {ratio:.3e} of {COV_CAP_BOUNDS['std']:g}; float32 "
          f"through the plain versions {corr32:.3e} / {ratio32:.3e}")
    if n_obs != CAP_COV_OBSERVED:
        raise AssertionError(f"{tag}: {n_obs} observed dimensions, not {CAP_COV_OBSERVED}")
    if not (corr <= COV_CAP_BOUNDS["corr"] and ratio <= COV_CAP_BOUNDS["std"]):
        raise AssertionError(f"{tag}: the block is off the float64 run beyond its bounds: "
                             f"entries {corr:.3e}, std ratio {ratio:.3e}")
    bench.results.setdefault("cov", {})["cap"] = dict(
        columns=12, seconds=t_cols, columns_per_s=12 / t_cols, prepare_seconds=t_prep,
        observed_dims=n_obs, worst_entry_error=corr, worst_std_ratio=ratio,
        plain32_entry_error=corr32, plain32_std_ratio=ratio32)
    return launches


def observed_errors(got, want, lam):
    """A covariance block against its float64 counterpart over the
    dimensions the problem observes: those whose float64 variance is below
    1 / (2 lam) (a dimension no factor reaches has variance 1/lam, which
    would set the scale of an error relative to the block's largest
    entry). Returns their count, the worst entry error relative to
    sqrt(W_ii W_jj) and the worst |std / std64 - 1|."""
    import numpy as np

    obs = np.diag(want) < 0.5 / lam
    G, W = got[np.ix_(obs, obs)], want[np.ix_(obs, obs)]
    sd = np.sqrt(np.diag(W))
    corr = float((np.abs(G - W) / np.outer(sd, sd)).max()) if obs.any() else 0.0
    ratio = float(np.abs(np.sqrt(np.diag(G)) / sd - 1.0).max()) if obs.any() else 0.0
    return int(obs.sum()), corr, ratio


def pcg_switch(dev, bench):
    """The PCG-switch path: pick_solver("auto") at 21,600 rigs must pick
    Gauss-Seidel PCG (bench.run_pcg_switch's check), then the capacity
    configuration at 12 Hz: R 21,600, the single-pass route, K1-K6 at its
    shapes (the port's largest N), consistency, CAP_TIMED_ITERS LM
    iterations through optimize() under exactly the settings pick_solver
    returned; peak device memory over the build and, apart, over
    consistency and main. Returns the launch counts."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import (LMSettings,
                                                                               pick_solver)

    n_rigs = int(PCGSW_DURATION * PCGSW_KEYFRAME_HZ)
    settings = pick_solver(LMSettings(max_iterations=CAP_TIMED_ITERS), n_rigs, "auto")
    phase("pcg_switch:solver", f"pick_solver(auto) at {n_rigs} rigs: direct_mode "
          f"{settings.direct_mode}, preconditioner {settings.preconditioner}, "
          f"pcg_max_iterations {settings.pcg_max_iterations}")
    if settings.direct_mode or settings.preconditioner != "gauss_seidel":
        raise AssertionError(f"pcg_switch: pick_solver(auto) at {n_rigs} rigs gave direct_mode "
                             f"{settings.direct_mode}, preconditioner {settings.preconditioner}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    problem = capacity_problem("pcg_switch", dev, PCGSW_DURATION, PCGSW_KEYFRAME_HZ,
                               PCGSW_POINTS)
    build = peak_memory("pcg_switch", "the build")
    rig_kernel_rows(bench, problem, dev, "pcg_switch")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    consistency("pcg_switch", problem, settings, TOL_ITER)
    launches = run_main("pcg_switch", problem, settings, path_kernels("pcg_switch"))
    bench.results["pcg_switch"] = dict(build=build,
                                       lm=peak_memory("pcg_switch", "consistency and main"))
    return launches


# ---------------------------------------------------------------------------
# bf16 J storage of the PCG loop (rcs.MATVEC_BF16): cap:bf16, bias:bf16,
# full:bf16 on the problems their float32 paths built
# ---------------------------------------------------------------------------

# the bf16 instantiations each flagged main path must launch (the
# back-substitution's K6 / K10 down pass reads float32 J)
BF16_PATHS = {"bias:bf16": ("precond_rig", "schur_pcg", "schur_up"),
              "cap:bf16": ("precond_rig", "schur_pcg", "schur_up"),
              "full:bf16": ("precond_rig", "schur_pcg_cal", "schur_up_cal")}
# one LM step with the flag on against off, read as
# tests/test_tpu_accuracy.py:86-97 reads it, at its damping, PCG
# iterations and tolerance; its bounds (step cosine, relative step
# difference, model reduction and new cost, relative) are asserted on
# bias:bf16 and printed on cap:bf16 and full:bf16 (the reference states them
# for a 60 s problem)
STEP_LAM, STEP_TOL = 1e-4, 1e-10
STEP_BOUNDS = {"cos": 0.999, "rel": 0.05, "model": 2e-2, "cost": 1e-3}
BF16_COLS = 8  # the column K4 on the records of the copies, held to the bf16 K4


@contextlib.contextmanager
def matvec_bf16():
    """rcs.MATVEC_BF16 on inside, restored after."""
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    saved = rcs.MATVEC_BF16
    rcs.MATVEC_BF16 = True
    try:
        yield
    finally:
        rcs.MATVEC_BF16 = saved


def one_step(problem):
    """One LM attempt from the current state at STEP_LAM, PCG_ITERATIONS,
    STEP_TOL: (linearization, the step kernel's outputs)."""
    import torch

    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    lg = ks[0](datas, v, masks, None)
    out = ks[7](ks[6](datas, lg, v, masks), datas, lg, v, masks, STEP_LAM, PCG_ITERATIONS,
                STEP_TOL, "gauss_seidel")
    torch.cuda.synchronize()
    return lg, out


def step_agreement(tag, problem, asserted):
    """One LM step with the flag on against the same step with it off, from
    the current state: the step's cosine and relative difference (x_r and
    x_l flattened), model reduction and new cost, relative; within
    STEP_BOUNDS when `asserted`."""
    import torch

    with matvec_bf16():
        lg_a, out_a = one_step(problem)
    lg_b, out_b = one_step(problem)

    def flat_step(out):
        return torch.cat([getattr(out[0], f).double().reshape(-1) for f in out[0]._fields]
                         + [out[1].double().reshape(-1)])

    sa, sb = flat_step(out_a), flat_step(out_b)
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa: E731
    got = dict(cos=float(sa @ sb / (sa.norm() * sb.norm())), rel=float((sa - sb).norm() / sb.norm()),
               model=rel(out_a[2], out_b[2]), cost=rel(out_a[9].cost, out_b[9].cost),
               lin_cost=rel(lg_a.cost, lg_b.cost), model_bf16=float(out_a[2]),
               model_f32=float(out_b[2]), cost_bf16=float(out_a[9].cost),
               cost_f32=float(out_b[9].cost))
    ok = (got["cos"] > STEP_BOUNDS["cos"] and got["rel"] < STEP_BOUNDS["rel"]
          and got["model"] <= STEP_BOUNDS["model"] and got["cost"] <= STEP_BOUNDS["cost"])
    phase(tag, f"one LM step (lam {STEP_LAM:g}, {PCG_ITERATIONS} PCG iterations, tol "
          f"{STEP_TOL:g}) bf16 J against float32: cosine {got['cos']:.6f} (bound > "
          f"{STEP_BOUNDS['cos']}), relative step difference {got['rel']:.3e} (< "
          f"{STEP_BOUNDS['rel']}), model reduction {got['model_bf16']:.8g} vs "
          f"{got['model_f32']:.8g} (rel {got['model']:.3e}, {STEP_BOUNDS['model']:g}), new cost "
          f"{got['cost_bf16']:.8g} vs {got['cost_f32']:.8g} (rel {got['cost']:.3e}, "
          f"{STEP_BOUNDS['cost']:g}), linearized cost rel {got['lin_cost']:.1e}: "
          + ("within the reference's bounds" if ok else "OUTSIDE the reference's bounds")
          + ("" if asserted else " (not asserted at this size)"))
    if asserted and not ok:
        raise AssertionError(f"{tag}: the bf16 step is off the float32 step beyond the "
                             f"reference's bounds: {got}")
    return got


def bf16_path(path, problem, v0, settings, bench, asserted=False, peak=False):
    """`<path>:bf16`: the path's problem from its initial state v0 with
    rcs.MATVEC_BF16 on: one LM step against the float32 step
    (step_agreement), the consistency iteration (the kernel path twice,
    bit-equal, then against the plain versions on the same copies),
    settings.max_iterations LM iterations through optimize() with the counts
    set to 0 just before (every kernel of the path launched, the bf16
    instantiations of BF16_PATHS among them; iteration ms beside the float32
    run's, read in this call; peak device memory over main with `peak`).
    Returns (launch counts, bf16 launch counts)."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels

    tag = f"{path}:bf16"
    problem.variables = v0
    res = {"step": step_agreement(tag, problem, asserted)}
    with matvec_bf16():
        consistency(tag, problem, settings, TOL_ITER)
        if peak:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        launches = run_main(tag, problem, settings, path_kernels(path))
        bf16 = _kernels.launch_counts(bf16=True)
        if peak:
            res["lm"] = peak_memory(tag, "consistency and main")
    missing = [k for k in BF16_PATHS[tag] if not bf16.get(k)]
    f32_ms, bf16_ms = statistics.median(ITER_MS[path]), statistics.median(ITER_MS[tag])
    phase(tag, f"LM iteration median {bf16_ms:.1f} ms with bf16 J against {f32_ms:.1f} ms for "
          f"the float32 run of this call (host-bound: PERF.md section 5) | bf16 launches "
          f"{ {k: n for k, n in bf16.items() if n} }")
    if missing:
        raise AssertionError(f"{tag}: bf16 instantiations not launched on the main path: "
                             f"{missing}")
    res.update(iteration_ms=ITER_MS[tag], iteration_ms_f32=ITER_MS[path])
    bench.results.setdefault("bf16", {})[path] = res
    return launches, bf16


def bf16_kernel_rows(bench, problem, dev, tag):
    """The bf16 instantiations at a single-pass batch's shapes, the flag on:
    K3, K4, K5 (the L2 flushed) and K6 with y and t alone on a rig-only
    batch, K3, K9 and K10's down pass with y and t alone and its up pass on
    a calibration-coupled one (K6's and K10's down pass with y run only on
    the route with several batches: launched here on these plans). Rows
    `<kernel>(<tag>,[<mode>,]bf16)`: each against its plain version on the
    same bf16 values evaluated in float64 (TOL_SEG), its bound counting J at
    2 B an element; bit-equal to the float32 instantiation on the copies
    upcast; its device time in turns with the float32 instantiation on the
    batch's float32 J."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    with matvec_bf16():
        lg = ks[0](datas, v, masks, None)
        asm = ks[6](datas, lg, v, masks)
    (b,) = asm.vis
    rs = rcs.with_damping(asm, v, masks, 1e-4)
    k, R, L = b.rig_k, v.pose_q.shape[0], v.points.shape[0]
    n_real, N = int(b.plan.rig_obs.shape[0]), b.J.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((R, k), generator=gen, device=dev)
    zl = torch.randn((L, 3), generator=gen, device=dev)
    J, Jp, Jc, hinv = b.J_mv, b.J_pt_mv, b.J_cal_mv, rs.H_ll_inv
    plan = walk_plan(b.plan)
    real = n_real / N
    tol = lambda *names: [(nm, TOL_SEG) for nm in names]  # noqa: E731
    index6 = [b.J_mv, b.J_pt_mv, b.w, x, b.plan.pt_pos, b.plan.pt_ptr]
    if rcs._rig_only_fast(b):
        rows = [("precond_rig", "", seg.seg_precond_rig, (J, Jp, b.w, hinv, b.plan),
                 tol("blocks"), k3_read(J, Jp, b.w, hinv, b.plan, n_real), k3_flops(k, n_real),
                 False),
                ("schur_down", "", seg.seg_schur_down, (J, Jp, b.w, x, b.plan, True),
                 tol("y", "t"), index6 + [b.plan.rig_ptr, b.plan.rig_obs], (8 * k + 17) * n_real,
                 False),
                ("schur_down", "want_y=False", seg.seg_schur_down, (J, Jp, b.w, x, b.plan, False),
                 tol("t"), index6 + [b.plan.rig], (4 * k + 17) * n_real, False),
                ("schur_up", "", seg.seg_schur_up, (J, Jp, b.w, zl, b.plan), tol("y"),
                 [(J, real), (Jp, real), (b.w, real), (b.plan.point, real), zl,
                  b.plan.rig_ptr, b.plan.rig_obs], (4 * k + 14) * n_real, True),
                ("schur_pcg", "", seg.seg_schur_pcg, (J, Jp, b.w, x, hinv, b.plan), tol("y"),
                 [J, Jp, b.w, x, hinv, b.plan.rig, b.plan.point, b.plan.pt_pos, b.plan.pt_ptr,
                  b.plan.rig_ptr, b.plan.rig_obs], (8 * k + 30) * n_real, False)]
        jpos, f32_J = (0, 1), (b.J, b.J_pt)
    else:
        kc, cp = Jc.shape[1], b.cplan
        xc = torch.randn((cp.n_rows, kc), generator=gen, device=dev)
        cplan = list(cp)[:4]
        jread = [J, Jp, Jc, b.w]
        index9 = [b.plan.rig, cp.win, b.plan.point, b.plan.pt_pos, b.plan.pt_ptr, cp.rig_pair,
                  cp.pair_ptr, cp.pair_obs, cp.pair_part, cp.win_pair]
        rows = [("precond_rig", "", lambda Jr, Jcc, Jpp, *a: seg.seg_precond_rig(Jr, Jpp, *a),
                 (J, Jc, Jp, b.w, hinv, b.plan), tol("blocks"),
                 k3_read(J, Jp, b.w, hinv, b.plan, n_real), k3_flops(k, n_real), False),
                ("schur_pcg_cal", "", seg.seg_schur_pcg_cal,
                 (J, Jc, Jp, b.w, x, xc, hinv, b.plan, cp), tol("y_r", "y_c"),
                 jread + [x, xc, hinv] + index9, (8 * k + 8 * kc + 24) * n_real, False),
                ("schur_down_cal", "", seg.seg_schur_down_cal, (J, Jc, Jp, b.w, x, xc, b.plan, cp),
                 tol("y_r", "y_c", "t"), jread + [x, xc] + plan + cplan,
                 (8 * k + 8 * kc + 16) * n_real, False),
                ("schur_down_cal", "want_y=False", seg.seg_schur_down_cal,
                 (J, Jc, Jp, b.w, x, xc, b.plan, cp, False), tol("t"),
                 jread + [x, xc] + plan + cplan[:1], (4 * k + 4 * kc + 16) * n_real, False),
                ("schur_up_cal", "", seg.seg_schur_up_cal, (J, Jc, Jp, b.w, zl, b.plan, cp),
                 tol("y_r", "y_c"), jread + [zl] + plan + cplan, (4 * k + 4 * kc + 14) * n_real,
                 False)]
        jpos, f32_J = (0, 1, 2), (b.J, b.J_cal, b.J_pt)
    for kernel, mode, fn, args, tols, read, flops, flush in rows:
        name = f"{kernel}({','.join(t for t in (tag, mode, 'bf16') if t)})"
        row = bench.compare(name, fn, args, tols, read, flops, flush=flush,
                            poison=kernel == "precond_rig")
        if kernel == "precond_rig":
            k3_readings(name, row, (J, Jp, b.w, hinv, b.plan))
        up = tuple(a.float() if i in jpos else a for i, a in enumerate(args))
        if not all(torch.equal(p, q) for p, q in zip(flat(fn(*args)), flat(fn(*up)))):
            raise AssertionError(f"{name}: not the float32 instantiation's bits on the upcast "
                                 "copies")
        f32 = tuple(f32_J[jpos.index(i)] if i in jpos else a for i, a in enumerate(args))
        if flush:  # each read with the L2 flushed dirty before every call
            pre = l2_flush()
            f32_ms = sum(t for _, t in flushed_device_ms(lambda: fn(*f32), pre).values())
            bf16_ms = sum(t for _, t in flushed_device_ms(lambda: fn(*args), pre).values())
        else:
            (bf16_ms, _, _), (f32_ms, _, _) = in_turns([lambda: fn(*args), lambda: fn(*f32)])
        row.update(kernel=kernel, bit_equal_f32=True, bf16_device_ms_in_turns=bf16_ms,
                   f32_device_ms_in_turns=f32_ms)
        phase("kernels", f"{name}: bit-equal to the float32 instantiation on the upcast copies; "
              f"in turns with it on float32 J: {bf16_ms:.4f} ms against {f32_ms:.4f} ms device "
              f"({f32_ms / bf16_ms:.2f}x)")
    del lg, asm, rs, b


def bf16_column_check(problem, dev):
    """With the flag on, the column K4 at BF16_COLS columns over the records
    of the system (rcs.with_column_records: the bf16 copies upcast) against
    the bf16 K4 column by column: every column bit-equal."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    with matvec_bf16():
        lg = ks[0](datas, v, masks, None)
        rs = rcs.with_column_records(rcs.with_damping(ks[6](datas, lg, v, masks), v, masks,
                                                      1e-4))
    (b,) = rs.vis
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((v.pose_q.shape[0], b.rig_k, BF16_COLS), generator=gen, device=dev)
    out = seg.seg_schur_pcg_cols(b.J_mv, b.J_pt_mv, b.w, x, rs.H_ll_inv, b.plan, rec=b.rec)
    same = sum(bool(torch.equal(out[..., c], seg.seg_schur_pcg(
        b.J_mv, b.J_pt_mv, b.w, x[..., c].contiguous(), rs.H_ll_inv, b.plan)))
        for c in range(BF16_COLS))
    phase("bias:bf16", f"schur_pcg_cols (C={BF16_COLS}) over the records of the bf16 copies: "
          f"{same} of {BF16_COLS} columns bit-equal to the bf16 schur_pcg")
    if same != BF16_COLS:
        raise AssertionError("bias:bf16: the column K4 on the copies' records is not the bf16 "
                             "K4's bits")


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


def write_600(session, path, readout_time_sec):
    """write_session_dir of the 600 s session into path; returns seconds."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic_io import (
        write_session_dir)

    t0 = time.time()
    write_session_dir(session, path, num_imus=2, readout_time_sec=readout_time_sec, seed=23)
    return time.time() - t0


def adapter_build(dev, session_dir, times, options):
    """load_session -> SessionAdapter.build of a session directory, the
    stage seconds into `times`; returns the unblocked (problem, adapter)."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as sio
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import SessionAdapter

    t0 = time.time()
    sd = sio.load_session(session_dir)
    times["load"] = time.time() - t0
    t0 = time.time()
    adapter = SessionAdapter(sd, options, log=lambda *a: None, device=dev, dtype=torch.float32)
    problem = adapter.build()
    torch.cuda.synchronize()
    times["adapter"] = time.time() - t0
    times.update({f"  {k}": val for k, val in adapter.timings.items()})
    return problem, adapter


def adapter_problem(path, dev, session_dir, times, options):
    """adapter_build, then the blocking of the problem; prints the path's
    problem line (with the stage seconds in `times`) and returns (problem,
    adapter, index of the blocked visual batch)."""
    problem, adapter = adapter_build(dev, session_dir, times, options)
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
    jread = [b.J, b.J_pt, b.J_cal, b.w]
    kc = b.J_cal.shape[1]
    seg_tol = lambda *names: [(nm, TOL_SEG) for nm in names]  # noqa: E731
    if kc == 23:  # K3 does not depend on the window columns
        precond_rig_row(bench, f"precond_rig{suffix or f'(k={k})'}", b, rs.H_ll_inv, n_real)
    if kc != 17:  # K2, whose two passes K8 runs, alone on this batch (no window column)
        assemble_rig_rows(bench, f"assemble_rig{suffix or '(full)'}", b, lin, n_real)
    assemble_cal_row(bench, f"assemble_cal{suffix}", b, lin)
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
    k10_rows(bench, b, x, xc, zl, suffix)


def k3_read(J, J_pt, w, hinv, plan, n_real):
    """What K3's function must read: J_r, J_p, w and the landmark index of
    each real slot, the rig lists, the H_ll^-1 table once."""
    real = n_real / w.shape[0]
    return [(J, real), (J_pt, real), (w, real), (plan.point, real), plan.rig_ptr, plan.rig_obs,
            hinv]


def k3_flops(k, n_real):
    """The fewest operations K3's function needs a real slot: as J_r^T M
    J_r, M = w I - w^2 J_p h J_p^T (~33 FMAs), M J_r (4k) and the triangle
    (2 FMAs an entry)."""
    return 2 * (33 + 4 * k + k * (k + 1)) * n_real


def precond_rig_row(bench, name, b, hinv, n_real, empty_rows=False):
    """K3 on a single-pass batch against its float64 plain version from
    NaN-filled output memory; then k3_readings."""
    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg

    args = (b.J, b.J_pt, b.w, hinv, b.plan)
    row = bench.compare(name, seg.seg_precond_rig, args, [("blocks", TOL_SEG)],
                        k3_read(*args, n_real), k3_flops(b.rig_k, n_real), poison=True)
    k3_readings(name, row, args, empty_rows)
    return row


def k3_readings(name, row, args, empty_rows=False):
    """K3 (args: J_r, J_p, w, hinv, plan) bit-equal over two calls in at
    most 2 device operations; with empty_rows, its device time in turns on
    the batch's plan with every rig row empty (the same R, rig_ptr all
    zero) and on the whole batch."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg

    check_repeat_and_ops(name, row, seg.seg_precond_rig, args, 2)
    if empty_rows:
        plan = args[-1]
        empty = plan._replace(rig_ptr=torch.zeros_like(plan.rig_ptr))
        (e_ms, _, _), (w_ms, _, _) = in_turns([lambda: seg.seg_precond_rig(*args[:-1], empty),
                                               lambda: seg.seg_precond_rig(*args)])
        row.update(empty_rows_device_ms=e_ms, whole_device_ms=w_ms)
        phase("kernels", f"{name}: every rig row empty {e_ms:.4f} ms device against the "
              f"whole batch's {w_ms:.4f} ({e_ms / w_ms:.2f})")


def assemble_cal_row(bench, name, b, lin, poison=False):
    """K8 on a calibration-coupled batch against its float64 plain
    version; at most 3 device operations a call."""
    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg

    k, kc, n_real = b.rig_k, b.J_cal.shape[1], int(b.plan.rig_obs.shape[0])
    n_out = seg.n_cal_out(seg.CAL_SPLITS[kc])
    args8 = (b.J, b.J_cal, b.J_pt, lin.res, b.w, b.plan, b.cplan)
    tols8 = [(nm, TOL_SEG) for nm in ("g_r", "diag_r", "g_c", "diag_c",
                                      *(f"blocks_{g}" for g, _ in b.cal_groups), "g_l", "H_ll0")]
    row8 = bench.compare(name, seg.seg_assemble_cal, args8, tols8,
                         [b.J, b.J_pt, b.J_cal, b.w, lin.res] + walk_plan(b.plan)
                         + list(b.cplan)[:4], (8 * k + 36 + 4 * kc + 5 * (n_out - kc)) * n_real,
                         poison=poison)
    if row8["device_ops"] > 3:
        raise AssertionError(f"{name}: {row8['device_ops']} device operations per call")


def k10_rows(bench, b, x, xc, zl, suffix, poison=False):
    """K10 on a calibration-coupled batch against its float64 plain
    version: the down pass with y (the two-pass PCG matvec), as
    rcs.w_transpose_x calls it (t = W^T x alone) and the up pass; each
    repeats bit for bit, within its device operations a call. Each bound
    counts J_r, J_c, J_p and w, the walking plans' index arrays and x or z
    read once and the outputs written once, whichever lists the design
    reads."""
    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg

    k, kc, n_real = b.rig_k, b.J_cal.shape[1], int(b.plan.rig_obs.shape[0])
    plan, cplan = walk_plan(b.plan), list(b.cplan)[:4]
    jread = [b.J, b.J_pt, b.J_cal, b.w]
    seg_tol = lambda *names: [(nm, TOL_SEG) for nm in names]  # noqa: E731
    rows = (
        (f"schur_down_cal{suffix}", seg.seg_schur_down_cal,
         (b.J, b.J_cal, b.J_pt, b.w, x, xc, b.plan, b.cplan), seg_tol("y_r", "y_c", "t"),
         jread + [x, xc] + plan + cplan, (8 * k + 8 * kc + 16) * n_real, 3),
        (f"schur_down_cal{suffix}(want_y=False)", seg.seg_schur_down_cal,
         (b.J, b.J_cal, b.J_pt, b.w, x, xc, b.plan, b.cplan, False), seg_tol("t"),
         jread + [x, xc] + plan + cplan[:1], (4 * k + 4 * kc + 16) * n_real, 2),
        (f"schur_up_cal{suffix}", seg.seg_schur_up_cal,
         (b.J, b.J_cal, b.J_pt, b.w, zl, b.plan, b.cplan), seg_tol("y_r", "y_c"),
         jread + [zl] + plan + cplan, (4 * k + 4 * kc + 14) * n_real, 2))
    for name, fn, args, tols, read, flops, max_ops in rows:
        row = bench.compare(name, fn, args, tols, read, flops, poison=poison)
        check_repeat_and_ops(name, row, fn, args, max_ops)


def check_repeat_and_ops(name, row, fn, args, max_ops):
    """A kernel's outputs bit-equal over two calls, and at most max_ops
    device operations a call."""
    import torch

    one, two = flat(fn(*args)), flat(fn(*args))
    if not all(torch.equal(a, c) for a, c in zip(one, two)):
        raise AssertionError(f"{name}: two calls differ")
    if row["device_ops"] > max_ops:
        raise AssertionError(f"{name}: {row['device_ops']} device operations per call")


def full_sensor(dev, bench, session_dir, times, shard_dir):
    """The full-sensor path on the session directory written for it (kept
    for cli:full); then full:bf16 (bf16_kernel_rows, bf16_path) from the
    initial state."""
    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import rs_fused
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import AdapterOptions

    problem, adapter, vi = adapter_problem(
        "full", dev, session_dir, times,
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
    v0 = problem.variables
    consistency("full", problem, settings, TOL_ITER)
    phase_times("full", problem, settings)
    launches = run_main("full", problem, settings, path_kernels("full"))
    # the covariance columns: 4 rigs (48 columns) and the IMU-calibration
    # rows of the first window (2 x 23 columns); the problem is the full
    # one, only the columns are cut (to hold chip_smoke's time: 16 rigs and
    # 4 windows took 161 s at 400 iterations, and the float64 reference 150)
    R = v.pose_q.shape[0]
    rigs = [int(r) for r in np.linspace(1, R - 1, 4).round()]
    rows = list(range(adapter.num_imus))
    cov_launches = cov_path("full", problem, dev, bench, rigs, rows, rigs[:1], rows[:1], 32, [])
    torch.cuda.empty_cache()
    bf16_kernel_rows(bench, problem, dev, "full")
    bf16 = bf16_path("full", problem, v0, settings, bench)
    shard = shard_file("full", problem, v0, shard_dir)
    shard_kernel_rows(bench, problem, dev, "full")
    return launches, cov_launches, bf16, shard


# ---------------------------------------------------------------------------
# global-shutter calibration path (K11; K1 residual-only; K8-K10, K3 at rig_k = 6)
# ---------------------------------------------------------------------------


def gs_cal(dev, bench, gs_dir, times):
    """The global-shutter calibration path on the session directory written
    into gs_dir (kept for the multi path; `times`: the session's and the
    write's seconds)."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import visual_fused
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import AdapterOptions

    problem, adapter, vi = adapter_problem("gs_cal", dev, gs_dir, times, AdapterOptions())
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
    bench.compare(
        "visual_cal_linearize", visual_fused.visual_cal_linearize, args11,
        [("res", TOL_RES), ("valid", TOL_RES), ("J_pt", TOL_CAL_J), ("J_r", TOL_CAL_J),
         ("J_cal", TOL_CAL_J)],
        vis_read(data) + vis_tables(v) + [masks.rig, masks.points, masks.cam_intr,
                                          masks.cam_extr],
        700.0 * N, f64=True)
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
# multi-session path: the full-sensor and gs_cal recordings merged (K1
# residual-only, K3, K7, K8, K10 down with y and up in the PCG, K11)
# ---------------------------------------------------------------------------

MULTI_BASE_MAP_EVERY = 10  # base-map keyrigs: every 10th rig of session A (1 Hz)


def landmark_ids(adapter):
    """Generated point id of each landmark row of an adapter's problem: the
    sorted unique ids of the observations it kept (at rig timestamps, in
    tracks of >= 3; adapter.py's landmark rows)."""
    import numpy as np

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import triangulation as tri

    sd = adapter.sd
    pos = np.clip(np.searchsorted(adapter.rig_ts_us, sd.obs_timestamp_us), 0, adapter.R - 1)
    pid = sd.obs_point_id[adapter.rig_ts_us[pos] == sd.obs_timestamp_us]
    uniq, counts = np.unique(pid, return_counts=True)
    return uniq[counts >= tri.MIN_INLIER_OBS]


def base_map(session, adapter, ids_a, point_map, dev, dtype=None):
    """The base-map batch: constant keyrigs at the ground-truth camera poses
    of every MULTI_BASE_MAP_EVERY-th rig of session A, carrying session A's
    observations there (its kept landmarks, mapped through point_map), the
    factory intrinsics, sqrt_h from the observations, Fisheye624; float32
    unless `dtype` says otherwise. Returns ((cfg, data), keyrigs)."""
    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import camera as cam_ops
    from visual_inertial_bundle_adjustment_tpu_torch.ops import lie
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import multi_session as ms

    sd = adapter.sd
    rig_ts = adapter.rig_ts_us[::MULTI_BASE_MAP_EVERY]
    sel = np.isin(sd.obs_timestamp_us, rig_ts) & np.isin(sd.obs_point_id, ids_a)
    pid, cam = sd.obs_point_id[sel], sd.obs_camera_index[sel].astype(np.int64)
    gt = np.searchsorted(np.round(session.rig_times * 1e6).astype(np.int64),
                         sd.obs_timestamp_us[sel])
    qcb = torch.from_numpy(np.stack([session.cam_extr[c][0] for c in range(session.num_cameras)]))
    tcb = torch.from_numpy(np.stack([session.cam_extr[c][1] for c in range(session.num_cameras)]))
    q_bw, t_bw = torch.from_numpy(session.gt_pose_q[gt]), torch.from_numpy(session.gt_pose_t[gt])
    q_cw = lie.quat_mul(qcb[cam], q_bw)
    t_cw = tcb[cam] + lie.quat_rotate(qcb[cam], t_bw)
    intr = np.stack([sd.factory.cameras[f].params for f in adapter.cam_to_factory])
    rows = point_map[np.searchsorted(ids_a, pid)]  # session A's rows are offset 0
    batch = ms.make_base_map_batch(rows, q_cw, t_cw, intr[cam], sd.obs_uv[sel],
                                   sd.obs_sqrt_h[sel], cam_ops.KIND_FISHEYE624, device=dev,
                                   dtype=dtype or torch.float32)
    return batch, len(rig_ts)


def route_of(b):
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    if rcs._rig_only_fast(b):
        return "rig-only single-pass"
    return "calibration-coupled single-pass" if rcs._cal_fast(b) else "general"


def pcg_device(rs, v, b_rhs, settings):
    """One PCG_ITERATIONS-iteration PCG under torch.profiler: (device ms,
    device operations, the five kernels that take the most time)."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    rcs.pcg(rs, v, b_rhs, PCG_ITERATIONS, settings.pcg_tol)
    torch.cuda.synchronize()
    # the device's activity alone (phase_times says why)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        rcs.pcg(rs, v, b_rhs, PCG_ITERATIONS, settings.pcg_tol)
        torch.cuda.synchronize()
    rows = pm.device_kernels(prof.key_averages())
    if not rows:
        raise AssertionError("multi: the profiler recorded no device time in the PCG")
    return (sum(us for _, _, us in rows) / 1e3, sum(n for _, n, _ in rows),
            sorted(rows, key=lambda r: -r[2])[:5])


def multi_session(dev, bench, session, full_dir, gs_dir):
    """The two 600 s recordings (full sensor, rolling shutter; gs_cal,
    global shutter) merged by pipeline.multi_session.merge_sessions: their
    landmarks matched by generated point id, gravity shared, a base map of
    constant keyrigs; shapes, matches and the route of each blocked batch,
    the PCG's K10 launches, K10 at these shapes, consistency, phases and 5
    LM iterations; peak device memory over the phase."""
    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import multi_session as ms
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.adapter import AdapterOptions
    from visual_inertial_bundle_adjustment_tpu_torch.problem import engine, rcs
    from visual_inertial_bundle_adjustment_tpu_torch.problem.structure import t_sub

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, problems, adapters = {}, [], []
    for tag, path, options in (
            ("A", full_dir, AdapterOptions(estimate_readout=True, estimate_cam_time_offset=True)),
            ("B", gs_dir, AdapterOptions())):
        t_s = {}
        p, a = adapter_build(dev, path, t_s, options)
        times.update({f"{tag} {k}": t_s[k] for k in ("load", "adapter")})
        problems.append(p)
        adapters.append(a)
    ids_a, ids_b = (landmark_ids(a) for a in adapters)
    if (len(ids_a), len(ids_b)) != tuple(p.variables.points.shape[0] for p in problems):
        raise AssertionError("multi: landmark ids do not match the adapters' landmark rows")
    common, rows_a, rows_b = np.intersect1d(ids_a, ids_b, return_indices=True)
    matches = [(0, int(i), 1, int(j)) for i, j in zip(rows_a, rows_b)]
    t0 = time.time()
    pre = ms.merge_sessions(problems, point_matches=matches)
    times["merge"] = time.time() - t0
    bm, n_key = base_map(session, adapters[0], ids_a, pre.point_map, dev)
    t0 = time.time()
    merged = ms.merge_sessions(problems, point_matches=matches, extra_batches=[bm])
    times["merge with the base map"] = time.time() - t0
    del pre, problems
    problem = merged.problem
    v = problem.variables
    t0 = time.time()
    ks = problem._build()
    torch.cuda.synchronize()
    times["blocking"] = time.time() - t0
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    if L != len(ids_a) + len(ids_b) - len(common):
        raise AssertionError(f"multi: L {L} after merging {len(common)} of "
                             f"{len(ids_a)} + {len(ids_b)} landmarks")
    datas, masks = tuple(problem.datas), problem.masks
    lg = ks[0](datas, v, masks, None)
    asm = ks[6](datas, lg, v, masks)
    settings = lm_settings()
    rs = rcs.with_damping(asm, v, masks, settings.damping)
    vis = rcs._vis_batches(problem.active_cfgs, datas, lg)
    small = [c.kind for c in problem.cfgs if c.block_info is None]
    lines = []
    for (b, _), cfg in zip(vis, [c for c in problem.active_cfgs if c.block_info is not None]):
        info = b.info
        lines.append(f"{cfg.kind}: N={int(b.plan.rig_obs.shape[0])} (padded {info.nt * info.ts}) "
                     f"nt={info.nt} rb={info.rb} wb={info.wb} prb2={info.prb2} nhg={info.nhg} "
                     f"rig_k={b.rig_k} kc={0 if b.J_cal is None else b.J_cal.shape[1]} route "
                     f"{route_of(b)}")
    two_pass = not (len(rs.vis) == 1 and not rs.rest_pt.lins and rcs._single_pass(rs.vis[0]))
    by_kind = {}
    for c, cost_f in zip(problem.cfgs, lg.stored_cost):
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + float(cost_f.double().sum())
    phase("multi:problem", f"R={R} L={L} n_c={n_c} | matches {len(matches)} of {len(ids_a)} / "
          f"{len(ids_b)} landmarks | base map {n_key} keyrigs, {bm[1]['point'].shape[0]} "
          f"observations | blocked: " + "; ".join(lines) + f" | {len(small)} small batches "
          f"{small} | PCG route {'two-pass' if two_pass else 'single-pass'} | initial cost "
          f"{float(lg.cost):.6g}, by kind: " + ", ".join(f"{k} {c:.4g}" for k, c in by_kind.items())
          + " | "
          + " ".join(f"{k} {val:.1f} s" for k, val in times.items()))
    if not two_pass or len(vis) != 2:
        raise AssertionError("multi: the PCG does not take the two-pass route over two batches")
    # the PCG loop alone: each calibration-coupled batch's K10 down (with
    # y) and up once a matvec, the fused K9 never
    b_rhs = t_sub(asm.g_r, rcs.w_y(rs, v, engine._chol_solve(rs.H_ll_inv, asm.g_l)))
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    rcs.pcg(rs, v, b_rhs, PCG_ITERATIONS, settings.pcg_tol)
    torch.cuda.synchronize()
    pcg_counts = {k: n for k, n in _kernels.launch_counts().items() if n}
    n_cal = sum(rcs._cal_fast(b) for b, _ in vis)
    phase("multi:pcg", f"launches in one {PCG_ITERATIONS}-iteration PCG: {pcg_counts}")
    want = n_cal * PCG_ITERATIONS
    if (pcg_counts.get("schur_down_cal", 0) != want or pcg_counts.get("schur_up_cal", 0) != want
            or pcg_counts.get("schur_pcg_cal", 0) or pcg_counts.get("schur_pcg", 0)):
        raise AssertionError(f"multi: PCG launches {pcg_counts}, not K10 down and up "
                             f"{n_cal} x {PCG_ITERATIONS} each and no fused matvec")
    # the PCG's device time (the least of two profiled runs)
    runs = [pcg_device(rs, v, b_rhs, settings) for _ in range(2)]
    ms, n_ops, top = min(runs, key=lambda r: r[0])
    phase("multi:pcg", f"one {PCG_ITERATIONS}-iteration PCG {ms:.2f} ms device in {n_ops} ops "
          "(runs " + " ".join(f"{r[0]:.2f}" for r in runs) + ") | top: "
          + ", ".join(f"{k[:40]} {us / 1e3:.2f} ms x{n}" for k, n, us in top))
    bench.results.setdefault("multi", {}).update(pcg_device_ms=ms, pcg_device_ops=n_ops)
    gen = torch.Generator(device=dev).manual_seed(0)
    zl = torch.randn((L, 3), generator=gen, device=dev)
    for b, _ in vis:
        if rcs._cal_fast(b):
            x = torch.randn((R, b.rig_k), generator=gen, device=dev)
            xc = torch.randn((n_c, b.J_cal.shape[1]), generator=gen, device=dev)
            k10_rows(bench, b, x, xc, zl, f"(multi,k={b.rig_k})")
    del lg, asm, rs, vis, b_rhs
    consistency("multi", problem, settings, TOL_ITER)
    phase_times("multi", problem, settings)
    launches = run_main("multi", problem, settings, path_kernels("multi"))
    peak_memory("multi", "the phase (builds, merge, blocking, kernel checks, consistency, "
                "phases, main)")
    return launches


# ---------------------------------------------------------------------------
# preprocessing tool on the host: tools.save_observations at the full size
# ---------------------------------------------------------------------------


def tools_start(full_dir, tmp):
    """A tracks CSV (point_id, capture_timestamp_ns, camera_index, x, y) cut
    from the full-sensor directory's session_observations.csv, then
    `python -m ...tools.save_observations` on it with the closed-loop
    trajectory, started in the background; returns (process, tracks rows,
    seconds to cut them, output directory)."""
    import pathlib

    t0 = time.time()
    n = 0
    with open(f"{full_dir}/session_observations.csv") as f, open(f"{tmp}/tracks.csv", "w") as g:
        f.readline()
        g.write("point_id,capture_timestamp_ns,camera_index,x,y\n")
        for line in f:
            g.write(",".join(line.split(",", 5)[:5]) + "\n")
            n += 1
    cut_sec = time.time() - t0
    info = json.load(open(f"{full_dir}/vrs_source_info.json"))
    out = f"{tmp}/prep"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.tools.save_observations",
         "--trajectory", f"{full_dir}/closed_loop_framerate_trajectory.csv",
         "--tracks-csv", f"{tmp}/tracks.csv", "--output", out,
         "--camera-ids", ",".join(info["camera_ids"]), "--imu-ids", ",".join(info["imu_ids"])],
        cwd=str(pathlib.Path(__file__).resolve().parent), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, n, cut_sec, out


def tools_finish(full_dir, started):
    """Waits for the tool, prints its stage lines and the rows kept, then
    load_session of its directory (with the calibration and IMU files a
    VRS's process_vrs gives, copied from the session): the observations
    load, each kept track has >= 3 of them on keyframe times, and their
    times come back 1000x too small (the tool writes microseconds under
    the _ns header, as the reference's does; ROADMAP C)."""
    import shutil

    import numpy as np

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as sio

    proc, n_tracks, cut_sec, out = started
    r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    stdout, _ = proc.communicate(timeout=900)
    r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = r1.ru_utime + r1.ru_stime - r0.ru_utime - r0.ru_stime
    for ln in stdout.splitlines():
        phase("tools", ln)
    if proc.returncode != 0:
        raise AssertionError(f"tools: save_observations exit code {proc.returncode}")
    for fn in ("factory_calibration.json", "online_calibration.jsonl"):
        shutil.copy(f"{full_dir}/{fn}", f"{out}/{fn}")
    info = json.load(open(f"{out}/vrs_source_info.json"))
    for label in info["imu_ids"]:
        shutil.copy(f"{full_dir}/imu_samples_{label}.csv", f"{out}/imu_samples_{label}.csv")
    t0 = time.time()
    sd = sio.load_session(out)
    load_sec = time.time() - t0
    n_kept = len(sd.obs_point_id)
    _, counts = np.unique(sd.obs_point_id, return_counts=True)
    on_frames = np.isin(sd.obs_timestamp_us * 1000, sd.traj_timestamp_us)
    as_read = np.isin(sd.obs_timestamp_us[sd.obs_timestamp_us > 0], sd.traj_timestamp_us)
    phase("tools", f"tracks CSV {n_tracks} rows cut in {cut_sec:.1f} s; save_observations "
          f"{cpu:.1f} s of CPU (in the background of the multi path); kept {n_kept} observations "
          f"({n_kept / n_tracks:.3f}), {len(counts)} tracks; load_session of its directory "
          f"{load_sec:.1f} s: {int(on_frames.sum())} observations on a trajectory frame at 1000x "
          f"their loaded time, {int(as_read.sum())} as loaded (after t = 0)")
    if not (0 < n_kept < n_tracks and counts.min() >= 3 and on_frames.all()):
        raise AssertionError(f"tools: {n_kept} of {n_tracks} rows kept, shortest track "
                             f"{counts.min()}, {int((~on_frames).sum())} off the frames")


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
    (the rig grid at k 6, the point-sorted grid at k 3), K14a and K14b
    against their library calls (in turns), then the profile path: the launch counts
    set to 0, the Schur matvec composed from the tile kernels held against
    rcs.matvec (and K14a's landmark blocks against K13c's, K14b's slot steps
    against an index_select), the counts read; then each component timed.
    Returns the profile path's launch counts."""
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
    args14c = (b.J, b.w, xt, g.local, g.nt, g.ts, g.rb, g.plan)
    bench.compare("mv_fused", seg.seg_mv_fused, args14c, seg_tol("wu", "part"),
                  [b.J, b.w, xt] + runs_g, (8 * k + 2) * n_rig)
    args14e_p = (tb.J_pt_po, u_pt, p.local, p.nt, p.ts, p.rb, p.plan)
    args14e_g = (b.J, u_rig, g.local, g.nt, g.ts, g.rb, g.plan)
    bench.compare("mv_scatter", seg.seg_mv_scatter, args14e_p, seg_tol("part"),
                  [tb.J_pt_po, u_pt] + runs_p, 12 * n_pt)
    bench.compare("mv_scatter(rig grid)", seg.seg_mv_scatter, args14e_g, seg_tol("part"),
                  [b.J, u_rig] + runs_g, 4 * k * n_rig)
    args14d = (tb.J_pt_po, zt, p.local, p.nt, p.ts, p.rb)
    bench.compare("mv_gather", seg.seg_mv_gather, args14d, seg_tol("u"),
                  [tb.J_pt_po, zt, p.local], 12 * n_pt)
    bench.compare("mv_gather(rig grid)", seg.seg_mv_gather, (b.J, xt, g.local, g.nt, g.ts, g.rb),
                  seg_tol("u"), [b.J, xt, g.local], 4 * k * n_rig)
    args14a, lib14a = (A, p.local, p.nt, p.ts, p.rb, p.plan), \
        lambda: part_lib.zero_().index_add_(0, key, A.T)
    args14b, lib14b = (zt, p.local, p.nt, p.ts, p.rb), \
        lambda: zt.reshape(-1, 3).index_select(0, key)
    bench.compare("reduce_partials", seg.seg_reduce_partials, args14a, seg_tol("part"),
                  [A] + runs_p, 9 * n_pt, library=lib14a)
    bench.compare("gather_from_tiles", seg.seg_gather_from_tiles, args14b, seg_tol("rows"),
                  [zt, p.local], 0, library=lib14b)
    # K14a and K14b against their library calls by device time, in turns
    for name, fn, args, lib in (("reduce_partials", seg.seg_reduce_partials, args14a, lib14a),
                                ("gather_from_tiles", seg.seg_gather_from_tiles, args14b,
                                 lib14b)):
        (d_k, _, _), (d_l, o_l, k_l) = in_turns([lambda: fn(*args), lib])
        bench.results[name].update(device_ms_in_turns=d_k, library_device_ms=d_l,
                                   library_device_ops=o_l, library_device_kernels=k_l)
        phase("kernels", f"{name}: device {d_k:.4f} ms vs its library call {d_l:.4f} ms in "
              f"{o_l:g} ops, in turns (" + ", ".join(
                  f"{key[:40]} {ms:.4f}" for key, ms in k_l.items()) + ")")
    # K14a-e: bit-equal across two calls
    for name, fn, args in (("reduce_partials", seg.seg_reduce_partials, args14a),
                           ("gather_from_tiles", seg.seg_gather_from_tiles, args14b),
                           ("mv_fused", seg.seg_mv_fused, args14c),
                           ("mv_gather", seg.seg_mv_gather, args14d),
                           ("mv_scatter", seg.seg_mv_scatter, args14e_p),
                           ("mv_scatter(rig grid)", seg.seg_mv_scatter, args14e_g)):
        if not all(torch.equal(o1, o2) for o1, o2 in zip(flat(fn(*args)), flat(fn(*args)))):
            raise AssertionError(f"{name}: two calls on the same inputs differ")
    # the redesigned K14a and K14c: one device operation each
    for name in ("reduce_partials", "mv_fused"):
        if bench.results[name]["device_ops"] > 1:
            raise AssertionError(f"{name}: {bench.results[name]['device_ops']} device "
                                 "operations per call")

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


# ---------------------------------------------------------------------------
# cov: covariance columns (problem/covariance.py) through the column K4 / K9
# ---------------------------------------------------------------------------

COV_PCG_ITERATIONS = 400  # the CLI's --covariance-pcg-iterations default
COV_CHUNK = 256  # covariance.solve_columns' chunk
# column counts the column kernels are compared at: one column, a tile of
# 8 columns, cov:full's chunk, the chunk
COV_COLS = (1, 8, 48, COV_CHUNK)
# float32 covariance blocks against the same call in float64 through the
# plain versions, relative to each block's largest entry, by path and block
# kind: ~10x PR 13's first measurements on an H100 (bias: rig 6.4e-8,
# calibration 3.0e-5; full: rig 2.8e-7, calibration 1.3e-2, its 23-dim
# IMU-calibration block unconverged after 400 iterations in either type)
COV_BOUNDS = {"bias": {"rig": 1e-6, "cal": 3e-4}, "full": {"rig": 3e-6, "cal": 0.15}}
COV_TURN_ITERATIONS = 5  # PCG iterations of the in-turns timing of one chunk
# the golden sessions' covariance runs (2 LM iterations, as
# tests/test_cli.py::test_cli_compute_covariances runs it, and 150 PCG
# iterations), and the float32 run's blocks against a float64 run on the
# card (relative to each block's largest entry; the two runs' LM steps end
# at different points within float32's noise): ~10x PR 13's first
# measurements (rig 1.9e-3 / 2.0e-4, calibration 2.4e-3 / 4.4e-3)
COV_CLI_ARGS = ["--max-num-iterations", "2", "--compute-covariances",
                "--covariance-pcg-iterations", "150"]
COV_CLI_BOUNDS = {"rig": 2e-2, "cal": 5e-2}
# the damping of the covariance systems (rig_covariances' and
# calib_covariances' default, the CLI's)
COV_LAM = 1e-9
# the same blocks over the dimensions the problem observes
# (observed_errors: each entry's error relative to sqrt(var_i var_j), and
# |std / std64 - 1|), by path and block kind: ~10x the first readings on an
# H100 (cov:bias rigs 6.98e-3 / 3.49e-3, calibration 5.75e-5 / 1.51e-5;
# cov:full rig 1.82e-3 / 9.12e-4, calibration 4.10e-2 / 2.07e-2), where a
# float32 solve through the plain versions errs as much (COV_PLAIN_RATIO)
COV_OBS_BOUNDS = {"bias": {"rig": {"corr": 7e-2, "std": 3.5e-2},
                           "cal": {"corr": 6e-4, "std": 1.5e-4}},
                  "full": {"rig": {"corr": 2e-2, "std": 1e-2},
                           "cal": {"corr": 0.4, "std": 0.2}}}
# cli:golden's float32 run against its float64 run over the observed
# dimensions, by session: ~10x the first readings on an H100
# (golden_session rig 0.115 / 0.056, calibration 2.9e-3 / 1.4e-3;
# golden_session_full rig 2.4e-2 / 1.2e-2, calibration 1.1e-2 / 5.5e-3):
# the two runs' 2 LM iterations end at points float32's noise apart, so
# their rig entries differ by tenths of sqrt(var_i var_j) on golden_session
COV_CLI_OBS_BOUNDS = {"golden_session": {"rig": {"corr": 1.2, "std": 0.6},
                                         "cal": {"corr": 3e-2, "std": 1.5e-2}},
                      "golden_session_full": {"rig": {"corr": 0.25, "std": 0.12},
                                              "cal": {"corr": 0.12, "std": 6e-2}}}
# the kernels' observed-dimension errors at most this multiple of a float32
# solve's through the plain versions on the same columns (cov:bias's rigs
# and calibration rows; cov:full's calibration row: with its rig the solve
# took 74 s on an H100, where the rig read 1.00x)
COV_PLAIN_RATIO = 3.0
# cov:bias holds the kernels to COV_PLAIN_RATIO over float32's own spread
# (cov_probe.median_check): on the problem and COV_COPIES - 1 copies whose
# states are moved by about an ulp, each against its own float64 solve, the
# median of the kernels' median observed errors (entries, std ratios)
# against the median of the plain float32 solves'. The worst entry of one
# draw against another (the check before) read 0.18x to 6.1x with the
# kernels unchanged on an H100 (cov_probe.py): it is one entry of the
# weakest dimension, where float32's error concentrates.
COV_COPIES = 3


def cov_kernel_rows(bench, path, problem, dev):
    """The column K4 (rig-only batch) or K9 (calibration-coupled batch) of
    the problem's blocked batch over its point-sorted records (made once;
    their size printed beside the longest rig row, pair and landmark)
    against its float64 plain version at 1, 8, 48 and 256 columns (rows
    `<kernel>(C=<C>)`, the 256-column one also as `<kernel>`), each column
    also held against the single-column kernel (bit-equal columns counted);
    device time and operations a call (torch.profiler), event time, share
    of the bound, time a column. Its operations a call must not grow with
    C."""
    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs

    v, masks, datas = problem.variables, problem.masks, tuple(problem.datas)
    ks = problem._build()
    lg = ks[0](datas, v, masks, None)
    rs = rcs.with_damping(ks[6](datas, lg, v, masks), v, masks, 1e-4)
    (b, _), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    k, n_real = b.rig_k, int(b.plan.rig_obs.shape[0])
    R, n_c = v.pose_q.shape[0], v.cam_intr.shape[0]
    cal = rcs._cal_fast(b)
    rec = seg.point_sorted_records(b.J, b.J_pt, b.w, b.plan, b.J_cal if cal else None,
                                   b.cplan if cal else None)
    name = "schur_pcg_cal_cols" if cal else "schur_pcg_cols"

    def longest(ptr):
        d = np.diff(ptr.cpu().numpy())
        return f"{d.max()} (mean {d.mean():.0f})"

    rec_mb = nbytes(rec.rec, rec.rig_pos) / 1e6
    phase("kernels", f"{name} [{path}]: point-sorted records {rec_mb:.1f} MB ({n_real} slots x "
          f"{rec.rec.shape[1]} floats + rig-side order); longest rig row {longest(b.plan.rig_ptr)}, "
          + (f"(rig, window row) pair {longest(b.cplan.pair_ptr)}, " if cal else "")
          + f"landmark {longest(b.plan.pt_ptr)} slots")
    gen = torch.Generator(device=dev).manual_seed(1)
    index = [b.plan.rig_ptr, b.plan.pt_ptr, rec.rig_pos]
    ops = {}
    for C in COV_COLS:
        x = torch.randn((R, k, C), generator=gen, device=dev)
        if cal:
            kc, cp = b.J_cal.shape[1], b.cplan
            xc = torch.randn((n_c, kc, C), generator=gen, device=dev)
            args = (b.J, b.J_cal, b.J_pt, b.w, x, xc, rs.H_ll_inv, b.plan, cp)
            fn, single = seg.seg_schur_pcg_cal_cols, seg.seg_schur_pcg_cal
            cols = (4, 5)
            read = [b.J, b.J_cal, b.J_pt, b.w, x, xc, rs.H_ll_inv] + index + [
                cp.rig_pair, cp.pair_ptr, cp.pair_part, cp.win_pair]
            labels, flops = ("y_r", "y_c"), (8 * k + 8 * kc + 24) * n_real * C
        else:
            args = (b.J, b.J_pt, b.w, x, rs.H_ll_inv, b.plan)
            fn, single = seg.seg_schur_pcg_cols, seg.seg_schur_pcg
            cols = (3,)
            read = [b.J, b.J_pt, b.w, x, rs.H_ll_inv] + index
            labels, flops = ("y",), (8 * k + 30) * n_real * C

        def fused(*a):
            return fn(*a, rec=rec)

        row = bench.compare(f"{name}(C={C})", fused, args, [(lb, TOL_SEG) for lb in labels],
                            read, flops)
        out = flat(fused(*args))
        same, worst = 0, 0.0
        for c in range(C):
            col = [a[..., c].contiguous() if i in cols else a for i, a in enumerate(args)]
            ones = flat(single(*col))
            same += all(torch.equal(o[..., c], o1) for o, o1 in zip(out, ones))
            worst = max([worst] + [rel_err(o[..., c], o1)[0] for o, o1 in zip(out, ones)])
        dev_f, ops_f = row["device_ms"], row["device_ops"]
        row.update(columns=C, bit_equal_columns=same, rel_vs_single=worst,
                   bound_share=row["bound_ms"] / dev_f, ms_per_column=dev_f / C,
                   records_mb=rec_mb)
        phase("kernels", f"{name}(C={C}) [{path}]: {dev_f:.4f} ms device in {ops_f:g} ops "
              f"(events {row['ms']:.4f} ms); {dev_f / C:.4f} ms device a column; "
              f"{row['bound_share']:.3f} of the bound {row['bound_ms']:.4f} ms; {same} of {C} "
              f"columns bit-equal to the single-column kernel (worst rel {worst:.2e})")
        if not worst <= TOL_SEG:
            raise AssertionError(f"{name}(C={C}): columns differ from the single-column kernel "
                                 f"by {worst:.2e}")
        ops[C] = ops_f
        if C == COV_CHUNK:
            bench.results[name] = dict(row)
    phase("kernels", f"{name} [{path}]: device operations a call at C = "
          + ", ".join(f"{C}: {n:g}" for C, n in ops.items()))
    if len(set(ops.values())) != 1:
        raise AssertionError(f"{name}: device operations a call grow with the columns: {ops}")
    del lg, rs, b, rec


def cov_blocks_check(tag, blocks):
    """Every block finite, symmetric and positive definite."""
    import numpy as np

    for key, B in blocks.items():
        if B.size == 0:
            continue
        if not np.isfinite(B).all():
            raise AssertionError(f"{tag}: block {key} not finite")
        if not np.array_equal(B, B.T):
            raise AssertionError(f"{tag}: block {key} not symmetric")
        ev = np.linalg.eigvalsh(B)
        if not ev.min() > 0:
            raise AssertionError(f"{tag}: block {key} eigenvalues down to {ev.min():.3e}")


def observed_by_kind(got, want, lam):
    """observed_errors of each block, and the worst entry error and std
    ratio of each kind of block: ({key: (dims, corr, std)}, {kind: (corr,
    std)})."""
    each = {key: observed_errors(got[key], W, lam) for key, W in want.items()
            if W.size and key in got}
    worst = {}
    for (kind, _), (_, corr, std) in each.items():
        c0, s0 = worst.get(kind, (0.0, 0.0))
        worst[kind] = (max(c0, corr), max(s0, std))
    return each, worst


def cov_compare(tag, got, want, bounds, lam=None, obs_bounds=None, plain=None, spread=None):
    """The worst block error (relative to the block's largest entry) and the
    worst standard-deviation ratio |std / std64 - 1| of blocks against
    their float64 counterparts; each kind of block ("rig", "cal": the keys'
    first entries) within its bound. With the system's damping `lam`, the
    same over the dimensions the problem observes (observed_errors: a
    dimension no factor reaches sits at 1/lam and sets the largest entry),
    each kind within `obs_bounds` (entry error "corr", std ratio "std");
    with `plain`, the same blocks from a float32 solve through the plain
    versions, whose observed errors bound the kernels' within
    COV_PLAIN_RATIO. With `spread` (the kernels' and the plain float32
    solves' cov_probe.observed_reading on each copy of the problem, copy 0
    the blocks `got` and `plain`: cov_probe.copy_readings), that bound is
    cov_probe.median_check's over the copies instead of the single draw's."""
    import numpy as np

    from visual_inertial_bundle_adjustment_tpu_torch import cov_probe

    if lam is not None:
        each, worst = observed_by_kind(got, want, lam)
        phase(tag, f"over the observed dimensions (variance < 1/(2 lam), lam {lam:g}): "
              "dimensions, entry error relative to sqrt(var_i var_j), std ratio: "
              + ", ".join("{} {} {}, {:.2e}, {:.2e}".format(*key, *e) for key, e in each.items()))
        if plain is not None:
            each32, worst32 = observed_by_kind(plain, want, lam)
            phase(tag, "a float32 solve through the plain versions, the same: " + ", ".join(
                "{} {} {}, {:.2e}, {:.2e}".format(*key, *e) for key, e in each32.items()))
        for kind, (corr, std) in worst.items():
            b = obs_bounds[kind]
            phase(tag, f"{kind}: worst over the observed dimensions {corr:.3e} of {b['corr']:g} "
                  f"(entries), {std:.3e} of {b['std']:g} (std ratio)"
                  + (f"; float32 plain {worst32[kind][0]:.3e} / {worst32[kind][1]:.3e}, the "
                     f"kernels at {corr / max(worst32[kind][0], 1e-300):.2f}x / "
                     f"{std / max(worst32[kind][1], 1e-300):.2f}x of it "
                     + (f"(at most {COV_PLAIN_RATIO:g}x)" if spread is None else
                        "(one draw: the check takes the medians over the copies)")
                     if plain is not None and kind in worst32 else ""))
            if not (corr <= b["corr"] and std <= b["std"]):
                raise AssertionError(f"{tag}: {kind} blocks off the float64 run over the observed "
                                     f"dimensions: entries {corr:.3e}, std ratio {std:.3e}")
            if plain is not None and spread is None and kind in worst32 and not (
                    corr <= COV_PLAIN_RATIO * worst32[kind][0]
                    and std <= COV_PLAIN_RATIO * worst32[kind][1]):
                raise AssertionError(f"{tag}: {kind} blocks err beyond {COV_PLAIN_RATIO:g}x a "
                                     f"float32 plain solve: {corr:.3e} / {std:.3e} against "
                                     f"{worst32[kind][0]:.3e} / {worst32[kind][1]:.3e}")
        if spread is not None:
            kern, plain_reads = spread
            for c, (k, q) in enumerate(zip(kern, plain_reads)):
                phase(tag, f"copy {c}: kernels / float32 plain over the observed dimensions, "
                      "median, 90th percentile and worst of the entry errors, of the std "
                      "ratios: " + "; ".join(f"{kind} " + ", ".join(
                          f"{k[kind][m]:.3e} / {q[kind][m]:.3e}"
                          for m in ("corr_med", "corr_p90", "corr", "std_med", "std_p90", "std"))
                          for kind in k))
            stat, fail = cov_probe.median_check(kern, plain_reads, COV_PLAIN_RATIO)
            phase(tag, f"medians over {len(kern)} copies, kernels / float32 plain (at most "
                  f"{COV_PLAIN_RATIO:g}x for {' and '.join(cov_probe.CHECKED)}; the 90th "
                  "percentiles and the worst entry read beside): " + "; ".join(
                      f"{kind} {m} {k:.3e} / {q:.3e} = {x:.2f}x" for kind, d in stat.items()
                      for m, (k, q, x) in d.items()))
            if fail:
                raise AssertionError(f"{tag}: the kernels err beyond {COV_PLAIN_RATIO:g}x float32's "
                                     f"own spread: {fail}")

    errs, ratios, keys = [], [], [key for key, W in want.items() if W.size]
    for key in keys:
        G, W = got[key], want[key]
        errs.append(float(np.abs(G - W).max() / np.abs(W).max()))
        ratios.append(float(np.abs(np.sqrt(np.diag(G)) / np.sqrt(np.diag(W)) - 1.0).max()))
    worst, ratio = max(errs), max(ratios)
    by_kind = {}
    for (kind, _), e in zip(keys, errs):
        by_kind[kind] = max(by_kind.get(kind, 0.0), e)
    phase(tag, "block errors (relative to the block's largest entry) and std ratios: "
          + ", ".join(f"{kind} {i} {e:.2e} / {q:.2e}" for (kind, i), e, q in zip(keys, errs,
                                                                                ratios)))
    phase(tag, f"float32 vs float64 on {len(errs)} blocks: worst block error {worst:.3e} ("
          + ", ".join(f"{k} {e:.3e} of {bounds[k]:g}" for k, e in by_kind.items())
          + f"), worst std ratio {ratio:.3e}")
    over = {k: e for k, e in by_kind.items() if not e <= bounds[k]}
    if over:
        raise AssertionError(f"{tag}: covariance blocks off the float64 run beyond their "
                             f"bounds: {over}")
    return worst, ratio


def cov_path(path, problem, dev, bench, rigs, cal_rows, ref_rigs, ref_rows, turn_cols,
             plain_rigs, copies=1):
    """The covariance columns on a problem after its LM run: the column
    kernels' rows, then rig_covariances(rigs) and calib_covariances
    ("imu_calib", cal_rows) at the CLI's 400 PCG iterations with the launch
    counts set to 0 just before and read just after, blocks checked; PCG
    device time an iteration; the float32 blocks of ref_rigs / ref_rows
    against the same calls in float64 through the plain versions (and the
    blocks of plain_rigs and ref_rows through them in float32; with
    `copies` > 1, both float32 solves and the float64 one again on copies -
    1 copies of the problem, cov_compare's spread); one chunk of `turn_cols`
    columns in turns against a loop over its columns through the
    single-column kernel. Returns the launch counts."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch import cov_probe
    from visual_inertial_bundle_adjustment_tpu_torch import profile_matvec as pm
    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.problem import covariance as cov
    from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs
    from visual_inertial_bundle_adjustment_tpu_torch.problem.structure import column

    tag = f"cov:{path}"
    cov_kernel_rows(bench, path, problem, dev)
    torch.cuda.empty_cache()
    kw = dict(pcg_iters=COV_PCG_ITERATIONS)
    cal_dims = int(problem.masks.imu_calib[cal_rows].sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.time()
    blocks = cov.rig_covariances(problem, rigs, **kw)
    torch.cuda.synchronize()
    t_rig = time.time() - t0
    t0 = time.time()
    cal = cov.calib_covariances(problem, "imu_calib", cal_rows, **kw)
    torch.cuda.synchronize()
    t_cal = time.time() - t0
    launches = _kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for name, n, cols, t in (("rig_covariances", len(rigs), 12 * len(rigs), t_rig),
                             ("calib_covariances", len(cal_rows), cal_dims, t_cal)):
        chunks = -(-cols // COV_CHUNK)
        phase(tag, f"{name}: {n} rows, {cols} columns in {chunks} chunks of up to "
              f"{min(cols, COV_CHUNK)} (C), {COV_PCG_ITERATIONS} PCG iterations: {t:.2f} s, "
              f"{cols / t:.1f} columns/s")
    phase(tag, f"launches { {k: n for k, n in launches.items() if n} }")
    cov_blocks_check(tag, blocks)
    cov_blocks_check(tag, {r: B for r, (B, _) in cal.items()})

    # PCG device time an iteration on one chunk (torch.profiler)
    entries = [("rig", int(r), d) for r in rigs for d in range(12)][:COV_CHUNK]
    with cov.with_gauge_prior(problem):
        lg, rs = cov.prepare_system(problem, 1e-9)
        v = problem.variables
        bc = cov._unit_tangents(v, entries)
        n_it = 10
        rcs.pcg(rs, v, bc, 1, 1e-12)
        torch.cuda.synchronize()
        # the device's activity alone (phase_times says why)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rcs.pcg(rs, v, bc, n_it, 1e-12)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = pm.device_kernels(prof.key_averages())
        busy = sum(us for _, _, us in rows) / 1e3
        top = sorted(rows, key=lambda r: -r[2])[:5]
        # the column kernel's passes (the landmark and rig passes, K9's
        # window sums) and the rest of the iteration (the rest graph's
        # batched products, the PCG's vector work)
        col_ms = sum(us for key, _, us in rows
                     if "pass_cols" in key or "sum_partials" in key) / 1e3
        (b,) = rs.vis
        rec_mb = nbytes(b.rec.rec, b.rec.rig_pos) / 1e6
        phase(tag, f"PCG on {len(entries)} columns: {busy / n_it:.3f} ms device and "
              f"{wall / n_it:.3f} ms wall an iteration (busy share {busy / wall:.2f}): column "
              f"kernel {col_ms / n_it:.3f} ms, the rest {(busy - col_ms) / n_it:.3f} ms | top: "
              + ", ".join(f"{key[:40]} {us / 1e3 / n_it:.3f} ms x{n / n_it:g}"
                          for key, n, us in top))
        phase(tag, f"peak device memory over the covariance runs {peak:.2f} GB, of it the "
              f"point-sorted records {rec_mb:.1f} MB")

        # one chunk in turns: the column kernels vs a loop over its columns
        # through the single-column kernel, COV_TURN_ITERATIONS iterations each
        bt = cov._unit_tangents(v, [("rig", int(r), d) for r in rigs
                                    for d in range(12)][:turn_cols])

        def cols_run():
            rcs.pcg(rs, v, bt, COV_TURN_ITERATIONS, 1e-12)

        def loop_run():
            for c in range(turn_cols):
                rcs.pcg(rs, v, column(bt, c), COV_TURN_ITERATIONS, 1e-12)

        times = {"columns": [], "loop": []}
        for key, fn in (("columns", cols_run), ("loop", loop_run), ("loop", loop_run),
                        ("columns", cols_run)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
        rate = {key: turn_cols / statistics.mean(ts) for key, ts in times.items()}
        phase(tag, f"one chunk of {turn_cols} columns at {COV_TURN_ITERATIONS} PCG iterations, "
              f"in turns: column kernels {rate['columns']:.1f} columns/s ("
              + " ".join(f"{x:.3f}" for x in times["columns"]) + " s), single-column loop "
              f"{rate['loop']:.1f} columns/s (" + " ".join(f"{x:.3f}" for x in times["loop"])
              + f" s): {rate['columns'] / rate['loop']:.1f}x")
        del lg, rs, bc, bt, b
    torch.cuda.empty_cache()

    # the subset through the plain versions, in float64 (the reference) and
    # in float32 (what float32 alone gives at these iterations)
    p64 = cov_probe.problem_f64(problem)
    t0 = time.time()
    want = cov_probe.cov_blocks(p64, ref_rigs, ref_rows, COV_LAM, COV_PCG_ITERATIONS, plain=True)
    t64 = time.time() - t0
    del p64
    torch.cuda.empty_cache()
    t0 = time.time()
    plain32 = cov_probe.cov_blocks(problem, plain_rigs, ref_rows, COV_LAM, COV_PCG_ITERATIONS,
                                   plain=True)
    phase(tag, f"plain references on rigs {ref_rigs} and calibration rows {ref_rows}: float64 in "
          f"{t64:.1f} s; float32 on rigs {plain_rigs} and those rows in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    got = {("rig", r): blocks[r] for r in ref_rigs}
    got.update({("cal", r): cal[r][0] for r in ref_rows})
    spread = None
    if copies > 1:
        # float32's own spread: the kernels and the plain versions again on
        # copies whose states are moved by about an ulp, each against its
        # own float64 solve (the problem itself is copy 0)
        def log(c, secs, moved):
            if c:
                phase(tag, f"copy {c} (the state moved by a relative {cov_probe.COPY_REL:g}): "
                      + ", ".join(f"{k} {s:.1f} s" for k, s in secs.items())
                      + f"; its float64 blocks {moved:.2e} off copy 0's (of each block's "
                      "largest entry)")

        spread = cov_probe.copy_readings(problem, ref_rigs, ref_rows, copies, COV_PCG_ITERATIONS,
                                         first=(got, plain32, want), log=log)
        torch.cuda.empty_cache()
    worst, ratio = cov_compare(tag, got, want, COV_BOUNDS[path], lam=COV_LAM,
                               obs_bounds=COV_OBS_BOUNDS[path], plain=plain32, spread=spread)
    bench.results.setdefault("cov", {})[path] = dict(
        rig_seconds=t_rig, rig_columns=12 * len(rigs), cal_seconds=t_cal, cal_columns=cal_dims,
        worst_block_error=worst, worst_std_ratio=ratio, turn_columns_per_s=rate,
        pcg_iteration_device_ms=busy / n_it, pcg_iteration_column_kernel_ms=col_ms / n_it,
        peak_gb=peak, records_mb=rec_mb)
    return launches


# ---------------------------------------------------------------------------
# cli: the command-line entry point on the golden sessions and the full session
# ---------------------------------------------------------------------------

GOLDEN = "tests/data"
# (golden_session bound of tests/test_golden_session.py, float32 bound) of
# each error against the expected outputs (written by the float64 CPU run).
# A float32 run converges to another point within float32's noise; its
# bounds are ~10x the errors of the first float32 run on an H100, which
# missed the float64 bounds of position, 1-|q.q|, accel bias, the time
# offsets, readout and projection parameters (PERF.md §4)
GOLDEN_BOUNDS = {
    "position_m": (1e-4, 1e-3),
    "1-|q.q|": (1e-8, 1e-6),
    "gyro_bias": (1e-6, 1e-4),
    "accel_bias": (1e-6, 1e-3),
    "gyro_time_offset_s": (1e-8, 5e-6),
    "projection_params": (1.0, 100.0),  # max |a - e| / (1e-7 + 1e-6 |e|)
    "readout_s": (1e-8, 5e-6),
    "camera_time_offset_s": (1e-8, 5e-6),
}


def run_cli(argv, dev, timings, dtype=None):
    """pipeline.cli.main(argv) on dev with its printed lines captured:
    (exit code, the lines)."""
    import contextlib
    import io

    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, device=dev, dtype=dtype, timings=timings)
    return rc, out.getvalue().splitlines()


def stage_line(timings):
    return ", ".join(f"{k} {sum(v):.3f} s ({len(v)}: " + " ".join(f"{x:.3f}" for x in v) + ")"
                     if isinstance(v, list) else f"{k} {v:.3f} s" for k, v in timings.items())


def golden_errors(base, out):
    """The errors of a CLI run's outputs against a golden session's expected
    ones (tests/test_golden_session.py's quantities, over every record)."""
    import csv

    import numpy as np

    def traj(path):
        rows = list(csv.DictReader(open(path)))
        return (np.asarray([int(r["tracking_timestamp_us"]) for r in rows]),
                np.asarray([[float(r[f"t{a}_world_device"]) for a in "xyz"] for r in rows]),
                np.asarray([[float(r[f"q{a}_world_device"]) for a in "wxyz"] for r in rows]))

    t_e, p_e, q_e = traj(f"{base}/expected/closed_loop_framerate_trajectory.csv")
    t_a, p_a, q_a = traj(f"{out}/closed_loop_framerate_trajectory.csv")
    if not np.array_equal(t_a, t_e):
        raise AssertionError(f"{base}: trajectory timestamps differ")
    err = {"position_m": float(np.linalg.norm(p_a - p_e, axis=-1).max()),
           "1-|q.q|": float((1.0 - np.abs((q_a * q_e).sum(-1))).max())}
    exp = [json.loads(ln) for ln in open(f"{base}/expected/online_calibration.jsonl")]
    act = [json.loads(ln) for ln in open(f"{out}/online_calibration.jsonl")]
    if len(exp) != len(act):
        raise AssertionError(f"{base}: {len(act)} calibration records, expected {len(exp)}")

    def worst(key, pairs):
        err[key] = max([err.get(key, 0.0)] + [float(np.abs(np.asarray(a, float)
                                                           - np.asarray(e, float)).max())
                                              for a, e in pairs])

    for e, a in zip(exp, act):
        imus = list(zip(a["ImuCalibrations"], e["ImuCalibrations"]))
        cams = list(zip(a["CameraCalibrations"], e["CameraCalibrations"]))
        worst("gyro_bias", [(ai["Gyroscope"]["Bias"]["Offset"], ei["Gyroscope"]["Bias"]["Offset"])
                            for ai, ei in imus])
        worst("accel_bias", [(ai["Accelerometer"]["Bias"]["Offset"],
                              ei["Accelerometer"]["Bias"]["Offset"]) for ai, ei in imus])
        worst("gyro_time_offset_s", [(ai.get("TimeOffsetSec_Device_Gyro", 0.0),
                                      ei.get("TimeOffsetSec_Device_Gyro", 0.0))
                                     for ai, ei in imus])
        for key, field in (("readout_s", "ReadoutTimeSec"),
                           ("camera_time_offset_s", "TimeOffsetSec_Device_Camera")):
            worst(key, [(ac.get(field, 0.0), ec.get(field, 0.0)) for ac, ec in cams])
        for ac, ec in cams:
            pa = np.asarray(ac["Projection"]["Params"], float)
            pe = np.asarray(ec["Projection"]["Params"], float)
            err["projection_params"] = max(err.get("projection_params", 0.0), float(
                (np.abs(pa - pe) / (1e-7 + 1e-6 * np.abs(pe))).max()))
    return err


def cli_golden(dev, smi):
    """pipeline.cli.main on the card (float32) on the two committed golden
    sessions with their flags, against their expected outputs: each error
    within the golden test's bound, or where float32 misses it, within the
    float32 bound (GOLDEN_BOUNDS)."""
    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels

    for name, flags in (("golden_session", CLI_ARGS), ("golden_session_full", CLI_ARGS_FULL)):
        base = f"{GOLDEN}/{name}"
        with tempfile.TemporaryDirectory() as out:
            timings = {}
            _kernels.reset_launch_counts()
            rc, lines = run_cli(["-i", f"{base}/input", "-o", out, *flags], dev, timings)
            launches = {k: n for k, n in _kernels.launch_counts().items() if n}
            if rc != 0:
                raise AssertionError(f"cli:golden {name}: exit code {rc}")
            err = golden_errors(base, out)
        summary = next(ln for ln in lines if ln.startswith("optimize:"))
        phase("cli:golden", f"{name}: {summary} | {stage_line(timings)} | launches {launches} "
              f"| {smi}")
        for key, val in err.items():
            bound64, bound32 = GOLDEN_BOUNDS[key]
            held = "the golden bound" if val <= bound64 else f"the float32 bound {bound32:g}"
            phase("cli:golden", f"{name}: {key} {val:.3e} (golden bound {bound64:g}; held to "
                  f"{held})")
            if not val <= bound32:
                raise AssertionError(f"cli:golden {name}: {key} {val:.3e} > {bound32:g}")


def read_covariances(out):
    """A CLI run's covariance files: (timestamps, stds (R, 12), blocks (R, 12,
    12)) of rig_covariances.csv and the records of
    imu_calib_covariances.jsonl."""
    import numpy as np

    lines = open(f"{out}/rig_covariances.csv").read().splitlines()
    rows = np.asarray([[float(x) for x in ln.split(",")] for ln in lines[1:]])
    recs = [json.loads(ln) for ln in open(f"{out}/imu_calib_covariances.jsonl")]
    return rows[:, 0], rows[:, 1:13], rows[:, 13:].reshape(-1, 12, 12), recs, len(lines)


def cli_golden_covariances(dev):
    """The two golden sessions through the CLI with --compute-covariances
    (150 PCG iterations; the sessions are too small to block, so the generic
    engine solves the columns, batched) on the card in float32, and again in
    float64 through the plain versions: one row per rig after the header,
    finite, symmetric blocks with std >= 0, one record per calibration row,
    and the float32 blocks within COV_CLI_BOUNDS of the float64 ones. Rig
    0's block is printed beside, not bounded: the gauge prior pins its
    position and yaw at 1e-4 (1e4 sqrt-information against the others'
    ~1e2), and float32 resolves the rest of that block only to tens of
    percent (0.25 on the CPU)."""
    import contextlib

    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels

    for name, flags in (("golden_session", CLI_ARGS), ("golden_session_full", CLI_ARGS_FULL)):
        base = f"{GOLDEN}/{name}"
        R = sum(1 for _ in open(f"{base}/expected/closed_loop_framerate_trajectory.csv")) - 1
        runs = {}
        for dtype in (torch.float32, torch.float64):
            with tempfile.TemporaryDirectory() as out:
                timings = {}
                plain = (_kernels.plain_reference() if dtype == torch.float64
                         else contextlib.nullcontext())
                with plain:
                    rc, _ = run_cli(["-i", f"{base}/input", "-o", out, *flags, *COV_CLI_ARGS],
                                    dev, timings, dtype)
                if rc != 0:
                    raise AssertionError(f"cli:golden {name} covariances: exit code {rc}")
                runs[dtype] = (*read_covariances(out), timings)
        ts, std, B, recs, n_lines, timings = runs[torch.float32]
        ts64, _, B64, recs64, _, timings64 = runs[torch.float64]
        if n_lines != 1 + R or not np.array_equal(ts, ts64):
            raise AssertionError(f"cli:golden {name}: {n_lines} covariance lines for {R} rigs")
        if not (np.isfinite(std).all() and np.isfinite(B).all() and (std >= 0).all()
                and np.array_equal(B, np.swapaxes(B, 1, 2))):
            raise AssertionError(f"cli:golden {name}: covariance rows not finite, symmetric "
                                 "and std >= 0")
        if not recs or len(recs) != len(recs64):
            raise AssertionError(f"cli:golden {name}: {len(recs)} calibration records, float64 "
                                 f"{len(recs64)}")
        got = {("rig", r): B[r] for r in range(1, R)}
        want = {("rig", r): B64[r] for r in range(1, R)}
        for i, (a, e) in enumerate(zip(recs, recs64)):
            if a["dims"] != e["dims"] or (a["window"], a["imu"]) != (e["window"], e["imu"]):
                raise AssertionError(f"cli:golden {name}: calibration record {i} differs")
            n = len(a["dims"])
            got[("cal", i)] = np.asarray(a["cov"]).reshape(n, n)
            want[("cal", i)] = np.asarray(e["cov"]).reshape(n, n)
        phase("cli:golden", f"{name} covariances: {R} rig blocks ({12 * R} columns), "
              f"{len(recs)} calibration records; covariances stage {timings['covariances']:.2f} s"
              f" float32, {timings64['covariances']:.2f} s float64 (plain); the gauge rig 0's "
              f"block {float(np.abs(B[0] - B64[0]).max() / np.abs(B64[0]).max()):.3e} off the "
              "float64 run (not bounded)")
        cov_compare(f"cli:golden {name}", got, want, COV_CLI_BOUNDS, lam=COV_LAM,
                    obs_bounds=COV_CLI_OBS_BOUNDS[name])


def cli_argv(session_dir, out_dir, tmp):
    """cli:full's command line."""
    return ["-i", session_dir, "-o", out_dir, "--estimate-readout-time",
            "--estimate-time-offset", "--max-num-iterations", str(CLI_FULL_ITERATIONS),
            "--recompute-preint", "--eval-calib-vs-factory", "--simple-stats",
            "--monitor-jsonl", f"{tmp}/monitor.jsonl", "--json-report", f"{tmp}/report.json"]


def cli_refinement_rows(dev, bench, session_dir):
    """K13c at the shapes point refinement gives it on cli:full: the CLI's
    problem (its flags' options, blocked as main blocks it), the per-slot
    tables refine_points sums at the initial landmarks (D 13 in the Jacobian
    pass: cost, gradient, 3x3 block; D 1 in the cost passes) over the
    landmark plan it builds, each against the plain version and index_add_."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import segments as seg
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import cli
    from visual_inertial_bundle_adjustment_tpu_torch.problem import point_refinement as pr

    with tempfile.TemporaryDirectory() as tmp:
        options = cli.make_adapter_options(
            cli.build_arg_parser().parse_args(cli_argv(session_dir, tmp, tmp)))
    problem, _, _ = adapter_problem("cli", dev, session_dir, {}, options)
    b, = pr.point_batches(problem)
    n_real, N = int(b.plan.obs.shape[0]), int(b.plan.row.shape[0])
    for D, with_jac in ((13, True), (1, False)):
        contrib = pr.point_contrib(problem, b, problem.variables.points, with_jac)
        if tuple(contrib.shape) != (D, N):
            raise AssertionError(f"cli: refinement table {tuple(contrib.shape)}, not {(D, N)}")
        # K13c reads the real slots' columns of contrib (by the plan's obs)
        bench.compare(f"reduce_table(cli,D={D})", seg.seg_reduce_table, (contrib, b.plan),
                      [("y", TOL_SEG)], [(contrib, n_real / N), b.plan.ptr, b.plan.obs],
                      D * n_real, library=library_sum(contrib, b.plan))
        del contrib


def cli_full(dev, session_dir, smi):
    """pipeline.cli.main on the full-sensor session directory,
    CLI_FULL_ITERATIONS LM iterations with every report on, the launch counts set to 0 just before
    and read just after; returns the counts."""
    import numpy as np
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels

    traj_ts = np.loadtxt(f"{session_dir}/closed_loop_framerate_trajectory.csv", delimiter=",",
                         skiprows=1, usecols=[1], dtype=np.int64)
    online_ts = [json.loads(ln)["tracking_timestamp_us"]
                 for ln in open(f"{session_dir}/online_calibration.jsonl")]
    R = len(np.intersect1d(traj_ts, online_ts))
    with tempfile.TemporaryDirectory() as tmp:
        argv = cli_argv(session_dir, f"{tmp}/out", tmp)
        timings = {}
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        rc, lines = run_cli(argv, dev, timings)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        if rc != 0:
            raise AssertionError(f"cli:full: exit code {rc}")
        report = json.load(open(f"{tmp}/report.json"))
        counts = {fn: sum(1 for _ in open(f"{tmp}/out/{fn}")) - (fn.endswith(".csv"))
                  for fn in ("closed_loop_framerate_trajectory.csv",
                             "open_loop_framerate_trajectory.csv", "online_calibration.jsonl")}
        finite = all(np.isfinite(np.genfromtxt(f"{tmp}/out/{fn}", delimiter=",",
                                               skip_header=1)[:, 3:]).all()
                     for fn in ("closed_loop_framerate_trajectory.csv",
                                "open_loop_framerate_trajectory.csv"))
        monitor = [json.loads(ln) for ln in open(f"{tmp}/monitor.jsonl")]
    for ln in lines:
        if ln.startswith(("rigs:", "optimize:")) or "proj_offset@1.0m" in ln \
                or ln.startswith(("imu0/gyro_bias", "rs_visual_cam0/px")):
            phase("cli:full", ln)
    phase("cli:full", f"{smi} | {stage_line(timings)}")
    phase("cli:full", f"report {report} | rows {counts} (rigs {R}) | monitor records "
          f"{len(monitor)} | launches { {k: n for k, n in launches.items() if n} }")
    if any(n != R for n in counts.values()) or not finite:
        raise AssertionError(f"cli:full: outputs {counts} (finite {finite}) for {R} rigs")
    if not report["finalCost"] < report["initialCost"]:
        raise AssertionError(f"cli:full: cost did not fall: {report}")
    if len(monitor) != report["numIterations"]:
        raise AssertionError(f"cli:full: {len(monitor)} monitor records for "
                             f"{report['numIterations']} iterations")
    missing = [k for k in path_kernels("cli") if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"cli:full: kernels not launched: {missing}")
    return launches


# ---------------------------------------------------------------------------
# shard path: the tile-sharded blocked engine (parallel/sharding.py)
# ---------------------------------------------------------------------------

SHARD_RANKS = 2  # gloo ranks on the one card (NCCL refuses two ranks on one device)
SHARD_TIMEOUT_S = 420
# the kernels each shard phase must launch on every rank, and the fused PCG
# matvecs it must not (the sharded PCG is two-pass: K6 / K10's down pass,
# the landmark sums completed across the ranks, K5 / K10's up pass)
SHARD_KERNELS = {"cap": ("visual_linearize", "assemble_rig", "precond_rig", "schur_down",
                         "schur_up"),
                 "full": ("rs_linearize", "assemble_cal", "precond_rig", "schur_down_cal",
                          "schur_up_cal"),
                 "nccl": ("visual_linearize", "assemble_rig", "precond_rig", "schur_down",
                          "schur_up")}
SHARD_FUSED = ("schur_pcg", "schur_pcg_cal")
SHARD_LABEL = "2 gloo ranks on one card, not multi-GPU"
# the shard phases the ranks run, in order: (tag, LM iterations after the step)
SHARD_JOBS = (("cap", CAP_TIMED_ITERS), ("full", 0))


def shard_kernel_rows(bench, problem, dev, tag):
    """The kernels of `shard:<tag>` held against their float64 plain
    versions (TOL_SEG) on each rank's plans at the path's shapes: the
    problem (at its initial state) cut here for each of SHARD_RANKS ranks by
    shard_blocked_problem over a Mesh of that rank (the cut needs no process
    group), the rank's batch linearized on its own slots. Rig-only (cap):
    K2, K3, K6 with y and t alone, K5 (rig_segment_rows); calibration-coupled
    (full): K3, K8 and K10's down pass with y and t alone and its up pass
    (k10_rows). A rank's plans keep every global rig and landmark row, and
    many hold no local slot: the rank's empty rows are counted, asserted
    present, and each output is allocated from NaN-filled memory (poison)
    so that a row the kernel does not write fails. Rows
    `<kernel>(<tag>,shard,rank<r>)`; main gives each the launches of its
    kernel on that rank in the shard phase."""
    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.parallel import sharding
    from visual_inertial_bundle_adjustment_tpu_torch.problem import engine, rcs
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import Problem

    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    lg = ks[0](datas, v, masks, None)
    hinv = rcs.with_damping(ks[6](datas, lg, v, masks), v, masks, 1e-4).H_ll_inv
    del lg
    R, L, n_c = v.pose_q.shape[0], v.points.shape[0], v.cam_intr.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    for rank in range(SHARD_RANKS):
        q = Problem(v, masks)
        q.cfgs, q.datas = list(problem.cfgs), list(problem.datas)
        sharding.shard_blocked_problem(q, sharding.Mesh(rank, SHARD_RANKS, dev, "gloo"),
                                       log=[].append)
        cfgs, qdatas = q.resolve_cfgs(), tuple(q.datas)
        (b, lin), = rcs._vis_batches(cfgs, qdatas,
                                     engine.linearize(cfgs, qdatas, q.variables, q.masks))
        n_real = int(b.plan.rig_obs.shape[0])
        empty_r = int((b.plan.rig_ptr[1:] == b.plan.rig_ptr[:-1]).sum())
        empty_l = int((b.plan.pt_ptr[1:] == b.plan.pt_ptr[:-1]).sum())
        phase(f"shard:{tag}", f"rank {rank}'s plans: {b.info.nt} tiles, {n_real} real slots, "
              f"{empty_r} of {R} rig rows and {empty_l} of {L} landmark rows with no local slot")
        if not (empty_r and empty_l):
            raise AssertionError(f"shard:{tag}: rank {rank}'s plans have no empty rig or "
                                 "landmark row")
        inner = f"{tag},shard,rank{rank}"
        x = torch.randn((R, b.rig_k), generator=gen, device=dev)
        zl = torch.randn((L, 3), generator=gen, device=dev)
        if rcs._rig_only_fast(b):
            rig_segment_rows(bench, lambda kernel, mode="": f"{kernel}({inner}"
                             + (f",{mode})" if mode else ")"), b, lin, hinv, x, zl, n_real,
                             poison=True)
        elif rcs._cal_fast(b):
            xc = torch.randn((n_c, b.J_cal.shape[1]), generator=gen, device=dev)
            precond_rig_row(bench, f"precond_rig({inner})", b, hinv, n_real)
            assemble_cal_row(bench, f"assemble_cal({inner})", b, lin, poison=True)
            k10_rows(bench, b, x, xc, zl, f"({inner})", poison=True)
        else:
            raise AssertionError(f"shard:{tag}: rank {rank}'s batch takes no single-pass route")
        del q, b, lin
    torch.cuda.empty_cache()


def problem_spec(problem):
    """A problem as plain data on the host (tables, masks, cfgs, batches;
    the transpose plans `_ell*` left out: each rank builds its own), for
    the file the shard ranks load."""
    from visual_inertial_bundle_adjustment_tpu_torch.problem.structure import tables_to

    def cpu(a):
        return type(a)(*(x.cpu() for x in a)) if isinstance(a, tuple) else a.cpu()

    return dict(variables=tables_to(problem.variables, "cpu"),
                masks=tables_to(problem.masks, "cpu"), cfgs=list(problem.cfgs),
                datas=[{k: cpu(a) for k, a in d.items() if not k.startswith("_ell")}
                       for d in problem.datas])


def spec_problem(spec):
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import Problem

    p = Problem(spec["variables"], spec["masks"])
    p.cfgs, p.datas = list(spec["cfgs"]), list(spec["datas"])
    return p


def step_of(lg, out):
    """One LM attempt's step, model reduction, new cost and PCG iterations,
    on the host."""
    return dict(x_r={f: getattr(out[0], f).cpu() for f in out[0]._fields}, x_l=out[1].cpu(),
                model=float(out[2]), cost=float(out[9].cost), lin_cost=float(lg.cost),
                pcg_iters=int(out[4]))


def shard_file(tag, problem, v0, workdir):
    """The path's problem from its initial state v0 written to
    `<workdir>/<tag>.pt` for the shard ranks (problem_spec); returns the
    single-device step of that state (one_step, through the fused route),
    which theirs are held against, with L and R."""
    import os

    import torch

    problem.variables = v0
    want = dict(step=step_of(*one_step(problem)), L=v0.points.shape[0], R=v0.pose_q.shape[0])
    t0 = time.time()
    path = os.path.join(workdir, f"{tag}.pt")
    torch.save(problem_spec(problem), path)
    phase(f"shard:{tag}", f"problem file {os.path.getsize(path) / 2**20:.0f} MiB written in "
          f"{time.time() - t0:.1f} s")
    return want


def rank_job(workdir, tag, iterations, world):
    """One shard phase on this rank: loads `<tag>.pt`, shard_blocked_problem,
    one LM attempt from the file's state (the launch and collective counts
    set to 0 just before; the first attempt's stages timed), then
    `iterations` LM iterations through optimize() (launch counts set to 0
    just before). Returns the results on the host."""
    import os

    import torch

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.parallel import sharding
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import optimize
    from visual_inertial_bundle_adjustment_tpu_torch.problem.structure import tables_to

    out = {}
    t0 = time.time()
    problem = spec_problem(torch.load(os.path.join(workdir, f"{tag}.pt"), map_location="cpu",
                                      weights_only=False))
    out["load_s"] = time.time() - t0
    mesh = sharding.make_mesh(world, device=torch.device("cuda", 0))
    logs = []
    t0 = time.time()
    sharding.shard_blocked_problem(problem, mesh, log=logs.append)
    torch.cuda.synchronize()
    out["shard_s"] = time.time() - t0
    vis = [(c.block_info, d) for c, d in zip(problem.cfgs, problem.datas)
           if c.block_info is not None]
    out["tiles"] = [i.nt for i, _ in vis]
    out["slots"] = [int((d["_pad"] < 0.5).sum()) for _, d in vis]
    pt = problem.pt_plan
    out["pt_plan"] = None if pt is None else (pt.own_lo.tolist(), pt.halo)
    out["t_plans"] = {g: (q.own_lo.tolist(), q.halo) for g, q in problem.t_plans.items()}
    out["logs"] = logs
    out["resident_gib"] = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    mesh.reset_counts()
    _kernels.reset_launch_counts()
    stages = {}
    t0 = time.time()
    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    lg = ks[0](datas, v, masks, None)
    torch.cuda.synchronize()
    stages["linearize"] = time.time() - t0
    asm = ks[6](datas, lg, v, masks)
    torch.cuda.synchronize()
    stages["assemble"] = time.time() - t0 - stages["linearize"]
    res = ks[7](asm, datas, lg, v, masks, STEP_LAM, PCG_ITERATIONS, STEP_TOL, "gauss_seidel")
    torch.cuda.synchronize()
    stages["solve"] = time.time() - t0 - stages["linearize"] - stages["assemble"]
    out["step_s"] = stages
    out["step_launches"] = _kernels.launch_counts()
    out["step"] = step_of(lg, res)
    out["counts"] = {k: list(c) for k, c in mesh.counts.items()}
    out["main_launches"] = {}
    if iterations:
        iters = []
        settings = lm_settings(iterations)
        settings.iteration_callback = iters.append
        _kernels.reset_launch_counts()
        summary = optimize(problem, settings)
        torch.cuda.synchronize()
        out["main_launches"] = _kernels.launch_counts()
        out["main"] = dict(initial=summary.initial_cost, final=summary.final_cost,
                           iterations=summary.num_iterations,
                           iter_ms=[d["iter_time_sec"] * 1e3 for d in iters],
                           costs=[d["prev_cost"] for d in iters])
        out["v"] = tables_to(problem.variables, "cpu")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def shard_rank(rank, world, workdir, jobs):
    """One gloo rank of the shard path, spawned on card 0: rank_job for each
    (tag, iterations) of `jobs`, in order; writes the results to
    rank<r>.pt."""
    import os

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    try:
        out = {tag: rank_job(workdir, tag, iterations, world) for tag, iterations in jobs}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def start_ranks(workdir, jobs):
    """SHARD_RANKS gloo ranks spawned on card 0 over a FileStore in workdir,
    each loading the problem files written there (none rebuilds a
    problem); returns (the spawn context, its start time)."""
    import torch.multiprocessing as mp

    phase("shard", f"{SHARD_RANKS} gloo ranks on cuda:0 for " + ", ".join(t for t, _ in jobs))
    return mp.start_processes(shard_rank, args=(SHARD_RANKS, workdir, jobs), nprocs=SHARD_RANKS,
                              join=False, start_method="spawn"), time.time()


def finish_ranks(started, workdir):
    """Joins the ranks within SHARD_TIMEOUT_S (stopping them otherwise) and
    returns their results."""
    import os

    import torch

    ctx, t0 = started
    try:
        while not ctx.join(timeout=5):
            if time.time() - t0 > SHARD_TIMEOUT_S:
                raise TimeoutError(f"shard: ranks not done in {SHARD_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(30)
    phase("shard", f"ranks done in {time.time() - t0:.1f} s")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(SHARD_RANKS)]


def step_vs_single(tag, got, want):
    """A sharded LM step against the single-device step from the same state
    (as step_agreement reads it): cosine > STEP_BOUNDS' 0.999, relative step
    difference and new cost within TOL_ITER."""
    import torch

    def flat(s):
        return torch.cat([s["x_r"][f].double().reshape(-1) for f in s["x_r"]]
                         + [s["x_l"].double().reshape(-1)])

    a, b = flat(got), flat(want)
    cos = float(a @ b / (a.norm() * b.norm()))
    rel_step = float((a - b).norm() / b.norm())
    rel_cost = abs(got["cost"] - want["cost"]) / abs(want["cost"])
    rel_model = abs(got["model"] - want["model"]) / abs(want["model"])
    ok = cos > STEP_BOUNDS["cos"] and rel_step <= TOL_ITER and rel_cost <= TOL_ITER
    phase(f"shard:{tag}", f"one LM step (lam {STEP_LAM:g}, {PCG_ITERATIONS} PCG iterations) "
          f"sharded against one device: cosine {cos:.6f} (> {STEP_BOUNDS['cos']}), relative "
          f"step difference {rel_step:.3e} (<= {TOL_ITER:g}), new cost {got['cost']:.8g} vs "
          f"{want['cost']:.8g} (rel {rel_cost:.3e}, <= {TOL_ITER:g}), model reduction rel "
          f"{rel_model:.3e}, linearized cost {got['lin_cost']:.8g} vs {want['lin_cost']:.8g}")
    if not ok:
        raise AssertionError(f"shard:{tag}: the sharded step is off the single-device step")
    return dict(cos=cos, rel_step=rel_step, rel_cost=rel_cost, rel_model=rel_model)


def collective_report(tag, counts, L, R, pcg_iters, smi, planned):
    """Bytes a rank moves per PCG iteration (the halo slabs it sends, the
    all-reduced tensors), against the (L, 3) + (R, 12) all-reduces the halo
    exchanges replace; fails if the loop all-reduces the (L, 3) table while
    the landmark plan is engaged, or the (R, 12) one while the rig plan is
    (`planned`: the point plan, and the table plans by group)."""
    pt_plan, t_plans = planned
    loop = {k: v for k, v in counts.items() if k[0] == "pcg"}
    tables = [k for k in loop if k[1] == "all_reduce" and (
        (pt_plan is not None and k[2] in ((L, 3), (L, 3, 3)))
        or ("rig" in t_plans and len(k[2]) >= 2 and k[2][:2] == (R, 12)))]
    if tables:
        raise AssertionError(f"shard:{tag}: table all-reduces inside the PCG loop: {tables}")
    halo = sum(v[1] for k, v in loop.items() if k[1] == "halo") / pcg_iters
    red = sum(v[1] for k, v in loop.items() if k[1] == "all_reduce") / pcg_iters
    full = (L * 3 + R * 12) * 4
    phase(f"shard:{tag}", f"collectives per PCG iteration, one rank: halo slabs {halo / 1e3:.1f} "
          f"kB sent, all-reduced {red / 1e3:.2f} kB, against {full / 1e3:.1f} kB of the (L, 3) + "
          f"(R, 12) all-reduces they replace | " + ", ".join(
              f"{k[1]} {k[2]} x{v[0] // pcg_iters}" for k, v in sorted(loop.items()))
          + f" | {smi}")
    return dict(halo_bytes_per_iteration=halo, all_reduce_bytes_per_iteration=red,
                replaced_bytes_per_iteration=full)


def check_shard_launches(tag, launches):
    missing = [k for k in SHARD_KERNELS[tag] if launches.get(k, 0) < 1]
    fused = [k for k in SHARD_FUSED if launches.get(k, 0)]
    if missing or fused:
        raise AssertionError(f"shard:{tag}: kernels not launched {missing}, fused PCG "
                             f"matvecs launched {fused}")


def shard_checks(tag, ranks, want, L, R, smi):
    """`shard:<tag>` on the ranks' results (rank_job): each rank's tiles and
    slots and the halo plans (cap: the landmark and rig plans asserted
    engaged; full: the window tables' plans or their logged bail-outs), the
    sharded LM step against the single-device step `want` of the same state
    (step_vs_single), the collectives of its PCG (collective_report), the
    LM iterations through optimize() when run: the cost falls and the ranks
    end with bit-equal variables; every kernel of SHARD_KERNELS launched on
    every rank and neither fused PCG matvec; per-rank peak memory and
    iteration ms. Returns the ranks' launch counts summed, and each rank's."""
    import torch

    r0 = ranks[0]
    phase(f"shard:{tag}", "tiles per rank " + ", ".join(str(r["tiles"]) for r in ranks)
          + ", real slots per rank " + ", ".join(str(r["slots"]) for r in ranks)
          + f" | landmark plan {r0['pt_plan']}, table plans {r0['t_plans']}"
          + (f" | logged: {r0['logs']}" if r0["logs"] else "")
          + " | s per rank: load " + ", ".join(f"{r['load_s']:.1f}" for r in ranks)
          + "; cut " + ", ".join(f"{r['shard_s']:.1f}" for r in ranks)
          + "; the first attempt " + ", ".join(
              " / ".join(f"{k} {t:.1f}" for k, t in r["step_s"].items()) for r in ranks))
    if tag == "cap" and (r0["pt_plan"] is None or "rig" not in r0["t_plans"]):
        raise AssertionError(f"shard:cap: halo plans not engaged: {r0['pt_plan']}, "
                             f"{r0['t_plans']}, {r0['logs']}")
    step_vs_single(tag, r0["step"], want)
    for r in ranks[1:]:
        same = all(torch.equal(r["step"]["x_r"][f], x) for f, x in r0["step"]["x_r"].items())
        if not (same and torch.equal(r["step"]["x_l"], r0["step"]["x_l"])):
            raise AssertionError(f"shard:{tag}: the ranks' steps differ")
    collective_report(tag, r0["counts"], L, R, PCG_ITERATIONS, smi, (r0["pt_plan"], r0["t_plans"]))
    launches, by_rank = {}, []
    for r in ranks:
        per = {k: n + r["main_launches"].get(k, 0) for k, n in r["step_launches"].items()}
        check_shard_launches(tag, per)
        by_rank.append(per)
        for k, n in per.items():
            launches[k] = launches.get(k, 0) + n
    if "main" in r0:
        mains = [r["main"] for r in ranks]
        phase(f"shard:{tag}", f"{mains[0]['iterations']} LM iterations through optimize(): cost "
              f"{mains[0]['initial']:.6g} -> {mains[0]['final']:.6g}; iteration ms per rank "
              + "; ".join(", ".join(f"{t:.0f}" for t in m["iter_ms"]) for m in mains)
              + f" ({SHARD_LABEL})")
        if not all(math.isfinite(c) for c in mains[0]["costs"] + [mains[0]["final"]]):
            raise AssertionError(f"shard:{tag}: non-finite cost")
        if not mains[0]["final"] < mains[0]["initial"]:
            raise AssertionError(f"shard:{tag}: cost did not fall")
        for r in ranks[1:]:
            if not all(torch.equal(a, b) for a, b in zip(r["v"], r0["v"])):
                raise AssertionError(f"shard:{tag}: the ranks' final variables differ")
        phase(f"shard:{tag}", "final variables bit-equal on every rank")
    phase(f"shard:{tag}", "peak device memory per rank over the step and main "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB allocated (resident after "
          "the cut " + ", ".join(f"{r['resident_gib']:.2f}" for r in ranks)
          + f" GiB) | {SHARD_LABEL} | {smi}")
    return launches, by_rank


def shard_nccl(dev, problem, v0, smi):
    """`shard:nccl`: the bias-only problem from its initial state sharded
    over a group of world size 1 on NCCL in this process (FileStore): NCCL
    initialises and its all-reduces run on the card (the halo exchanges
    have no peer), the step takes the sharded two-pass route (K6, K5; no
    K4) and agrees with the single-device fused route within TOL_ITER.
    Returns the launch counts."""
    import os

    import torch
    import torch.distributed as dist

    from visual_inertial_bundle_adjustment_tpu_torch.ops import _kernels
    from visual_inertial_bundle_adjustment_tpu_torch.parallel import sharding
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import Problem

    problem.variables = v0
    want = step_of(*one_step(problem))
    q = Problem(problem.variables, problem.masks)
    q.cfgs, q.datas = list(problem.cfgs), list(problem.datas)
    with tempfile.TemporaryDirectory() as workdir:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(workdir, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = sharding.make_mesh(1, device=dev)
            logs = []
            sharding.shard_blocked_problem(q, mesh, log=logs.append)
            mesh.reset_counts()
            _kernels.reset_launch_counts()
            lg, out = one_step(q)
            torch.cuda.synchronize()
            launches = _kernels.launch_counts()
            counts = {k: list(v) for k, v in mesh.counts.items()}
        finally:
            dist.destroy_process_group()
    check_shard_launches("nccl", launches)
    n_red = sum(v[0] for k, v in counts.items() if k[1] == "all_reduce")
    phase("shard:nccl", f"backend {mesh.backend}, world size 1 on {dev}: {n_red} tensors "
          f"all-reduced over one LM attempt, landmark plan halo "
          f"{None if q.pt_plan is None else q.pt_plan.halo}, table plans {sorted(q.t_plans)} | "
          f"launches { {k: n for k, n in launches.items() if n} } | {smi}")
    step_vs_single("nccl", step_of(lg, out), want)
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
    phase("build", "seconds to each source's nvcc exit: " + ", ".join(
        f"{src} {sec:.1f}" for src, sec in sorted(_kernels.build_seconds().items(),
                                                   key=lambda kv: -kv[1])))
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
    launches = {}
    bf16 = {}  # flagged path -> its bf16 launch counts
    shard = []  # the launch counts of the shard phases (each set to 0 just before it)
    # the shard ranks' problem files (the finalizer removes it on a failure)
    shard_tmp = tempfile.TemporaryDirectory()
    want = {}  # the single-device step of each shard phase's problem and state
    shard_by_rank = {}  # shard phase -> each rank's launch counts
    (launches["bias"], cov_bias, (launches["bias:bf16"], bf16["bias:bf16"]),
     shard_nccl_launches) = bias_only(dev, bench, smi)
    shard.append(shard_nccl_launches)
    torch.cuda.empty_cache()
    (launches["cap"], cov_cap, (launches["cap:bf16"], bf16["cap:bf16"]),
     want["cap"]) = capacity(dev, bench, shard_tmp.name)
    torch.cuda.empty_cache()
    launches["pcg_switch"] = pcg_switch(dev, bench)
    torch.cuda.empty_cache()
    launches.update(two_grid(dev, bench))
    torch.cuda.empty_cache()
    session, session_sec = session_600()
    with tempfile.TemporaryDirectory() as full_dir, tempfile.TemporaryDirectory() as gs_dir, \
            tempfile.TemporaryDirectory() as tools_dir:
        times = {"session": session_sec, "write": write_600(session, full_dir, 0.03)}
        (launches["full"], cov_full, (launches["full:bf16"], bf16["full:bf16"]),
         want["full"]) = full_sensor(dev, bench, full_dir, times, shard_tmp.name)
        # the cov path: its three runs' counts (each set to 0 just before it)
        runs = (cov_bias, cov_cap, cov_full)
        launches["cov"] = {k: sum(r.get(k, 0) for r in runs) for k in set().union(*runs)}
        torch.cuda.empty_cache()
        gs_times = {"session": session_sec, "write": write_600(session, gs_dir, None)}
        # the shard ranks run alone: no host work of this process beside them
        ranks = finish_ranks(start_ranks(shard_tmp.name, SHARD_JOBS), shard_tmp.name)
        shard_tmp.cleanup()
        for tag, _ in SHARD_JOBS:
            summed, shard_by_rank[tag] = shard_checks(
                tag, [r[tag] for r in ranks], want[tag]["step"], want[tag]["L"],
                want[tag]["R"], smi)
            shard.append(summed)
        launches["shard"] = {k: sum(r.get(k, 0) for r in shard) for k in set().union(*shard)}
        launches["gs_cal"] = gs_cal(dev, bench, gs_dir, gs_times)
        torch.cuda.empty_cache()
        # the preprocessing tool runs on the host while the merged sessions
        # run on the card
        started = tools_start(full_dir, tools_dir)
        try:
            launches["multi"] = multi_session(dev, bench, session, full_dir, gs_dir)
        except BaseException:
            started[0].kill()
            started[0].wait()
            raise
        tools_finish(full_dir, started)
        del session
        torch.cuda.empty_cache()
        cli_golden(dev, smi)
        cli_golden_covariances(dev)
        launches["cli"] = cli_full(dev, full_dir, smi)
        torch.cuda.empty_cache()
        cli_refinement_rows(dev, bench, full_dir)

    # the flagged paths: every kernel of the path launched (checked in
    # bf16_path), and the bf16 instantiations of BF16_PATHS among them
    for path, names in BF16_PATHS.items():
        if not all(bf16[path].get(n, 0) for n in names):
            raise AssertionError(f"{path}: bf16 instantiations not launched: {bf16[path]}")
    rows = []
    for name, (kid, src, rep, path) in KERNELS.items():
        per_path = {p: launches[p].get(name, 0) for p in PATHS if p in path.split("+")}
        if not all(per_path.values()):
            raise AssertionError(f"{name}: not launched on every path of {per_path}")
        bf16_by_path = {p: n for p in BF16_PATHS if (n := bf16[p].get(name, 0))}
        row = dict(name=name, k=kid, route="cuda", source=src, replaces=rep, path=path,
                   launches=sum(per_path.values()), launches_by_path=per_path,
                   bf16_launches_by_path=bf16_by_path, **bench.results[name])
        # the same kernel at another path's shapes (rig_k, row family, width)
        row["also"] = {key: res for key, res in bench.results.items()
                       if key.startswith(name + "(")}
        # a bf16 row's launches: its instantiation's on its flagged main path
        # (0 for K6 and K10's down pass: the back-substitution reads float32
        # J, and their pass with y runs on the route with several batches)
        # and a shard row's: its kernel's on that rank in the shard phase
        for key, res in row["also"].items():
            inner = key[len(name) + 1:].split(")")[0].split(",")
            if key.endswith(",bf16)"):
                res["launches"] = bf16[inner[0] + ":bf16"].get(name, 0)
            elif len(inner) >= 3 and inner[1] == "shard":
                res["launches"] = shard_by_rank[inner[0]][int(inner[2][len("rank"):])].get(name, 0)
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
