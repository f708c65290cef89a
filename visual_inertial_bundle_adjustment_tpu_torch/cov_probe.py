"""What sets the covariance check's kernel-to-float32 ratio on the bias-only
problem.

chip_smoke's `cov:bias` holds the float32 covariance blocks of the kernels
against a float64 solve through the plain versions over the dimensions the
problem observes (each entry's error relative to sqrt(var_i var_j), and
|std / std64 - 1|), and against a float32 solve through the plain versions:
the kernels' errors at most COV_PLAIN_RATIO times the plain float32 ones.
This probe reads that ratio on the bias-only problem (bench.py:120-146's
settings: 1,200 rigs, ~394k observations, float32 on the card) at several
Levenberg-Marquardt states, and reads what moves it:

  states    optimize() from the built state for 4, 5, 6 and 7 iterations
            through the kernels, and for 5 iterations with one kernel's sum
            order changed (that kernel through its plain version during the
            LM run: `--lm-plain`);
  solves    at each state, on chip_smoke's 4 reference rigs and 2
            calibration rows at lam 1e-9 and 400 PCG iterations, one
            solve_columns call each: the float64 plain reference; the
            kernels in float32; the plain versions in float32; the kernels
            with one kernel (or a set) swapped for its float32 plain version
            at a time (SWAPS);
  copies    the kernel and the plain float32 solves again on copies of the
            problem, float32's own spread at the state: by default the
            state moved by a relative 1e-7, about one float32 ulp, each
            copy with its own float64 reference (`perturbed_tables`: every
            Jacobian rounds anew); with --permuted, copies equal in float64
            but summed in another order (`permuted_copy`: the slots of each
            rig row permuted inside their tile);
  defects   the kernel solves on the copies again with a defect injected in
            the column K4 (`inject_defect`: a fixed relative error of each
            output entry, or one slot a rig row dropped), to show which
            check catches it.

For every solve it prints, per kind of block (rig, calibration), the worst
entry error and std ratio over the observed dimensions, the entry that sets
the worst (block, tangent indices, their float64 variances against
0.5 / lam) and the spread of the entry errors over all observed entries
(median, 90th percentile, worst); and, per state, the old check's ratio
(one draw's worst entry against another's) and `median_check`'s verdict
over the copies, chip_smoke's cov:bias check. Run on a card:

    python -m visual_inertial_bundle_adjustment_tpu_torch.cov_probe \\
        [--out cov_probe.json]

and on the CPU at the tests' tiny size (no timing meaning):

    python -m visual_inertial_bundle_adjustment_tpu_torch.cov_probe --tiny \\
        --device cpu --iterations 2 3 --lm-plain precond_rig:2 --copies 2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .ops import _kernels
from .ops import segments as seg
from .problem import covariance as cov
from .problem import rcs
from .problem.optimizer import LMSettings, Problem, optimize

COV_LAM = 1e-9  # rig_covariances' and calib_covariances' default damping
COV_PCG_ITERATIONS = 400  # the CLI's --covariance-pcg-iterations default
COV_PLAIN_RATIO = 3.0  # chip_smoke's bound of the kernels over float32
# median_check's statistics: the medians of the entry errors and of the std
# ratios over a kind's observed dimensions
CHECKED = ("corr_med", "std_med")
COPY_REL = 1e-7  # perturbed_tables' move of the copies' states
LM_PCG_ITERATIONS = 40
# the kernels swapped one at a time for their plain versions (registered
# names), and the set of all but the linearization and the assembly
SWAPS = {"K1": ("visual_linearize",), "K2": ("assemble_rig",), "K3": ("precond_rig",),
         "K4 columns": ("schur_pcg_cols",), "K5": ("schur_up",), "K6": ("schur_down",),
         "all but K1, K2": ("precond_rig", "schur_pcg_cols", "schur_up", "schur_down")}
BIAS_SESSION = dict(duration=120.0, keyframe_hz=10.0, gyro_hz=800.0, accel_hz=800.0,
                    num_points=20000, seed=17, pixel_noise=0.3, track_lifetime_sec=10.0)
TINY_SESSION = dict(duration=6.0, keyframe_hz=5.0, gyro_hz=200.0, accel_hz=200.0,
                    num_points=60, seed=3, pixel_noise=0.2)
BUILD = dict(init_pose_noise=0.005, init_point_noise=0.03, init_vel_noise=0.03,
             estimate_imu_calib=True, imu_calib_options=dict(accelBias=True, gyroBias=True))
TINY_BLOCKS = dict(rb=8, prb=16, ts=64)


# ---------------------------------------------------------------------------
# float64-equal copies
# ---------------------------------------------------------------------------


def permuted_copy(problem, seed):
    """A copy of a blocked problem whose visual batches hold the same
    observations, each rig row's slots permuted inside their tile (seeded),
    re-blocked by rcs.finalize_blocks with the batch's parameters: the same
    tiles, rig rows and landmark windows, the sums of each rig row in
    another order. Equal to `problem` in exact arithmetic; seed None keeps
    the order (the copy then equals `problem` bit for bit). Shares the
    variables, the masks and the small batches' tensors."""
    p = Problem(problem.variables, problem.masks)
    p.use_blocked_engine = problem.use_blocked_engine
    rng = np.random.default_rng(seed)
    caps = {}
    for cfg, data in zip(problem.cfgs, problem.datas):
        info = cfg.block_info
        if info is None:
            p.cfgs.append(cfg)
            p.datas.append(dict(data))
            continue
        real = data["_rig_obs"].cpu().numpy().astype(np.int64)
        if seed is not None:
            run = (real // info.ts) * (int(data["_rig_ptr"].shape[0]) + 1) + \
                data["rig"].cpu().numpy()[real]
            real = real[np.lexsort((rng.random(len(real)), run))]
        idx = torch.from_numpy(real).to(data["rig"].device)
        npad = info.nt * info.ts
        raw = {}
        for k, a in data.items():
            if k.startswith("_"):
                continue  # the layout finalize_blocks makes
            if isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == npad:
                raw[k] = a.index_select(0, idx)
            else:
                raw[k] = a
        p.cfgs.append(dataclasses.replace(cfg, block_info=None))
        p.datas.append(raw)
        caps[len(p.cfgs) - 1] = info
    for bi, info in caps.items():
        # re-block this batch alone (the others keep their layout or none)
        one = Problem(problem.variables, problem.masks)
        one.cfgs, one.datas = [p.cfgs[bi]], [p.datas[bi]]
        rcs.finalize_blocks(one, rb=info.rb, prb=info.prb, ts=info.ts,
                            prb2_cap=info.prb2, nhg_cap=info.nhg if info.prb2 else 0)
        if one.cfgs[0].block_info != info:
            raise AssertionError(f"batch {bi}: re-blocked as {one.cfgs[0].block_info}, "
                                 f"not {info}")
        p.cfgs[bi], p.datas[bi] = one.cfgs[0], one.datas[0]
    return p


def shallow_copy(problem):
    """A problem that shares `problem`'s variables, batches and layout (for
    another state, perturbed_tables', or another type, problem_f64)."""
    p = Problem(problem.variables, problem.masks)
    p.cfgs, p.datas = list(problem.cfgs), list(problem.datas)
    return p


def perturbed_tables(v, rel, seed):
    """Every variable table with each entry moved by a relative +-rel
    (signs from `seed`): at rel 1e-7, about one float32 ulp, a state that
    float32 cannot tell from v but that every Jacobian rounds anew."""
    g = torch.Generator(device=v.points.device).manual_seed(seed)

    def move(a):
        s = torch.randint(0, 2, a.shape, generator=g, device=a.device).to(a.dtype) * 2 - 1
        return a * (1 + rel * s)

    return type(v)(*(move(a) for a in v))


def problem_f64(problem):
    """A float64 copy of a problem (the batches' layout and plans kept)."""
    return shallow_copy(problem).to(dtype=torch.float64)


# ---------------------------------------------------------------------------
# covariance blocks and their errors over the observed dimensions
# ---------------------------------------------------------------------------


def cov_blocks(problem, rigs, rows, lam=COV_LAM, pcg_iters=COV_PCG_ITERATIONS, plain=None):
    """The rig blocks of `rigs` and the IMU-calibration blocks of `rows`
    (their unmasked dimensions), as rig_covariances and calib_covariances
    give them, in one solve_columns call for all their columns: {("rig",
    r): (12, 12), ("cal", r): (n, n)}. plain: None for the kernels, True for
    every plain version, or kernel names (plain_reference(only=...))."""
    marr = problem.masks.imu_calib.cpu().numpy()
    dims = {r: [d for d in range(marr.shape[1]) if marr[r, d] > 0.5] for r in rows}
    entries = ([("rig", int(r), d) for r in rigs for d in range(12)]
               + [("imu_calib", int(r), d) for r in rows for d in dims[r]])
    route = (contextlib.nullcontext() if plain is None
             else _kernels.plain_reference(None if plain is True else plain))
    with route, cov.with_gauge_prior(problem):
        cols = cov.solve_columns(problem, entries, system=cov.prepare_system(problem, lam),
                                 pcg_iters=pcg_iters)
    B = cov._extract_cov(cols, entries)
    out, pos = {}, 0
    for key, n in [(("rig", r), 12) for r in rigs] + [(("cal", r), len(dims[r])) for r in rows]:
        out[key] = B[pos:pos + n, pos:pos + n]
        pos += n
    return out


def observed_entries(got, want, lam):
    """A block against its float64 counterpart over the dimensions the
    problem observes (float64 variance below 0.5 / lam: a dimension no
    factor reaches has variance 1 / lam): (their indices, each entry's error
    relative to sqrt(W_ii W_jj) (n, n), each |std / std64 - 1| (n,), the
    float64 variances (n,))."""
    obs = np.nonzero(np.diag(want) < 0.5 / lam)[0]
    G, W = got[np.ix_(obs, obs)], want[np.ix_(obs, obs)]
    var = np.diag(W)
    sd = np.sqrt(var)
    return (obs, np.abs(G - W) / np.outer(sd, sd), np.abs(np.sqrt(np.diag(G)) / sd - 1.0), var)


def observed_reading(got, want, lam):
    """Per kind of block ("rig", "cal"): the worst entry error ("corr") and
    std ratio ("std") over the observed dimensions, as chip_smoke's
    cov_compare takes them; their medians ("corr_med", "std_med":
    median_check's statistics) and 90th percentiles ("corr_p90", "std_p90")
    over every observed entry (upper triangles) and dimension of the kind;
    the entry that sets the worst entry error
    (block, tangent indices, their float64 variances, 0.5 / lam); and the
    spread of the entry errors: median, 90th percentile, worst."""
    out = {}
    for key, W in want.items():
        if not W.size or key not in got:
            continue
        obs, E, S, var = observed_entries(got[key], W, lam)
        if not obs.size:
            continue
        r = out.setdefault(key[0], dict(corr=0.0, std=0.0, dims=0, nonfinite=0, errors=[],
                                        stds=[]))
        r["dims"] += int(obs.size)
        bad = int((~np.isfinite(got[key])).sum())
        if bad:  # a solve that broke down: no error to rank, the worst reading
            r.update(nonfinite=r["nonfinite"] + bad, corr=np.inf, std=np.inf,
                     at=dict(block=list(key), i=-1, j=-1, var_i=np.nan, var_j=np.nan,
                             half_over_lam=0.5 / lam))
            continue
        r["errors"].extend(E[np.triu_indices(obs.size)].tolist())
        r["stds"].extend(S.tolist())
        i, j = np.unravel_index(np.argmax(E), E.shape)
        if E[i, j] >= r["corr"]:
            r.update(corr=float(E[i, j]), at=dict(
                block=list(key), i=int(obs[i]), j=int(obs[j]), var_i=float(var[i]),
                var_j=float(var[j]), half_over_lam=0.5 / lam))
        r["std"] = max(r["std"], float(S.max()))
    for r in out.values():
        e, s = np.asarray(r.pop("errors")), np.asarray(r.pop("stds"))
        whole = not r["nonfinite"] and e.size
        for name, x in (("corr", e), ("std", s)):
            r[f"{name}_med"] = float(np.median(x)) if whole else np.inf
            r[f"{name}_p90"] = float(np.percentile(x, 90)) if whole else np.inf
        r["spread"] = (dict(median=r["corr_med"], p90=r["corr_p90"],
                            worst=float(e.max()), entries=int(e.size)) if whole
                       else dict(median=np.inf, p90=np.inf, worst=np.inf, entries=0))
    return out


def median_check(kernel, plain, ratio=COV_PLAIN_RATIO):
    """The covariance check over float32's own spread: `kernel` and `plain`
    are readings (observed_reading) of the kernels' and the plain float32
    solves on the same copies of the problem, one each a copy (each copy
    against its own float64 reference). For each kind of block, the median
    over the copies of the kernels' median entry error ("corr_med") and
    median std ratio ("std_med") over the observed dimensions must be at
    most `ratio` times the plain solves' median. Returns ({kind:
    {statistic: (kernel median, plain median, their ratio)}}, the failures
    as text); the 90th percentiles' and the worst entry's medians
    ("corr_p90", "std_p90", "corr", "std") are in the first, read beside,
    not held."""
    if len(kernel) != len(plain) or len(kernel) < 3:
        raise ValueError(f"median_check: {len(kernel)} kernel and {len(plain)} plain readings "
                         "(at least 3 copies, one of each a copy)")
    out, fail = {}, []
    for kind in kernel[0]:
        out[kind] = {}
        for m in CHECKED + ("corr_p90", "std_p90", "corr", "std"):
            k = statistics.median(r[kind][m] for r in kernel)
            q = statistics.median(r[kind][m] for r in plain)
            out[kind][m] = (k, q, k / max(q, 1e-300))
            if m in CHECKED and not k <= ratio * q:
                fail.append(f"{kind} {m}: kernels' median {k:.3e} beyond {ratio:g}x the plain "
                            f"float32 median {q:.3e}")
    return out, fail


def copy_readings(problem, rigs, rows, copies=3, pcg_iters=COV_PCG_ITERATIONS, first=None,
                  defect=None, log=None):
    """median_check's inputs at the problem's state: the kernels' and the
    plain float32 solves' readings (observed_reading) of the blocks of
    `rigs` and `rows` on the problem and on copies - 1 copies whose states
    are moved by COPY_REL (perturbed_tables), each against the float64
    solve of its own state. `first`: the problem's own (kernel, plain
    float32, float64) blocks when already solved; `defect`: the kernels'
    solves under inject_defect(defect). log(copy, {solve: seconds}, the
    float64 blocks' largest move from copy 0's, relative to each block's
    largest entry) after each copy."""
    v = problem.variables
    kern, plain, want0 = [], [], None
    for c in range(copies):
        q = problem
        if c:
            q = shallow_copy(problem)
            q.variables = perturbed_tables(v, COPY_REL, c)
        secs = {}

        def timed(key, fn):
            t0 = time.perf_counter()
            out = fn()
            secs[key] = time.perf_counter() - t0
            return out

        if c == 0 and first is not None and defect is None:
            got, p32, want = first
        else:
            want = (first[2] if c == 0 and first is not None else timed(
                "float64", lambda: cov_blocks(problem_f64(q), rigs, rows, pcg_iters=pcg_iters,
                                              plain=True)))
            with inject_defect(defect) if defect else contextlib.nullcontext():
                got = timed("kernels", lambda: cov_blocks(q, rigs, rows, pcg_iters=pcg_iters))
            p32 = (first[1] if c == 0 and first is not None else timed(
                "plain", lambda: cov_blocks(q, rigs, rows, pcg_iters=pcg_iters, plain=True)))
        want0 = want if c == 0 else want0
        kern.append(observed_reading(got, want, COV_LAM))
        plain.append(observed_reading(p32, want, COV_LAM))
        if log is not None:
            log(c, secs, max(float(np.abs(want[k] - W).max() / np.abs(W).max())
                             for k, W in want0.items() if W.size))
    return kern, plain


@contextlib.contextmanager
def inject_defect(defect):
    """The column K4 with a defect, for showing what the covariance check
    catches: "rel:X", a relative error X in each entry of its output (a
    fixed pattern of signs, the same at every call of one shape); "drop",
    the first slot of each rig row left out of its walk (its weight zeroed
    in the column K4's inputs alone: the preconditioner and the other
    kernels keep it). Patches the segments module's entry, which rcs calls,
    for the block only."""
    kind, _, amount = defect.partition(":")
    if kind not in ("rel", "drop"):
        raise ValueError(f"inject_defect: unknown defect {defect!r}")
    orig = seg.seg_schur_pcg_cols
    cache = {}

    def relative(*args, **kw):
        y = orig(*args, **kw)
        s = cache.get(y.shape)
        if s is None:
            g = torch.Generator(device=y.device).manual_seed(7)
            s = cache[y.shape] = torch.randint(0, 2, y.shape, generator=g, device=y.device,
                                               dtype=torch.int64).to(y.dtype) * 2 - 1
        return y * (1 + float(amount) * s)

    def dropped(J_r, J_p, w, x_table, hinv, plan, rec=None):
        key = w.data_ptr()
        if key not in cache:
            ptr = plan.rig_ptr.long()
            first = plan.rig_obs.long()[ptr[:-1][ptr[1:] > ptr[:-1]]]
            w2 = w.clone()
            w2[first] = 0
            rec2 = (seg.point_sorted_records(J_r.float(), J_p.float(), w2, plan)
                    if w.device.type == "cuda" else None)
            cache[key] = (w2, rec2)
        w2, rec2 = cache[key]
        return orig(J_r, J_p, w2, x_table, hinv, plan, rec=rec2)

    patched = relative if kind == "rel" else dropped
    # the wrapper counts its launches on the module's entry: the patch's
    patched.launches, patched.bf16_launches = orig.launches, orig.bf16_launches
    seg.seg_schur_pcg_cols = patched
    try:
        yield
    finally:
        seg.seg_schur_pcg_cols = orig
        orig.launches, orig.bf16_launches = patched.launches, patched.bf16_launches


# ---------------------------------------------------------------------------
# diagnostics: the linearization and the preconditioner at a state
# ---------------------------------------------------------------------------


def _vis_lin(problem, plain=None):
    """(VisBatch, valid) of the problem's blocked visual batch linearized at
    its state, the kernels in `plain` through their plain versions."""
    route = (contextlib.nullcontext() if plain is None
             else _kernels.plain_reference(None if plain is True else plain))
    with route:
        ks = problem._build()
        datas = tuple(problem.datas)
        lg = ks[0](datas, problem.variables, problem.masks, None)
        (b, lin), = rcs._vis_batches(problem.active_cfgs, datas, lg)
    return b, lin.valid


def jacobian_errors(problem, p64):
    """The visual batch's J (rig and landmark blocks), its weights and
    valid flags from K1 and from its plain version in float32, each
    against the plain version in float64 on `p64` (the same state), per
    real slot: a slot's error is max |J - J64| over its entries relative
    to its own max |J64|. Returns {route: summary}."""
    b64, valid64 = _vis_lin(p64, plain=True)
    real = b64.plan.rig_obs.long()
    J64 = torch.cat([b64.J, b64.J_pt], 1).reshape(-1, b64.w.shape[0])[:, real]
    out = {}
    for route, plain in (("K1", None), ("plain float32", ("visual_linearize",))):
        b, valid = _vis_lin(problem, plain)
        J = torch.cat([b.J, b.J_pt], 1).reshape(-1, b.w.shape[0])[:, real].double()
        scale = J64.abs().amax(0).clamp(min=1e-300)
        err = ((J - J64).abs().amax(0) / scale).cpu().numpy()
        w, w64 = b.w[real].double(), b64.w[real]
        top = np.argsort(err)[::-1][:5]
        rig = b64.plan.rig[real].cpu().numpy()
        out[route] = dict(
            worst=float(err.max()), p9999=float(np.percentile(err, 99.99)),
            median=float(np.median(err)), over_1e5=int((err > 1e-5).sum()),
            over_1e3=int((err > 1e-3).sum()),
            valid_flips=int((valid[real] != valid64[real]).sum()),
            w_worst=float(((w - w64).abs() / w64.abs().clamp(min=1e-300)).max()),
            top=[dict(rig=int(rig[i]), err=float(err[i]), J_max=float(scale[i]),
                      w=float(w64[i])) for i in top])
    return out


def precond_report(problem, plain=None, lam=COV_LAM):
    """The rig blocks of the covariance system's preconditioner whose
    inverse is not finite: per block, whether the damped block handed to
    the inverse and K3's Schur-corrected block are finite, the float64
    eigenvalues' range where they are, the largest landmark inverse
    (H_ll^-1) among the block's landmarks and over all, and the largest
    per-slot correction A H_ll^-1 A^T in float64 from the float32 inputs
    (A = J_r^T w J_p)."""
    from .problem import engine

    seen = []
    inv = engine._precond_inv

    def capture(B):
        seen.append(B)
        return inv(B)

    route = (contextlib.nullcontext() if plain is None
             else _kernels.plain_reference(None if plain is True else plain))
    engine._precond_inv = capture
    try:
        with route, cov.with_gauge_prior(problem):
            _, rs = cov.prepare_system(problem, lam)
            (b,) = rs.vis
            k3 = seg.seg_precond_rig(b.J, b.J_pt, b.w, rs.H_ll_inv, b.plan)
    finally:
        engine._precond_inv = inv
    R = problem.variables.pose_q.shape[0]
    (B,) = [x for x in seen if x.shape[0] == R and x.shape[-1] == 12]
    Binv = rs.precond_inv.rig
    bad = (~torch.isfinite(Binv).reshape(R, -1).all(-1)).nonzero().flatten().tolist()
    hinv_max = rs.H_ll_inv.abs().reshape(-1, 9).amax(-1)
    out = {"H_ll_inv max": float(hinv_max.max())}
    ptr = b.plan.rig_ptr.long()
    for r in bad[:3]:
        slots = b.plan.rig_obs.long()[ptr[r]:ptr[r + 1]]
        pts = b.plan.point.long()[slots]
        J_r, J_p = b.J[:, :, slots].double(), b.J_pt[:, :, slots].double()
        w = b.w[slots].double()
        A = torch.einsum("dks,dls,s->skl", J_r, J_p, w)  # (S, k, 3)
        corr = torch.einsum("skl,slm,snm->skn", A, rs.H_ll_inv[pts].double(), A)
        rep = dict(block_finite=bool(torch.isfinite(B[r]).all()),
                   k3_finite=bool(torch.isfinite(k3[r]).all()),
                   slots=int(slots.numel()),
                   hinv_max_here=float(hinv_max[pts].max()),
                   corr_max=float(corr.abs().max()),
                   B0_diag_max=float(torch.einsum("dks,dks,s->k", J_r, J_r, w).max()))
        if rep["block_finite"]:
            ev = torch.linalg.eigvalsh(B[r].double())
            rep.update(eig_min=float(ev.min()), eig_max=float(ev.max()))
        out[r] = rep
    return out


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def bias_problem(device, tiny=False):
    """chip_smoke's bias-only problem (bench.py:120-146's settings), built and
    blocked on `device` in float32; tiny: the tests' 6 s session blocked at
    64-slot tiles."""
    from .pipeline.builder import BuildOptions, build_synthetic_problem
    from .pipeline.synthetic import SyntheticSession

    s = SyntheticSession(**(TINY_SESSION if tiny else BIAS_SESSION))
    p = build_synthetic_problem(s, BuildOptions(**BUILD), device=device, dtype=torch.float32)
    if tiny:
        rcs.finalize_blocks(p, **TINY_BLOCKS)
    p._build()
    return p


def reference_rows(problem):
    """chip_smoke's cov:bias reference: rigs[::16] of 64 rigs spread over the
    session (rig 0, the gauge rig, left out) and the first 2 calibration
    rows."""
    R = int(problem.variables.pose_q.shape[0])
    rigs = [int(r) for r in np.linspace(1, R - 1, 64).round()]
    return rigs[::16], list(range(problem.variables.imu_calib.shape[0]))[:2]


def lm_state(problem, v0, iterations, plain=None):
    """optimize() from v0 for `iterations` iterations (chip_smoke's settings:
    PCG 40 iterations, Gauss-Seidel), with the kernels in `plain` through
    their plain versions: (the state reached, its cost)."""
    problem.variables = v0
    settings = LMSettings(max_iterations=iterations, direct_mode=False,
                          pcg_max_iterations=LM_PCG_ITERATIONS, preconditioner="gauss_seidel")
    route = contextlib.nullcontext() if plain is None else _kernels.plain_reference(plain)
    with route:
        summary = optimize(problem, settings)
    v = problem.variables
    problem.variables = v0
    return v, summary.final_cost


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(device, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _line(tag, reading, base=None):
    """One printed line of a reading, with its ratios over `base`'s."""
    parts = []
    for kind, r in reading.items():
        at = r["at"]
        ratio = ""
        if base is not None and kind in base:
            ratio = (f" ({r['corr'] / max(base[kind]['corr'], 1e-300):.2f}x / "
                     f"{r['std'] / max(base[kind]['std'], 1e-300):.2f}x)")
        if r["nonfinite"]:
            parts.append(f"{kind} {r['nonfinite']} entries not finite")
            continue
        parts.append(f"{kind} {r['corr']:.3e} / {r['std']:.3e}{ratio} worst at "
                     f"{at['block'][0]} {at['block'][1]} [{at['i']},{at['j']}] var "
                     f"{at['var_i']:.2e},{at['var_j']:.2e} (0.5/lam {at['half_over_lam']:.0e}); "
                     f"entries median {r['corr_med']:.2e} p90 {r['corr_p90']:.2e}, std "
                     f"median {r['std_med']:.2e} p90 {r['std_p90']:.2e}")
    print(f"  {tag}: " + " | ".join(parts), flush=True)


def read_state(label, problem, copies, v, rigs, rows, args, device):
    """Every solve of one state (module doc): a dict of readings and
    seconds."""
    problem.variables = v
    for c, p in enumerate(copies, 1):
        p.variables = perturbed_tables(v, args.perturb, c) if args.perturb else v
    out = dict(state=label, seconds={})

    def solve(tag, p, plain=None, defect=None):
        def run():
            with inject_defect(defect) if defect else contextlib.nullcontext():
                return cov_blocks(p, rigs, rows, pcg_iters=args.pcg_iterations, plain=plain)
        _kernels.reset_launch_counts()
        blocks, sec = _timed(device, run)
        out["seconds"].setdefault(tag.split("[")[0], []).append(sec)
        out.setdefault("launches", {})[tag] = {
            k: n for k, n in _kernels.launch_counts().items() if n}
        return blocks

    everyone = [problem] + copies
    # the float64 reference of each copy: one for all when the copies are
    # equal in float64, one each when their states are perturbed
    wants = []
    for p in everyone[:len(everyone) if args.perturb else 1]:
        p64 = problem_f64(p)
        wants.append(solve("float64 plain", p64, plain=True))
        del p64
    wants += [wants[0]] * (len(everyone) - len(wants))
    read = {}
    for c in range(1, len(wants)) if args.perturb else ():
        read[f"float64[{c}]"] = observed_reading(wants[c], wants[0], COV_LAM)
        moved = max(float(np.abs(wants[c][k] - W).max() / np.abs(W).max())
                    for k, W in wants[0].items() if W.size)
        out.setdefault("float64_moved", []).append(moved)
        _line(f"copy {c} float64 against copy 0's (the largest block entry moved by "
              f"{moved:.2e} of its block's largest)", read[f"float64[{c}]"])

    def reading(tag, blocks, p=problem, plain=None, c=0):
        read[tag] = observed_reading(blocks, wants[c], COV_LAM)
        if any(r["nonfinite"] for r in read[tag].values()):
            print(f"  {tag}: non-finite blocks; the preconditioner's non-finite blocks: "
                  f"{precond_report(p, plain)}", flush=True)
        return read[tag]

    for c, p in enumerate(everyone):
        reading(f"kernels[{c}]", solve("kernels", p), p, None, c)
        reading(f"plain32[{c}]", solve("plain32", p, plain=True), p, True, c)
        _line(f"copy {c} kernels", read[f"kernels[{c}]"], read[f"plain32[{c}]"])
        _line(f"copy {c} plain float32", read[f"plain32[{c}]"])
    print(f"  launches of the kernel solve: {out['launches']['kernels']}", flush=True)
    for name, kernels in SWAPS.items():
        r = reading(f"swap {name}", solve(f"swap {name}", problem, plain=kernels), problem,
                    kernels)
        _line(f"kernels, {name} plain", r, read["plain32[0]"])
    for d in args.defects:
        for c, p in enumerate(everyone):
            r = reading(f"defect {d}[{c}]", solve(f"defect {d}", p, defect=d), p, None, c)
            _line(f"copy {c} kernels, column K4 defect {d}", r, read[f"plain32[{c}]"])
    n = len(everyone)
    kern = [read[f"kernels[{c}]"] for c in range(n)]
    plain = [read[f"plain32[{c}]"] for c in range(n)]
    out["old_check"] = {kind: [{m: kern[c][kind][m] / max(plain[c][kind][m], 1e-300)
                                for m in ("corr", "std")} for c in range(n)]
                        for kind in kern[0]}
    if n >= 3:
        stat, fail = median_check(kern, plain)
        out["median_check"] = dict(stat=stat, fail=fail)
        print(f"  median check over {n} copies: " + "; ".join(
            f"{kind} {m} {k:.3e} / {q:.3e} = {x:.2f}x" for kind, d in stat.items()
            for m, (k, q, x) in d.items()) + (f" FAILS: {fail}" if fail else " passes"))
        for d in args.defects:
            dstat, dfail = median_check([read[f"defect {d}[{c}]"] for c in range(n)], plain)
            out.setdefault("defect_check", {})[d] = dict(stat=dstat, fail=dfail)
            old = [read[f"defect {d}[{c}]"]["rig"]["corr"] / max(plain[c]["rig"]["corr"], 1e-300)
                   for c in range(n)]
            print(f"  defect {d}: median check "
                  + ("catches it" if dfail else "MISSES it") + ", rig corr_med "
                  + f"{dstat['rig']['corr_med'][2]:.2f}x, p90 "
                  + f"{dstat['rig']['corr_p90'][2]:.2f}x, worst entry "
                  + f"{dstat['rig']['corr'][2]:.2f}x; the old check per copy (rig corr) "
                  + " ".join(f"{x:.2f}x" for x in old), flush=True)
    out["readings"] = read
    print(f"  seconds: " + ", ".join(f"{k} {statistics.mean(v):.1f} (x{len(v)})"
                                     for k, v in out["seconds"].items()), flush=True)
    return out


def diagnose_state(label, problem, copies, v, rigs, rows, args, device):
    """What the readings of read_state rest on, at one state: the
    linearization's errors (jacobian_errors), the non-finite preconditioner
    blocks (precond_report) of the kernels and of the plain versions, the
    float64 reference's own spread over the copies, and the float64, kernel
    and plain solves at `--long-iterations` PCG iterations against the
    float64 solves at both counts."""
    for p in [problem] + copies:
        p.variables = v
    out = dict(state=label)
    p64 = problem_f64(problem)
    out["jacobians"] = jacobian_errors(problem, p64)
    print(f"  J against float64: " + "; ".join(
        f"{k}: worst {r['worst']:.2e}, p99.99 {r['p9999']:.2e}, > 1e-5 {r['over_1e5']}, "
        f"> 1e-3 {r['over_1e3']}, valid flips {r['valid_flips']}, w {r['w_worst']:.2e}, top "
        + ", ".join(f"rig {x['rig']} {x['err']:.1e}" for x in r["top"][:3])
        for k, r in out["jacobians"].items()), flush=True)
    out["precond"] = {"kernels": precond_report(problem), "plain": precond_report(problem, True)}
    print(f"  non-finite preconditioner blocks: {out['precond']}", flush=True)
    n, m = args.pcg_iterations, args.long_iterations
    want = {n: cov_blocks(p64, rigs, rows, pcg_iters=n, plain=True),
            m: cov_blocks(p64, rigs, rows, pcg_iters=m, plain=True)}
    read = {}
    read["float64 copy 0 at long"] = observed_reading(want[m], want[n], COV_LAM)
    for c, q in enumerate(copies, 1):
        q64 = problem_f64(q)
        read[f"float64 copy {c}"] = observed_reading(
            cov_blocks(q64, rigs, rows, pcg_iters=n, plain=True), want[n], COV_LAM)
        del q64
    for tag, plain in (("kernels", None), ("plain32", True)):
        for it in (n, m):
            blocks = cov_blocks(problem, rigs, rows, pcg_iters=it, plain=plain)
            for ref in (n, m):
                read[f"{tag} at {it} vs float64 at {ref}"] = observed_reading(
                    blocks, want[ref], COV_LAM)
    del p64
    for tag, r in read.items():
        _line(tag, r)
    out["readings"] = read
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tests' 6 s problem (CPU runs)")
    ap.add_argument("--iterations", type=int, nargs="+", default=[4, 5, 6, 7],
                    help="LM iterations of the kernel states")
    ap.add_argument("--lm-plain", nargs="*", default=["precond_rig:5", "schur_pcg:5",
                                                      "assemble_rig:5", "schur_down:5"],
                    help="more states: KERNEL[+KERNEL]:ITERATIONS, those kernels plain "
                         "during the LM run")
    ap.add_argument("--copies", type=int, default=2,
                    help="copies besides the problem itself")
    ap.add_argument("--defects", nargs="*", default=["rel:1e-3", "rel:1e-2", "drop"],
                    help="defects injected in the column K4 (inject_defect)")
    ap.add_argument("--pcg-iterations", type=int, default=COV_PCG_ITERATIONS)
    ap.add_argument("--perturb", type=float, default=COPY_REL,
                    help="the copies' states moved by this relative amount "
                         "(perturbed_tables), each copy with its own float64 reference")
    ap.add_argument("--permuted", action="store_true",
                    help="copies equal in float64 instead: each rig row's slots permuted "
                         "inside its tile (permuted_copy), one float64 reference")
    ap.add_argument("--out", default=None, help="JSON of every reading")
    ap.add_argument("--diagnose", action="store_true",
                    help="diagnose_state at each state instead of read_state")
    ap.add_argument("--long-iterations", type=int, default=1600,
                    help="the diagnosis's longer PCG solves")
    args = ap.parse_args(argv)
    if args.permuted:
        args.perturb = 0.0
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("cov_probe: no CUDA device")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
        t0 = time.time()
        _kernels.lib()
        print(f"build: {time.time() - t0:.1f} s; seconds to each source's nvcc exit: " + ", ".join(
            f"{s} {x:.1f}" for s, x in sorted(_kernels.build_seconds().items(),
                                               key=lambda kv: -kv[1])), flush=True)
    t0 = time.time()
    problem = bias_problem(device, tiny=args.tiny)
    rigs, rows = reference_rows(problem)
    print(f"problem: R {problem.variables.pose_q.shape[0]}, built in {time.time() - t0:.1f} s; "
          f"reference rigs {rigs}, calibration rows {rows}", flush=True)
    v0 = problem.variables
    copies, sec = _timed(device, lambda: [
        shallow_copy(problem) if args.perturb else permuted_copy(problem, seed)
        for seed in range(1, args.copies + 1)])
    print(f"{args.copies} {'perturbed' if args.perturb else 'permuted'} copies in {sec:.1f} s",
          flush=True)
    states = [(f"kernels, {n} iterations", None, n) for n in args.iterations]
    for spec in args.lm_plain:
        names, n = spec.split(":")
        states.append((f"{names} plain in the LM run, {n} iterations", names.split("+"), int(n)))
    results = []
    for label, plain, n in states:
        (v, cost), sec = _timed(device, lambda: lm_state(problem, v0, n, plain))
        print(f"state '{label}': cost {cost:.6f} ({sec:.1f} s)", flush=True)
        res = (diagnose_state if args.diagnose else read_state)(
            label, problem, copies, v, rigs, rows, args, device)
        res["cost"] = cost
        results.append(res)
        if args.out:  # after every state: a call cut short keeps what it read
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1, default=float))
    problem.variables = v0
    if args.diagnose:
        return 0
    print("summary (old check: kernels / plain float32 per copy, rig corr; the median "
          "check's rig corr_med and std_med ratios):", flush=True)
    for r in results:
        old = " ".join(f"{x['corr']:.2f}x" for x in r["old_check"]["rig"])
        med = r.get("median_check", {}).get("stat", {}).get("rig")
        print(f"  {r['state']} (cost {r['cost']:.4f}): old {old}"
              + (f"; median {med['corr_med'][2]:.2f}x / {med['std_med'][2]:.2f}x"
                 + (" FAILS" if r["median_check"]["fail"] else "") if med else ""), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
