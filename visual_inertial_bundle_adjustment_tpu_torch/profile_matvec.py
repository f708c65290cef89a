"""The general-path Schur matvec composed from the K14 tile-partials kernels,
checked against the solver's own route and timed component by component.

Counterpart of the JAX package's `tools_dev/profile_matvec.py`. The solver
(`problem/rcs.py`) runs the general path over CSR lists: K12 on the rig rows,
K13a/K13b on the landmark rows. The JAX package ran it on two grids of ragged
tiles instead, the rig-sorted grid and a point-sorted second grid reached
through permutations, with per-tile partials. This module composes that
layout on the port's K14 kernels (`ops/segments.py`, `csrc/tile_segments.cu`):

  rig side    gather_tiles(x_r) -> K14c (wu = w J x, partials of J^T wu)
              -> scatter_partials into the rig rows
  W^T x       permute wu to the point grid -> K14e -> scatter_partials
              into the landmark rows -> 3x3 solve z = H_ll^-1 t
  W z         gather_tiles(z) -> K14d -> permute back, x w -> K14e on the
              rig grid -> scatter_partials
  plus        the rest graph and damping terms of rcs.matvec

and, beside the matvec, K14a (the landmark blocks J_pt^T w J_pt as 9-wide
partials on the point grid) and K14b (the landmark step expanded to the point
grid's slots). Every scatter_partials runs K13c over the rows' partials in
tile order (no atomics). Only blocked batches whose one non-point group is
the rig are composed (the two-grid configuration's batch; a single-pass one
too, whose solver route is then K4-K6, not K12/K13).

Run on a card (times from CUDA events; `--device cpu` checks only):

    python -m visual_inertial_bundle_adjustment_tpu_torch.profile_matvec

It builds the two-grid problem (a 120 s synthetic session whose 6,000
landmarks are re-observed over the whole session, ~3.1M observations, float32)
and prints the composed matvec's error against rcs.matvec, the median time of
each component and of the K12/K13 route (CUDA events around each call, so
a small component's time includes the host's enqueue time), the device time
of each kernel of the visual summand on both routes (torch.profiler), and
the card's name.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import NamedTuple

import torch

from .ops import _kernels
from .ops import segments as seg
from .problem import engine, rcs
from .problem import factors as fct
from .problem.structure import Tangent, zero_tangent


class Grid(NamedTuple):
    """One grid of ragged tiles of a blocked batch (the rig-sorted one or
    the point-sorted one) with its run list and partials plan."""

    local: torch.Tensor  # (nt*ts,) int32 row of each slot within its tile's window
    rows: torch.Tensor  # (nt*rb,) int32 the rows each tile addresses
    nt: int
    ts: int
    rb: int
    plan: seg.TilePlan  # runs of each (tile, row), for K14a/c/e
    part_plan: seg.RowPlan  # scatter_partials' plan into the table rows

    def gather(self, table):
        return seg.gather_tiles(table, self.rows, self.nt, self.rb)

    def scatter(self, part, n_rows):
        return seg.scatter_partials(part, self.rows, n_rows, self.rb, self.part_plan)


class TileBatch(NamedTuple):
    """A rig-only blocked batch on its two grids, for one linearization."""

    b: rcs.VisBatch
    rig: Grid
    pt: Grid
    perm: torch.Tensor  # (pnt*ts,) int64 rig-grid slot of each point-grid slot
    inv: torch.Tensor  # (nt*ts,) int64 point-grid slot of each rig-grid slot
    J_pt_po: torch.Tensor  # (2, 3, pnt*ts) J_pt on the point grid, pads zeroed
    w_po: torch.Tensor  # (pnt*ts,) weights on the point grid, pads zeroed
    real: torch.Tensor  # (pnt*ts,) bool: the point grid's real slots


class Context(NamedTuple):
    v: object  # VariableTables
    rs: rcs.RcsSystem
    batches: tuple  # tuple[TileBatch]


def _grid(local, bases, n_rows, nt, ts, rb):
    rows = seg._rows_from_bases(bases, nt, rb)
    return Grid(local, rows, nt, ts, rb, seg.tile_plan(local, nt, ts, rb),
                seg.partials_plan(rows, n_rows))


def setup(problem, lam=1e-4) -> Context:
    """Linearize and assemble the problem at its state, damp at `lam`, and
    lay each blocked batch out on its two grids (run lists and partials
    plans built once, on the problem's device)."""
    ks = problem._build()
    datas, v, masks = tuple(problem.datas), problem.variables, problem.masks
    lg = ks[0](datas, v, masks, None)
    asm = ks[6](datas, lg, v, masks)
    if asm is None:
        raise ValueError("the problem has no blocked visual batch")
    rs = rcs.with_damping(asm, v, masks, lam)
    R, L = v.pose_q.shape[0], v.points.shape[0]
    out = []
    vis_datas = [d for c, d in zip(problem.cfgs, datas) if c.block_info is not None]
    for b, data in zip(asm.vis, vis_datas):
        if b.groups != (fct.RIG,):
            raise ValueError(f"batch with groups {b.groups}: only rig-only batches are composed")
        i = b.info
        perm = data["_pt_perm"].to(torch.int64)
        pw = data["_pt_w"]
        out.append(TileBatch(
            b=b, rig=_grid(data["_rb_local"], data["_rb_base"], R, i.nt, i.ts, i.rb),
            pt=_grid(data["_pt_local"], data["_pt_base"], L, i.pnt, i.pts, i.prb),
            perm=perm, inv=data["_pt_inv"].to(torch.int64),
            J_pt_po=(rcs.permute_cols(b.J_pt, perm) * pw[None, None, :]).contiguous(),
            w_po=b.w.index_select(0, perm) * pw, real=pw > 0.5))
    return Context(v, rs, tuple(out))


def _rig_down(tb: TileBatch, x_rig, R):
    """K14c on the rig grid: (wu, y_r (R, k))."""
    g, b = tb.rig, tb.b
    wu, part = seg.seg_mv_fused(b.J, b.w, g.gather(x_rig[:, :b.rig_k].contiguous()), g.local,
                                g.nt, g.ts, g.rb, g.plan)
    return wu, g.scatter(part, R)


def _pt_reduce(tb: TileBatch, wu, L):
    """W^T-side summand: wu (2, N) rig order -> (L, 3) through K14e on the
    point grid."""
    g = tb.pt
    part = seg.seg_mv_scatter(tb.J_pt_po, rcs.permute_cols(wu, tb.perm).contiguous(), g.local,
                              g.nt, g.ts, g.rb, g.plan)
    return g.scatter(part, L)


def _pt_expand(tb: TileBatch, z):
    """u2 (2, N) rig order = w J_pt z[pt], through K14d on the point grid."""
    g = tb.pt
    u2_po = seg.seg_mv_gather(tb.J_pt_po, g.gather(z), g.local, g.nt, g.ts, g.rb)
    return rcs.permute_cols(u2_po, tb.inv) * tb.b.w[None, :]


def _rig_up(tb: TileBatch, u2, R):
    """K14e on the rig grid: (R, k) sums of J^T u2."""
    g, b = tb.rig, tb.b
    return g.scatter(seg.seg_mv_scatter(b.J, u2.contiguous(), g.local, g.nt, g.ts, g.rb,
                                        g.plan), R)


def tile_matvec(ctx: Context, x: Tangent) -> Tangent:
    """rcs.matvec(ctx.rs, ctx.v, x) with every blocked batch on its two grids
    (K14c, K14e, K14d, scatter_partials); the rest graph, the point-coupled
    small batches and the damping as in rcs.matvec."""
    rs, v = ctx.rs, ctx.v
    R, L = v.pose_q.shape[0], v.points.shape[0]
    hx = rcs.rest_hmatvec(rs.rest_stacks, v, x)
    y_rig = hx.rig
    t = torch.zeros_like(v.points)
    for tb in ctx.batches:
        wu, y_b = _rig_down(tb, x.rig, R)
        y_rig = y_rig + rcs._padk(y_b, tb.b.rig_k)
        t = t + _pt_reduce(tb, wu, L)
    if rs.rest_pt.lins:
        t = t + engine._hmatvec(rs.rest_pt, v, x, torch.zeros_like(v.points))[1]
    z = engine._chol_solve(rs.H_ll_inv, t)
    for tb in ctx.batches:
        y_rig = y_rig - rcs._padk(_rig_up(tb, _pt_expand(tb, z), R), tb.b.rig_k)
    S = hx._replace(rig=y_rig)
    if rs.rest_pt.lins:
        corr = engine._hmatvec(rs.rest_pt, v, zero_tangent(v), z)[0]
        S = Tangent(*(a - c for a, c in zip(S, corr)))
    return Tangent(*(h + rs.lam * (d * xv) + rs.lam * xv for h, d, xv in zip(S, rs.diag_r, x)))


def point_blocks(ctx: Context, tb: TileBatch):
    """(K14a on the point grid, K13c on the landmark rows): the batch's
    undamped landmark blocks (L, 9) both ways."""
    g, L = tb.pt, ctx.v.points.shape[0]
    A = rcs._outer(tb.J_pt_po * tb.w_po[None, None, :], tb.J_pt_po).reshape(9, -1)
    tiles = g.scatter(seg.seg_reduce_partials(A.contiguous(), g.local, g.nt, g.ts, g.rb,
                                              g.plan), L)
    b = tb.b
    A_rig = rcs._outer(b.J_pt * b.w[None, None, :], b.J_pt).reshape(9, -1)
    return tiles, rcs.reduce_rows(A_rig, seg.point_rows(b.plan))


def slot_steps(tb: TileBatch, x_l):
    """(K14b, index_select): the landmark step x_l (L, 3) of each real slot
    of the point grid, both ways."""
    g = tb.pt
    rows = seg.seg_gather_from_tiles(g.gather(x_l), g.local, g.nt, g.ts, g.rb)
    point = tb.b.plan.point.to(torch.int64).index_select(0, tb.perm)
    return rows[tb.real], x_l.index_select(0, point)[tb.real]


def random_tangent(v, seed=0):
    """A Tangent shaped like v's, standard normal from `seed`, on v's device."""
    gen = torch.Generator(device=v.points.device).manual_seed(seed)
    return Tangent(*(torch.randn(a.shape, generator=gen, device=a.device, dtype=a.dtype)
                     for a in zero_tangent(v)))


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300))


def check(ctx: Context, x: Tangent, x_l):
    """Relative errors (max |diff| over max |reference|): the composed
    matvec against rcs.matvec, K14a's landmark blocks against K13c's, K14b's
    slot steps against an index_select."""
    y, ref = tile_matvec(ctx, x), rcs.matvec(ctx.rs, ctx.v, x)
    scale = max(float(r.double().abs().max()) for r in ref if r.numel())
    out = {"matvec": max(float((a.double() - r.double()).abs().max()) for a, r in zip(y, ref)
                         if r.numel()) / max(scale, 1e-300)}
    tb = ctx.batches[0]
    out["point_blocks"] = _rel(*point_blocks(ctx, tb))
    out["slot_steps"] = _rel(*slot_steps(tb, x_l))
    return out


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() over reps, CUDA events around each call."""
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


def profile(ctx: Context, x: Tangent, reps=20):
    """Median CUDA-event milliseconds of each component of the composed
    matvec on the first batch, of the K12/K13 route's components, and of the
    two whole matvecs. Needs the problem on a CUDA card."""
    if ctx.v.points.device.type != "cuda":
        raise RuntimeError("profile times kernels on a CUDA card")
    v, rs = ctx.v, ctx.rs
    R, L = v.pose_q.shape[0], v.points.shape[0]
    tb = ctx.batches[0]
    b, g, p = tb.b, tb.rig, tb.pt
    x_r = x.rig[:, :b.rig_k].contiguous()
    xt = g.gather(x_r)
    wu, part = seg.seg_mv_fused(b.J, b.w, xt, g.local, g.nt, g.ts, g.rb, g.plan)
    u_po = rcs.permute_cols(wu, tb.perm).contiguous()
    ppart = seg.seg_mv_scatter(tb.J_pt_po, u_po, p.local, p.nt, p.ts, p.rb, p.plan)
    t = p.scatter(ppart, L)
    z = engine._chol_solve(rs.H_ll_inv, t)
    zt = p.gather(z)
    u2_po = seg.seg_mv_gather(tb.J_pt_po, zt, p.local, p.nt, p.ts, p.rb)
    u2 = (rcs.permute_cols(u2_po, tb.inv) * b.w[None, :]).contiguous()
    A = rcs._outer(tb.J_pt_po * tb.w_po[None, None, :], tb.J_pt_po).reshape(9, -1).contiguous()
    rig_rows, pt_rows = seg.rig_rows(b.plan), seg.point_rows(b.plan)
    ms = {}
    ms["tile: gather_tiles (rig)"] = cuda_ms(lambda: g.gather(x_r), reps)
    ms["tile: K14c mv_fused (rig)"] = cuda_ms(
        lambda: seg.seg_mv_fused(b.J, b.w, xt, g.local, g.nt, g.ts, g.rb, g.plan), reps)
    ms["tile: scatter_partials (rig)"] = cuda_ms(lambda: g.scatter(part, R), reps)
    ms["tile: permute rig->point"] = cuda_ms(
        lambda: rcs.permute_cols(wu, tb.perm).contiguous(), reps)
    ms["tile: K14e mv_scatter (point)"] = cuda_ms(
        lambda: seg.seg_mv_scatter(tb.J_pt_po, u_po, p.local, p.nt, p.ts, p.rb, p.plan), reps)
    ms["tile: scatter_partials (point)"] = cuda_ms(lambda: p.scatter(ppart, L), reps)
    ms["3x3 solve"] = cuda_ms(lambda: engine._chol_solve(rs.H_ll_inv, t), reps)
    ms["tile: gather_tiles (point)"] = cuda_ms(lambda: p.gather(z), reps)
    ms["tile: K14d mv_gather (point)"] = cuda_ms(
        lambda: seg.seg_mv_gather(tb.J_pt_po, zt, p.local, p.nt, p.ts, p.rb), reps)
    ms["tile: permute point->rig, x w"] = cuda_ms(
        lambda: (rcs.permute_cols(u2_po, tb.inv) * b.w[None, :]).contiguous(), reps)
    ms["tile: K14e mv_scatter (rig)"] = cuda_ms(
        lambda: seg.seg_mv_scatter(b.J, u2, g.local, g.nt, g.ts, g.rb, g.plan), reps)
    ms["tile: K14a reduce_partials (point, D 9)"] = cuda_ms(
        lambda: seg.seg_reduce_partials(A, p.local, p.nt, p.ts, p.rb, p.plan), reps)
    ms["tile: K14b gather_from_tiles (point, D 3)"] = cuda_ms(
        lambda: seg.seg_gather_from_tiles(zt, p.local, p.nt, p.ts, p.rb), reps)
    ms["csr: K12 mv_fused_table (rig rows)"] = cuda_ms(
        lambda: seg.seg_mv_fused_table(b.J, b.w, x_r, rig_rows), reps)
    ms["csr: K13a mv_scatter_table (landmark rows)"] = cuda_ms(
        lambda: seg.seg_mv_scatter_table(b.J_pt, wu, pt_rows), reps)
    ms["csr: K13b mv_gather_table (landmark rows)"] = cuda_ms(
        lambda: seg.seg_mv_gather_table(b.J_pt, z, pt_rows), reps)
    ms["csr: K13a mv_scatter_table (rig rows)"] = cuda_ms(
        lambda: seg.seg_mv_scatter_table(b.J, u2, rig_rows), reps)
    ms["visual matvec, tile route"] = cuda_ms(lambda: _visual_tiles(tb, x.rig, rs, R, L), reps)
    ms["visual matvec, csr route (K12 + K13a + solve + K13b + K13a)"] = cuda_ms(
        lambda: _visual_csr(b, x_r, rs), reps)
    ms["matvec, tile route (tile_matvec)"] = cuda_ms(lambda: tile_matvec(ctx, x), reps)
    ms["matvec, solver route (rcs.matvec)"] = cuda_ms(lambda: rcs.matvec(rs, v, x), reps)
    return ms


def per_call(sessions, reps):
    """{kernel: (launches per call, device ms per call)} from profiler
    sessions of `reps` calls each, a session a list of rows (kernel, recorded
    launches, device microseconds in all). The profiler can miss launches,
    on the H100 one launch of a kernel in 20, and once every launch of a
    session, so a kernel's launches per call are the most that one session
    shows (its count over reps, rounded), and its time per call is its mean
    recorded launch, over all sessions, times that."""
    count, total, per = {}, {}, {}
    if not any(sessions):
        raise RuntimeError("the profiler recorded no device time in any session")
    for rows in sessions:
        for key, n, us in rows:
            count[key] = count.get(key, 0) + n
            total[key] = total.get(key, 0.0) + us
            per[key] = max(per.get(key, 0), round(n / reps) or n / reps)
    return {key: (per[key], total[key] / count[key] / 1e3 * per[key]) for key in count}


def device_kernels(averages):
    """[(kernel, recorded launches, device microseconds in all)]: the
    device-side rows (kernels, memsets, copies) of a profile's
    key_averages(). A PyTorch operator's own row carries the device time of
    the kernels it launched as well, which those kernels' rows count
    already."""
    return [(e.key, e.count, e.self_device_time_total) for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


DEVICE_REPS = 20  # calls of fn in one profiler session (device_rows)
SESSIONS = 2  # profiler sessions per device-time reading (device_ms)


def device_rows(fn):
    """One torch.profiler session (CUDA activity only) of DEVICE_REPS calls
    of fn(): [(kernel, recorded launches, device microseconds in all)], what
    the card spends in each kernel without the host's enqueue time that CUDA
    events around one small call include. A first step of as many calls is
    traced and dropped (the schedule's warm-up): on the H100 a session
    missed the launches of its first call or two."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                                 repeat=1)) as prof:
        for _ in range(2):
            for _ in range(DEVICE_REPS):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return device_kernels(prof.key_averages())


def recorded_rows(fn, tries=3):
    """device_rows(fn), taken again while a session recorded no device time
    at all (seen on the H100), up to `tries` sessions; the last one's rows
    (possibly empty) are returned."""
    for _ in range(tries):
        rows = device_rows(fn)
        if rows:
            break
    return rows


def device_ms(fn):
    """Device milliseconds per call of fn(), by kernel name (per_call over
    SESSIONS profiler sessions)."""
    got = per_call([device_rows(fn) for _ in range(SESSIONS)], DEVICE_REPS)
    return {key: ms for key, (_, ms) in got.items()}


def in_turns(fns):
    """Device time of each fn, its profiler sessions (device_rows: the
    card's own time in each kernel and memset, without the host's enqueue
    time) run in turns a, b, ..., b, a and read by per_call over both:
    (device ms per call, device operations per call, {kernel: ms per call})
    of each. A session that recorded no device time at all (seen on the
    H100) is run again, up to three times."""
    sessions = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        sessions[i].append(recorded_rows(fns[i]))
    out = []
    for rows in sessions:
        per = per_call(rows, DEVICE_REPS)
        out.append((sum(ms for _, ms in per.values()), sum(n for n, _ in per.values()),
                    {key: ms for key, (_, ms) in per.items()}))
    return out


def visual_device_ms(ctx: Context, x: Tangent):
    """device_ms of the first batch's visual Schur summand on the tile route
    and on the K12/K13 route."""
    v, rs = ctx.v, ctx.rs
    tb = ctx.batches[0]
    R, L = v.pose_q.shape[0], v.points.shape[0]
    x_r = x.rig[:, :tb.b.rig_k].contiguous()
    return {"tile": device_ms(lambda: _visual_tiles(tb, x.rig, rs, R, L)),
            "csr": device_ms(lambda: _visual_csr(tb.b, x_r, rs))}


def _visual_tiles(tb: TileBatch, x_rig, rs, R, L):
    """The batch's own summand H_rr x - W H_ll^-1 W^T x on the two grids."""
    wu, y = _rig_down(tb, x_rig, R)
    z = engine._chol_solve(rs.H_ll_inv, _pt_reduce(tb, wu, L))
    return y - _rig_up(tb, _pt_expand(tb, z), R)


def _visual_csr(b, x_r, rs):
    """The same summand on the solver's route (K12, K13a, K13b, K13a)."""
    rows = seg.rig_rows(b.plan)
    wu, y = seg.seg_mv_fused_table(b.J, b.w, x_r, rows)
    z = engine._chol_solve(rs.H_ll_inv, rcs._pt_reduce(b, wu))
    return y - seg.seg_mv_scatter_table(b.J, rcs._pt_expand(b, z), rows)


def build_two_grid_problem(device=None, dtype=torch.float32, duration=120.0, num_points=6000,
                           seed=17):
    """The two-grid configuration: a synthetic session whose landmarks are
    re-observed over the whole session (track_lifetime_sec=None), IMU accel
    and gyro bias estimated, blocked (no per-tile landmark window fits)."""
    from .pipeline.builder import BuildOptions, build_synthetic_problem
    from .pipeline.synthetic import SyntheticSession

    s = SyntheticSession(duration=duration, keyframe_hz=10.0, gyro_hz=800.0, accel_hz=800.0,
                         num_points=num_points, seed=seed, pixel_noise=0.3,
                         track_lifetime_sec=None)
    return build_synthetic_problem(
        s, BuildOptions(init_pose_noise=0.005, init_point_noise=0.03, init_vel_noise=0.03,
                        estimate_imu_calib=True,
                        imu_calib_options=dict(accelBias=True, gyroBias=True)),
        device=device, dtype=dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=120.0, help="session seconds")
    ap.add_argument("--points", type=int, default=6000, help="landmarks generated")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--reps", type=int, default=20, help="timed calls per component")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the first card) or cpu (checks only, float64)")
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else torch.device("cuda", 0)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    t0 = time.time()
    problem = build_two_grid_problem(device, dtype, args.duration, args.points, args.seed)
    ctx = setup(problem)
    info = ctx.batches[0].b.info
    print(f"problem: R={problem.variables.pose_q.shape[0]} L={problem.variables.points.shape[0]} "
          f"rig grid nt={info.nt} ts={info.ts} rb={info.rb}, point grid pnt={info.pnt} "
          f"prb={info.prb}, built in {time.time() - t0:.1f} s", flush=True)
    x = random_tangent(problem.variables)
    x_l = torch.randn(problem.variables.points.shape, dtype=dtype, device=device,
                      generator=torch.Generator(device=device).manual_seed(1))
    _kernels.reset_launch_counts()
    errs = check(ctx, x, x_l)
    counts = {k: n for k, n in _kernels.launch_counts().items() if n}
    print("check (relative to max |reference|): " + ", ".join(
        f"{k} {e:.3e}" for k, e in errs.items()) + f" | launches {counts}", flush=True)
    if device.type != "cuda":
        print("times: not measured (no card)")
        return 0
    name = torch.cuda.get_device_name(device)
    for key, ms in profile(ctx, x, args.reps).items():
        print(f"{key:64s} {ms:9.4f} ms")
    for route, kernels in visual_device_ms(ctx, x).items():
        print(f"device time of the visual matvec, {route} route: {sum(kernels.values()):.4f} ms")
        for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
            print(f"  {key[:90]:90s} {ms:9.4f} ms")
    print(f"device: {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
