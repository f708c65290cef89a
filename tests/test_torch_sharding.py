"""The port's distribution layer (parallel/sharding.py and the collectives of
problem/rcs.py and problem/engine.py) against the JAX package, float64 on
the CPU, four gloo ranks.

The problems are tests/test_sharding.py's own, built by the port's builder
and handed to the JAX package as its own tables and batches: `small`
(`_problem()`, 6 s / 60 landmarks), `cal` (the same with the camera
intrinsics and extrinsics estimated: a calibration-coupled single-pass
batch) and `halo` (the 96 s / 2,400-landmark session with 4 s tracks, whose
landmark and rig halo plans engage), each blocked with rb=8, prb=16, ts=64.

One spawn of four gloo ranks (tests/_torch_shard_worker.py, over a
FileStore) runs every sharded case and the single-device references, while
this process runs the JAX side: its plans (host numpy, no compile) and its
single-device blocked step with the identity preconditioner (the JAX
block-Jacobi inverses take about a minute to compile on the CPU). JAX's own
tests/test_sharding.py holds its sharded step equal to its single-device
step, so the JAX sharded step is not compiled again here.

  (a) shard_blocked_problem + point_halo_plan + table_halo_plans: own_lo,
      halo and the logged bail-out reasons equal the JAX package's on
      make_mesh(4);
  (b) the sharded step (identity preconditioner, 40 PCG iterations: at 400
      unpreconditioned iterations the step hangs on the summation order, and
      the two packages' single-device steps already differ by 1e-4 in the
      new cost) against the JAX single-device blocked step;
  (c) the sharded step against the port's single-device step with
      Gauss-Seidel, rig-only, calibration-coupled (its cost and tangents,
      as tests/test_sharding.py holds it) and the halo problem;
  (d) the collective counts of the halo step: no (L, 3) or (R, 12) table
      all-reduced inside the PCG loop, at most 4 L-shaped and 6 R-shaped
      all-reduces outside it;
  (e) 6 LM iterations of optimize() against one device;
  (f) k_resolve (the sub-step re-solve) against one device;
  (g) shard_problem (the generic path) against the generic single-device
      step;
  (h) every rank's outputs bit-equal.

Bounds (tests/test_sharding.py:64-92, 209-234): cost rtol 1e-12 (generic:
1e-10), step rtol 1e-3 / atol 1e-6, new cost rtol 1e-7, optimize's final
cost rtol 1e-5.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import _torch_shard_worker as worker
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from _torch_port_fixtures import F64, jax_active_cfgs

from visual_inertial_bundle_adjustment_tpu.parallel import sharding as jsh
from visual_inertial_bundle_adjustment_tpu.problem import engine as jeng
from visual_inertial_bundle_adjustment_tpu.problem import factors as jfct
from visual_inertial_bundle_adjustment_tpu.problem import optimizer as jopt
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu.problem import structure as jst
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tb
from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession

WORLD = 4
TIMEOUT_S = 600
SMALL = dict(duration=6.0, keyframe_hz=5.0, gyro_hz=200.0, accel_hz=200.0, num_points=60,
             seed=3, pixel_noise=0.2)
SMALL_BUILD = dict(init_pose_noise=0.01, init_point_noise=0.05, init_vel_noise=0.05)
HALO = dict(duration=96.0, keyframe_hz=5.0, gyro_hz=100.0, accel_hz=100.0, num_points=2400,
            seed=13, pixel_noise=0.2, track_lifetime_sec=4.0)
HALO_BUILD = dict(init_pose_noise=0.005, init_point_noise=0.03, init_vel_noise=0.03)
PROBLEMS = {
    "small": (SMALL, SMALL_BUILD),
    "cal": (SMALL, dict(SMALL_BUILD, estimate_cam_intr=True, estimate_cam_extr=True)),
    "halo": (HALO, HALO_BUILD),
}


def _port_problem(name):
    session, build = PROBLEMS[name]
    return tb.build_synthetic_problem(SyntheticSession(**session), tb.BuildOptions(**build),
                                      device="cpu", dtype=F64)


def _jax_problem(p):
    """The port's problem as a JAX Problem (its own tables and batches)."""
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    out = jopt.Problem(jst.VariableTables(*(j(a) for a in p.variables)),
                       jst.Masks(*(j(a) for a in p.masks)))
    for cfg, data in zip(p.cfgs, p.datas):
        out.add_batch(jfct.BatchCfg(**{f: getattr(cfg, f) for f in (
            "kind", "loss", "camera_kind", "label", "image_height")}),
            {k: j(a) for k, a in data.items()})
    return out


def _jax_plans(p):
    jp = _jax_problem(p)
    logs = []
    jsh.shard_blocked_problem(jp, jsh.make_mesh(WORLD), **worker.BLOCKS)
    pt = jsh.point_halo_plan(jp, WORLD, log=logs.append)
    t = jsh.table_halo_plans(jp, WORLD, log=logs.append)
    return dict(pt=None if pt is None else (np.asarray(pt.own_lo), pt.halo),
                bail=jp.halo_bailout, t={g: (np.asarray(q.own_lo), q.halo) for g, q in t.items()},
                logs=logs, nt=[c.block_info.nt for c in jp.cfgs if c.block_info])


def _jax_identity_step(p):
    """The JAX package's single-device blocked step with the identity
    preconditioner (test_sharding's _one_step damping and tolerance, 40 PCG
    iterations: worker.IDENTITY_ITERS): new cost from the linearization at
    the new state (the same factors are valid at both)."""
    jp = _jax_problem(p)
    jrcs.finalize_blocks(jp, **worker.BLOCKS)
    cfgs = jax_active_cfgs(jp)
    datas, v, m = tuple(jp.datas), jp.variables, jp.masks
    lin = jax.jit(lambda d, vv, mm: jeng.linearize(cfgs, d, vv, mm))

    def solve(d, lg, vv, mm):
        asm = jrcs.assemble(cfgs, d, lg, vv, mm)
        x_r, x_l, model, _, _, _, _ = jrcs.solve_assembled(
            asm, vv, mm, worker.LAM, worker.IDENTITY_ITERS, worker.TOL, "identity")
        return x_r, x_l, model, jst.retract(vv, jst.t_scale(x_r, -1.0), -x_l, mm)

    lg = lin(datas, v, m)
    x_r, x_l, model, v_new = jax.jit(solve)(datas, lg, v, m)
    new = lin(datas, v_new, m)
    assert all(np.array_equal(a, b) for a, b in zip(lg.valid0, new.valid0))
    return dict(cost=float(lg.cost), n_inv=int(lg.num_invalid), n_opt=int(lg.num_optional),
                x={f: np.asarray(getattr(x_r, f)) for f in x_r._fields}, xl=np.asarray(x_l),
                model=float(model), new_cost=float(new.cost))


@pytest.fixture(scope="module")
def runs():
    """(rank results, JAX side): the four ranks run while this process runs
    the JAX side."""
    workdir = tempfile.mkdtemp(prefix="viba_shard_")
    try:
        ports = {name: _port_problem(name) for name in PROBLEMS}
        for name, p in ports.items():
            torch.save(p, os.path.join(workdir, name + ".pt"))
        ctx = mp.start_processes(worker.main, args=(WORLD, workdir), nprocs=WORLD, join=False,
                                 start_method="spawn")
        try:
            jax_side = {f"plans/{name}": _jax_plans(p) for name, p in ports.items()}
            jax_side["step/small/identity"] = _jax_identity_step(ports["small"])
            deadline = time.time() + TIMEOUT_S
            while not ctx.join(timeout=5):
                if time.time() > deadline:
                    raise TimeoutError(f"the ranks did not finish in {TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join(10)
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(WORLD)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    single = {}
    for r in ranks:
        single.update({k[len("single/"):]: v for k, v in r.items() if k.startswith("single/")})
    return ranks, single, jax_side


def _same_step(got, want, cost_rtol=1e-12):
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=cost_rtol)
    assert got["n_inv"] == want["n_inv"] and got["n_opt"] == want["n_opt"]
    for f in want["x"]:
        np.testing.assert_allclose(got["x"][f], want["x"][f], rtol=1e-3, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got["xl"], want["xl"], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got["model"], want["model"], rtol=1e-8)
    np.testing.assert_allclose(got["new_cost"], want["new_cost"], rtol=1e-7)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_plans_match_jax(runs, name):
    ranks, _, jax_side = runs
    got, want = ranks[0][f"plans/{name}"], jax_side[f"plans/{name}"]
    assert (got["pt"] is None) == (want["pt"] is None)
    if want["pt"] is not None:
        np.testing.assert_array_equal(got["pt"][0], want["pt"][0])
        assert got["pt"][1] == want["pt"][1]
    assert got["bail"] == want["bail"]
    assert sorted(got["t"]) == sorted(want["t"])
    for g, (own, halo) in want["t"].items():
        np.testing.assert_array_equal(got["t"][g][0], own)
        assert got["t"][g][1] == halo
    assert got["logs"] == want["logs"]
    # each rank holds its span of the padded tile grid
    nt = [i.nt for i in got["cfgs"] if i is not None]
    assert [n * WORLD for n in nt] == want["nt"]
    assert sum(r[f"plans/{name}"]["slots"][0] for r in ranks) > 0
    if name == "halo":
        assert got["pt"] is not None and "rig" in got["t"]


def test_sharded_step_matches_jax_single_device(runs):
    ranks, _, jax_side = runs
    _same_step(ranks[0]["step/small/identity"], jax_side["step/small/identity"])


@pytest.mark.parametrize("name", ["small", "cal", "halo"])
def test_sharded_step_matches_single_device(runs, name):
    ranks, single, _ = runs
    got, want = ranks[0][f"step/{name}"], single[f"step/{name}"]
    if name != "cal":
        _same_step(got, want)
        return
    # tests/test_sharding.py's calibration-coupled case holds the cost and
    # these tangents: past its convergence the 400-iteration PCG carries the
    # summation order into the landmark step (at 40 iterations the sharded
    # and single-device steps of this problem agree to 1e-12)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-12)
    for f in ("rig", "cam_intr", "cam_extr", "gravity"):
        np.testing.assert_allclose(got["x"][f], want["x"][f], rtol=1e-3, atol=1e-6, err_msg=f)


def test_pcg_loop_has_no_table_all_reduce(runs):
    ranks, _, jax_side = runs
    L = int(np.asarray(jax_side["plans/halo"]["pt"][0])[-1])
    R = int(np.asarray(jax_side["plans/halo"]["t"]["rig"][0])[-1])
    pt_halo = ranks[0]["plans/halo"]["pt"][1]
    assert 2 * pt_halo < L // WORLD
    for r in ranks:
        counts = {tuple(k.split("|", 2)): v for k, v in r["counts/halo"].items()}
        l_shapes = (f"({L}, 3)", f"({L}, 3, 3)")
        in_loop = [k for k in counts if k[0] == "pcg" and k[1] == "all_reduce"
                   and (k[2] in l_shapes or k[2].startswith(f"({R}, 12"))]
        assert not in_loop, in_loop
        assert any(k[0] == "pcg" and k[1] == "halo" for k in counts)
        outside = {k: v[0] for k, v in counts.items() if k[0] == "step" and k[1] == "all_reduce"}
        assert sum(n for k, n in outside.items() if k[2] in l_shapes) <= 4, outside
        assert sum(n for k, n in outside.items() if k[2].startswith(f"({R}, 12")) <= 6, outside


def test_sharded_optimize_matches_single_device(runs):
    ranks, single, _ = runs
    got, want = ranks[0]["optimize/small"], single["optimize/small"]
    assert got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["final_cost"], want["final_cost"], rtol=1e-5)
    assert got["final_cost"] < ranks[0]["step/small"]["cost"]


def test_sharded_resolve_matches_single_device(runs):
    ranks, single, _ = runs
    got, want = ranks[0]["resolve/small"], single["resolve/small"]
    for f, a in want["s_r"].items():
        np.testing.assert_allclose(got["s_r"][f], a, rtol=1e-3, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got["s_l"], want["s_l"], rtol=1e-3, atol=1e-6)


def test_generic_shard_problem_matches_single_device(runs):
    ranks, single, _ = runs
    _same_step(ranks[0]["step/generic"], single["step/generic"], cost_rtol=1e-10)


def _arrays(x):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _arrays(x[k])
    elif isinstance(x, (np.ndarray, float, int)):
        yield np.asarray(x)


def test_ranks_bit_equal(runs):
    ranks, _, _ = runs
    for key in ("step/small/identity", "step/small", "resolve/small", "step/cal", "step/halo",
                "optimize/small", "step/generic"):
        for r in ranks[1:]:
            for a, b in zip(_arrays(ranks[0][key]), _arrays(r[key]), strict=True):
                np.testing.assert_array_equal(a, b, err_msg=key)
