"""PyTorch port vs the JAX package on the capacity configuration, cut to a
CPU size: bench.py's build_capacity_problem settings (10 Hz, 150 Hz IMU,
12 s tracks, IMU bias estimated, seed 31) over 60 s and 1,500 points
instead of 1,800 s and 60,000, in float64, blocked with
finalize_blocks(ts=64). The two builds give the same tables, the blocking
the same BlockInfo and slot order on the rig-only single-pass route (K4-K6
on the card), and one LM iteration the same cost. chip_smoke.py's capacity
and PCG-switch settings are held equal to bench.py's, both files read as
syntax trees (neither runs)."""

import ast
import functools
import pathlib

import numpy as np
import pytest
import torch
from _torch_port_fixtures import rel

from visual_inertial_bundle_adjustment_tpu.pipeline import builder as jb
from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic import SyntheticSession as JSession
from visual_inertial_bundle_adjustment_tpu.problem import optimizer as jopt
from visual_inertial_bundle_adjustment_tpu.problem import rcs as jrcs
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import builder as tb
from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession as TSession
from visual_inertial_bundle_adjustment_tpu_torch.problem import optimizer as topt
from visual_inertial_bundle_adjustment_tpu_torch.problem import rcs as trcs

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-9
BLOCKS = dict(ts=64)


def _value(node):
    """A literal, or a dict(...) call of literals."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "dict":
        return {k.arg: _value(k.value) for k in node.keywords}
    return ast.literal_eval(node)


@functools.lru_cache(maxsize=None)
def _tree(name):
    return ast.parse((ROOT / name).read_text())


def _constants(name):
    """The module-level NAME = <literal> assignments of a script."""
    out = {}
    for node in _tree(name).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = _value(node.value)
            except ValueError:
                pass
    return out


def _calls(name, function, callee):
    """The literal keyword arguments of every call of `callee` (a name or an
    attribute's last part) inside the script's top-level `function`."""
    fn, = [n for n in _tree(name).body if isinstance(n, ast.FunctionDef) and n.name == function]
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if (f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)) == callee:
                kw = {}
                for k in node.keywords:
                    try:
                        kw[k.arg] = _value(k.value)
                    except ValueError:
                        pass
                out.append(kw)
    return out


def _capacity_settings():
    """bench.py's capacity session and build options (its literal
    keywords), and chip_smoke.py's constants."""
    bench = _constants("bench.py")
    session, = _calls("bench.py", "build_capacity_problem", "SyntheticSession")
    build, = _calls("bench.py", "build_capacity_problem", "BuildOptions")
    return bench, session, build, _constants("chip_smoke.py")


@pytest.mark.parametrize("name", ["CAP_DURATION", "CAP_KEYFRAME_HZ", "CAP_POINTS",
                                  "CAP_TIMED_ITERS", "PCGSW_DURATION", "PCGSW_KEYFRAME_HZ",
                                  "PCGSW_POINTS"])
def test_chip_smoke_capacity_constants_equal_bench(name):
    bench, _, _, smoke = _capacity_settings()
    assert smoke[name] == bench[name]


def test_chip_smoke_capacity_session_and_covariance_equal_bench():
    _, session, build, smoke = _capacity_settings()
    assert smoke["CAP_SESSION"] == session
    assert smoke["CAP_BUILD"] == build
    prep, = _calls("bench.py", "run_capacity_covariance", "prepare_system")
    warm, timed = _calls("bench.py", "run_capacity_covariance", "solve_columns")
    assert prep == {"lam": smoke["CAP_COV_LAM"]}
    assert warm == timed == {"pcg_iters": smoke["CAP_COV_PCG_ITERATIONS"],
                             "pcg_tol": smoke["CAP_COV_PCG_TOL"]}
    assert _constants("bench.py")["COV_COLS"] == 12
    # the PCG-switch configuration crosses pick_solver's switch, capacity not
    assert smoke["PCGSW_DURATION"] * smoke["PCGSW_KEYFRAME_HZ"] >= topt.PCG_NUM_RIGS_THRESHOLD
    assert smoke["CAP_DURATION"] * smoke["CAP_KEYFRAME_HZ"] < topt.PCG_NUM_RIGS_THRESHOLD


def _small_session():
    _, session, _, smoke = _capacity_settings()
    return dict(session, duration=60.0, keyframe_hz=smoke["CAP_KEYFRAME_HZ"], num_points=1500)


@functools.lru_cache(maxsize=None)
def _jax_problems():
    """(unblocked, blocked) JAX problems of the small capacity session."""
    _, _, build, _ = _capacity_settings()
    s = JSession(**_small_session())
    plain = jb.build_synthetic_problem(s, jb.BuildOptions(**build))
    blocked = jb.build_synthetic_problem(s, jb.BuildOptions(**build))
    jrcs.finalize_blocks(blocked, **BLOCKS)
    return plain, blocked


def _port_problem(blocked):
    _, _, build, _ = _capacity_settings()
    p = tb.build_synthetic_problem(TSession(**_small_session()), tb.BuildOptions(**build),
                                   device="cpu")
    return trcs.finalize_blocks(p, **BLOCKS) if blocked else p


def test_capacity_build_matches_jax():
    pj, _ = _jax_problems()
    pt = _port_problem(False)
    assert pt.variables.pose_q.shape[0] == 600
    for f in pj.variables._fields:
        assert rel(getattr(pt.variables, f).numpy(), getattr(pj.variables, f)) < TOL, f
    for f in pj.masks._fields:
        np.testing.assert_array_equal(getattr(pt.masks, f).numpy(), np.asarray(getattr(pj.masks, f)))
    assert [c.kind for c in pt.cfgs] == [c.kind for c in pj.cfgs] == ["visual", "inertial"]
    for cj, ct, dj, dt in zip(pj.cfgs, pt.cfgs, pj.datas, pt.datas):
        assert set(dt) == set(dj), set(dt) ^ set(dj)
        for k in dj:
            assert rel(dt[k].numpy(), dj[k]) < TOL, (cj.kind, k)


def test_capacity_blocking_matches_jax_on_the_single_pass_route():
    _, pj = _jax_problems()
    pt = _port_problem(True)
    (bj, dj), = [(c.block_info, d) for c, d in zip(pj.cfgs, pj.datas) if c.block_info]
    (bt, dt), = [(c.block_info, d) for c, d in zip(pt.cfgs, pt.datas) if c.block_info]
    for f in ("rb", "nt", "ts", "prb", "pnt", "pts", "prb2", "nhg"):
        assert getattr(bt, f) == getattr(bj, f), f
    assert bt.prb2 > 0 and bt.nhg > 0  # per-tile landmark windows: single-pass
    shared = set(dt) & set(dj)
    assert {"rig", "point", "obs_uv", "_pad", "_rb_local", "_rb_base", "_rg_pt_local",
            "_rg_hib"} <= shared
    for k in shared:
        assert rel(dt[k].numpy(), dj[k]) < TOL, k
    # the port's route at the built state: the rig-only single-pass kernels
    ks = pt._build()
    lg = ks[0](tuple(pt.datas), pt.variables, pt.masks, None)
    (b, _), = trcs._vis_batches(pt.active_cfgs, tuple(pt.datas), lg)
    assert trcs._rig_only_fast(b)


def test_capacity_lm_iteration_matches_jax():
    """One LM iteration through optimize() at chip_smoke's capacity settings
    (40 PCG iterations) but with the identity preconditioner: the same cost
    before and after within test_torch_slice's bound. The JAX package's
    block-Jacobi inverses take ~100 s to compile on the CPU with a cold
    cache; the Gauss-Seidel route is held against the JAX package on the
    tiny problem (test_torch_slice) and against the plain versions on the
    card at the full size (chip_smoke's cap and pcg_switch)."""
    _, pj = _jax_problems()
    settings = dict(max_iterations=1, direct_mode=False, pcg_max_iterations=40,
                    preconditioner="identity")
    seq_j, seq_t = [], []
    saved = pj.variables
    try:
        sj = jopt.optimize(pj, jopt.LMSettings(
            **settings, iteration_callback=lambda d: seq_j.append((d["prev_cost"], d["cost"]))))
    finally:
        pj.variables = saved
    st = topt.optimize(_port_problem(True), topt.LMSettings(
        **settings, iteration_callback=lambda d: seq_t.append((d["prev_cost"], d["cost"]))))
    assert len(seq_t) == len(seq_j) == 1
    assert rel(np.asarray(seq_t), np.asarray(seq_j)) < 1e-6
    assert abs(st.final_cost - sj.final_cost) <= 1e-6 * abs(sj.final_cost)
    assert st.final_cost < st.initial_cost
    assert torch.isfinite(torch.tensor(st.final_cost))
