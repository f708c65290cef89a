"""The port's application modules against the JAX package, in float64 on the
CPU: what the CLI runs around the optimizer.

On a tiny session directory (3 s, 40 landmarks, two IMUs, a rolling-shutter
camera), built by both packages' adapters and not blocked, the port holding
the JAX problem's state (interop):
  - recompute_preintegrations at a moved calibration              atol 1e-9
  - histograms.collect, debug_nonlinearities, the calibration
    evaluation, the Monitor's JSONL records                       1e-9 rel
  - verify_jacobians: the same verdicts, worst errors within 1e-6
  - the writers and save_online_calib_states: byte-equal files
On the port's fixtures (tests/_torch_port_fixtures.py):
  - refine_points, through the generic route (AD of the landmark
    columns) and the fused one (the blocked batch's linearizer, K13c's sums),
    against the JAX package's                                     1e-7 rel
  - the padded slots of a blocked batch: the port's histograms and residual
    percentiles count the real slots only, the JAX package's do not
  - optimize_in_background: one monitor record per iteration
And the C++ CSV parser against the numpy parser on both golden inputs, and
its refusal of malformed rows.
"""

import functools
import json
import pathlib
import re
import tempfile

import numpy as np
import pytest
import torch
from _torch_port_fixtures import jax_problem, port_problem, rel, to_numpy

from visual_inertial_bundle_adjustment_tpu_torch import interop

F64 = torch.float64
DATA = pathlib.Path(__file__).parent / "data"


@functools.lru_cache(maxsize=None)
def _session_dir():
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic_io import (
        write_session_dir)

    path = pathlib.Path(tempfile.mkdtemp(prefix="viba_app_"))
    write_session_dir(SyntheticSession(duration=3.0, keyframe_hz=5.0, gyro_hz=200.0,
                                       accel_hz=200.0, num_points=40, num_cameras=1, seed=4,
                                       pixel_noise=0.3), path, num_imus=2,
                      readout_time_sec=0.03, seed=8)
    return path


def _built():
    """(JAX adapter, port adapter holding the JAX problem's state), fresh."""
    from visual_inertial_bundle_adjustment_tpu.pipeline import adapter as jad
    from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as jsd
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import adapter as tad
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd

    opts = dict(estimate_readout=True, estimate_cam_time_offset=True)
    ja = jad.SessionAdapter(jsd.load_session(_session_dir()), jad.AdapterOptions(**opts),
                            log=None)
    jp = ja.build()
    ta = tad.SessionAdapter(tsd.load_session(_session_dir()), tad.AdapterOptions(**opts),
                            log=None, device="cpu", dtype=F64)
    tp = ta.build()
    assert [c.label for c in tp.cfgs] == [c.label for c in jp.cfgs]
    assert all(c.block_info is None for c in tp.cfgs)
    state = interop.problem_from_numpy(**to_numpy(jp), device="cpu", dtype=F64)
    tp.variables = state.variables
    return ja, ta


@functools.lru_cache(maxsize=None)
def _built_cached():
    return _built()


def _logged(fn, *args, **kw):
    lines = []
    out = fn(*args, log=lines.append, **kw)
    return out, lines


def test_recompute_preintegrations_matches():
    ja, ta = _built()
    delta = np.zeros(23)
    delta[0:3], delta[3:6] = 2e-3, -0.03  # gyro and accel biases
    ja.problem.variables = ja.problem.variables._replace(
        imu_calib=ja.problem.variables.imu_calib + delta)
    ta.problem.variables = ta.problem.variables._replace(
        imu_calib=ta.problem.variables.imu_calib + torch.from_numpy(delta))
    before = {c.label: d["preint_dv"].clone() for c, d in zip(ta.problem.cfgs, ta.problem.datas)
              if c.kind.startswith("inertial")}
    ja.recompute_preintegrations()
    ta.recompute_preintegrations()
    n = 0
    for (jc, jd), (tc, td) in zip(zip(ja.problem.cfgs, ja.problem.datas),
                                  zip(ta.problem.cfgs, ta.problem.datas)):
        if tc.kind not in ("inertial", "inertial_secondary"):
            continue
        assert float((td["preint_dv"] - before[tc.label]).abs().max()) > 1e-4  # it moved
        for k in ("preint_q", "preint_dv", "preint_dp", "preint_dt", "preint_J", "calib_eval",
                  "sqrt_info"):
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), atol=1e-9,
                                       err_msg=f"{tc.label}/{k}")
        n += 1
    assert n == 2


@pytest.mark.parametrize("route", ["generic", "fused"])
def test_refine_points_matches(route):
    """The port's refinement on the tiny blocked problem against the JAX
    package's (its generic AD route): the port's generic route (the problem
    not built), and its fused one (after Problem._build: the blocked batch's
    K1 linearizer, its residual-only mode for the costs; CPU tensors take
    the plain versions)."""
    from visual_inertial_bundle_adjustment_tpu.problem import point_refinement as jpr
    from visual_inertial_bundle_adjustment_tpu_torch.problem import factors as fct
    from visual_inertial_bundle_adjustment_tpu_torch.problem import point_refinement as tpr

    jp = jax_problem()
    v0 = jp.variables
    try:
        j_pts, _ = jpr.refine_points(jp)
    finally:
        jp.variables = v0
    tp = port_problem()
    if route == "fused":
        tp._build()
        assert any(fct.fused_linearizer(c) for c in tp.active_cfgs)
    pts0 = tp.variables.points.clone()
    (t_pts, _), lines = _logged(tpr.refine_points, tp)
    j_step = np.asarray(j_pts) - np.asarray(v0.points)
    # the reference moves the points by far more than the tolerance below
    assert np.abs(j_step).max() > 1e-3 * np.abs(np.asarray(v0.points)).max()
    assert rel(t_pts - pts0, j_step) <= 1e-6  # the same step
    assert rel(t_pts, j_pts) <= 1e-7
    c0, c1 = map(float, re.findall(r"cost (\S+) -> (\S+)", lines[0])[0])
    assert c1 < c0


def test_histograms_match():
    from visual_inertial_bundle_adjustment_tpu.problem import histograms as jh
    from visual_inertial_bundle_adjustment_tpu_torch.problem import histograms as th

    ja, ta = _built_cached()
    js, ts = jh.collect(ja.problem), th.collect(ta.problem)
    assert list(ts) == list(js)
    for name in js:
        np.testing.assert_allclose(ts[name].values, js[name].values, rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    (_, lines) = _logged(th.show_histograms, ta.problem)
    assert len(lines) == len(ta.problem.cfgs)


# the batches the JAX package's verify and debug run on here: its
# verify_jacobians calls the local function eagerly per sampled row and
# dimension (~0.1 s a call on the CPU), and its solve compiles per batch kind
SUBSET = ("rs_visual_cam0", "inertial", "factory_cam_intr", "omega_prior")


def _subset(problem, problem_cls):
    sub = problem_cls(problem.variables, problem.masks)
    for cfg, data in zip(problem.cfgs, problem.datas):
        if cfg.label in SUBSET:
            sub.add_batch(cfg, data)
    assert len(sub.cfgs) == len(SUBSET)
    return sub


def _subsets():
    from visual_inertial_bundle_adjustment_tpu.problem.optimizer import Problem as JProblem
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import Problem

    ja, ta = _built_cached()
    return _subset(ja.problem, JProblem), _subset(ta.problem, Problem)


def test_verify_jacobians_matches():
    """The same verdicts and worst errors on one sampled factor of the
    subset's batches; the port's check passes on every batch (four samples)."""
    from visual_inertial_bundle_adjustment_tpu.problem import verify as jv
    from visual_inertial_bundle_adjustment_tpu_torch.problem import verify as tv

    jp, tp = _subsets()
    (j_ok, j_lines) = _logged(jv.verify_jacobians, jp, sample=1)
    (t_ok, t_lines) = _logged(tv.verify_jacobians, tp, sample=1)
    assert t_ok and j_ok
    pat = r"verifyJacobians\[(\S+)\]: worst col-rel err (\S+) (\S+)"
    jr, tr = ([re.match(pat, ln).groups() for ln in lines] for lines in (j_lines, t_lines))
    assert [r[0] for r in tr] == [r[0] for r in jr]
    for (_, te, ts), (_, je, js) in zip(tr, jr):
        assert ts == js == "OK" and abs(float(te) - float(je)) <= 1e-6
    (ok, lines) = _logged(tv.verify_jacobians, _built_cached()[1].problem, sample=4)
    assert ok and len(lines) == len(_built_cached()[1].problem.cfgs)


def test_debug_nonlinearities_matches():
    from visual_inertial_bundle_adjustment_tpu.problem import verify as jv
    from visual_inertial_bundle_adjustment_tpu_torch.problem import verify as tv

    jp, tp = _subsets()
    (j_rows, j_lines), (t_rows, t_lines) = (_logged(jv.debug_nonlinearities, jp),
                                            _logged(tv.debug_nonlinearities, tp))
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows]
    for (_, tc, td), (_, jc, jd) in zip(t_rows, j_rows):
        assert abs(tc - jc) <= 1e-9 * max(abs(jc), 1.0)
        assert abs(td - jd) <= 1e-6 * max(abs(jc), 1.0)
    model = [float(ln.split(":")[-1]) for ln in (t_lines[-1], j_lines[-1])]
    assert abs(model[0] - model[1]) <= 1e-6 * abs(model[1])


def test_compare_calibration_vs_factory_matches():
    from visual_inertial_bundle_adjustment_tpu.pipeline import eval_calibration as je
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import eval_calibration as te

    ja, ta = _built_cached()
    (js, _), (ts, t_lines) = (_logged(je.compare_calibration_vs_factory, ja),
                              _logged(te.compare_calibration_vs_factory, ta))
    assert list(ts) == list(js) and len(t_lines) == len(ts)
    assert any("proj_offset" in name for name in ts)
    for name in js:
        np.testing.assert_allclose(ts[name].values, js[name].values, rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def test_monitor_records_match(tmp_path):
    """The same iteration info through both Monitors on the same problem
    state: the same JSONL records (snapshots on iterations 1 and 3)."""
    from visual_inertial_bundle_adjustment_tpu.utils import monitoring as jm
    from visual_inertial_bundle_adjustment_tpu_torch.utils import monitoring as tm

    ja, ta = _built_cached()
    recs = {}
    for name, mod, ad in (("jax", jm, ja), ("port", tm, ta)):
        mon = mod.Monitor(snapshot_every=2, jsonl_path=str(tmp_path / f"{name}.jsonl"),
                          html_path=str(tmp_path / f"{name}.html"), html_every=2)
        mon.set_calib_layout(ad.num_cams, ad.num_imus,
                             window_ts_sec=(ad.window_mid_ts - ad.rig_ts_us[0]) / 1e6)
        mon.set_problem_stats(rigs=ad.R, windows=ad.num_windows)
        cb = mon.make_callback(ad.problem)
        for it in (1, 2, 3):
            cb(dict(iteration=it, cost=10.0 / it, prev_cost=11.0 / it, new_cost=10.0 / it,
                    damping=1e-4 * it, accepted=it != 2, model_cost_reduction=0.5,
                    applied_step_factor=1.0, pcg_iters=7, pcg_rel_residual=1e-3,
                    grad_norm=2.0, step_norm=0.1, num_failing=0, num_failing_prev=1,
                    num_optional_total=100, iter_time_sec=0.0))
        mon.finish(None)
        recs[name] = [json.loads(ln) for ln in open(tmp_path / f"{name}.jsonl")]
        assert (tmp_path / f"{name}.html").stat().st_size > 10_000
    assert len(recs["port"]) == len(recs["jax"]) == 3
    for a, e in zip(recs["port"], recs["jax"]):
        assert a.keys() == e.keys()
        for key in e:
            if key in ("trajectory", "points") and e[key] is not None:
                np.testing.assert_allclose(a[key], e[key], atol=1e-4, err_msg=key)
            elif key in ("residual_percentiles", "calib_curves"):
                assert a[key].keys() == e[key].keys()
                for k2 in e[key]:
                    ev = e[key][k2]
                    av = a[key][k2]
                    if isinstance(ev, dict):
                        assert av.keys() == ev.keys()
                        av, ev = list(av.values()), list(ev.values())
                    np.testing.assert_allclose(av, ev, rtol=1e-9, atol=1e-12, err_msg=k2)
            else:
                assert a[key] == e[key], key
    assert recs["port"][0]["residual_percentiles"] and recs["port"][0]["calib_curves"]


def test_writers_byte_equal(tmp_path):
    from visual_inertial_bundle_adjustment_tpu.pipeline import cli as jcli
    from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as jsd
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import cli as tcli
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd

    ja, ta = _built_cached()
    sd = tsd.load_session(_session_dir())
    rng = np.random.default_rng(5)
    R = len(sd.traj_timestamp_us)
    q = rng.normal(size=(R, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    arrays = (q, rng.normal(size=(R, 3)), rng.normal(size=(R, 3)), rng.normal(size=(R, 3)),
              np.array([0.1, -0.2, -9.8]))
    for fn in ("save_close_loop_trajectory", "save_open_loop_trajectory"):
        getattr(jsd, fn)(tmp_path / f"jax_{fn}", sd, *arrays)
        getattr(tsd, fn)(tmp_path / f"port_{fn}", sd, *arrays)
        assert (tmp_path / f"port_{fn}").read_bytes() == (tmp_path / f"jax_{fn}").read_bytes()
    jsd.save_online_calibration(tmp_path / "jax_online", sd.online)
    tsd.save_online_calibration(tmp_path / "port_online", sd.online)
    assert (tmp_path / "port_online").read_bytes() == (tmp_path / "jax_online").read_bytes()
    # the CLI's per-rig calibration records from the adapters' (equal) tables
    jcli.save_online_calib_states(tmp_path / "jax_states", ja)
    tcli.save_online_calib_states(tmp_path / "port_states", ta)
    assert (tmp_path / "port_states").read_bytes() == (tmp_path / "jax_states").read_bytes()
    assert len((tmp_path / "port_states").read_text().splitlines()) == ta.R


@pytest.mark.parametrize("name", ["golden_session", "golden_session_full"])
def test_native_parser_matches_numpy(name):
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import native
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd

    base = DATA / name / "input"
    for a, b in zip(tsd._parse_observations(base / "session_observations.csv"),
                    tsd.load_observations_csv(base / "session_observations.csv"), strict=True):
        np.testing.assert_array_equal(a, b)
    for label in ("imu-left", "imu-right"):
        for a, b in zip(native.parse_imu_csv(base / f"imu_samples_{label}.csv"),
                        tsd.load_imu_csv(base / f"imu_samples_{label}.csv"), strict=True):
            np.testing.assert_array_equal(a, b)


_OBS_HEAD = ("point_id,capture_timestamp_ns,camera_index,projection_base_res_x,"
             "projection_base_res_y,sqrt_h_base_res_00,sqrt_h_base_res_01,"
             "sqrt_h_base_res_10,sqrt_h_base_res_11\n")
_IMU_HEAD = "#timestamp [ns],temperature [degC],w_x,w_y,w_z,a_x,a_y,a_z\n"
_ROWS = {  # kind -> (header, a good row, {defect: a bad row})
    "obs": (_OBS_HEAD, "2,100,0,432.5,418.25,0.7,0.0,0.0,0.7\n",
            {"short": "1,100,0,296.25,434.5,0.7,0.0,0.0\n",
             "text": "1,100,0,abc,434.5,0.7,0.0,0.0,0.7\n",
             "extra": "1,100,0,296.25,434.5,0.7,0.0,0.0,0.7,5\n",
             "trailing comma": "1,100,0,296.25,434.5,0.7,0.0,0.0,0.7,\n"}),
    "imu": (_IMU_HEAD, "1250000,0.0,0.5,1.25,-1.0,0.5,-0.25,-19.0\n",
            {"short": "0,0.0,0.5,1.25,-1.0,0.5,-0.25\n",
             "text": "0,0.0,0.5,nope,-1.0,0.5,-0.25,-19.0\n",
             "extra": "0,0.0,0.5,1.25,-1.0,0.5,-0.25,-19.0,7\n",
             "trailing comma": "0,0.0,0.5,1.25,-1.0,0.5,-0.25,-19.0,\n"}),
}


@pytest.mark.parametrize("defect", ["short", "text", "extra", "trailing comma"])
@pytest.mark.parametrize("kind", ["obs", "imu"])
def test_native_parser_rejects_malformed_rows(kind, defect, tmp_path):
    """A row with a field missing, a text field, a field too many or a
    trailing comma, followed by a good row, raises (as np.loadtxt does); the
    good rows alone parse."""
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import native

    parse = native.parse_obs_csv if kind == "obs" else native.parse_imu_csv
    head, good, bad = _ROWS[kind]
    ok_path, bad_path = tmp_path / "good.csv", tmp_path / "bad.csv"
    ok_path.write_text(head + good + good.replace("\n", "\r\n"))
    bad_path.write_text(head + bad[defect] + good)
    first = parse(ok_path)
    assert first[0].tolist() == ([2, 2] if kind == "obs" else [1250000, 1250000])
    with pytest.raises(ValueError, match="malformed"):
        parse(bad_path)


def test_padded_slots_count_in_the_reference_only():
    """On a blocked batch (finalize_blocks(ts=64)) the padded slots are
    'valid' in both packages. The JAX package's histograms count them as
    observations and its residual percentiles keep only them; the port's
    count the real slots only (a stated divergence)."""
    from visual_inertial_bundle_adjustment_tpu.problem import histograms as jh
    from visual_inertial_bundle_adjustment_tpu.utils import monitoring as jm
    from visual_inertial_bundle_adjustment_tpu_torch.problem import histograms as th
    from visual_inertial_bundle_adjustment_tpu_torch.utils import monitoring as tm

    jp, tp = jax_problem(), port_problem()
    (vi, cfg), = [(i, c) for i, c in enumerate(tp.cfgs) if c.block_info is not None]
    pad = tp.datas[vi]["_pad"].numpy()
    n_real, n_pad = int((pad < 0.5).sum()), int((pad > 0.5).sum())
    assert n_pad > 0
    key = f"{cfg.label or cfg.kind}/px"
    j_px, t_px = jh.collect(jp)[key].values, th.collect(tp)[key].values
    assert len(t_px) == n_real  # every real slot is valid here
    assert len(j_px) == n_real + n_pad
    np.testing.assert_allclose(np.sort(t_px), np.sort(j_px)[n_pad:], rtol=1e-9)
    label = cfg.label or cfg.kind
    j_pc, t_pc = jm.residual_percentiles(jp)[label], tm.residual_percentiles(tp)[label]
    assert j_pc["p99"] == 0.0  # the padded slots' residuals alone
    assert t_pc["p50"] == pytest.approx(float(np.percentile(t_px, 50)), rel=1e-12)
    assert t_pc["p50"] > 0.1


def test_optimize_in_background_publishes_every_iteration():
    """The GUI's worker-thread pattern: optimize() in a thread, one record
    per iteration, the summary at the end (JAX tests/test_monitoring.py)."""
    from visual_inertial_bundle_adjustment_tpu_torch.problem.optimizer import LMSettings
    from visual_inertial_bundle_adjustment_tpu_torch.utils import monitoring as tm

    problem = port_problem()
    mon = tm.Monitor(snapshot_every=1)
    thread = tm.optimize_in_background(problem, LMSettings(max_iterations=2), mon)
    thread.join(timeout=300)
    assert not thread.is_alive() and mon.done
    assert len(mon.iterations) == mon.summary.num_iterations == 2
    assert mon.summary.final_cost < mon.summary.initial_cost
    assert mon.latest().trajectory is not None and mon.latest().residual_percentiles
