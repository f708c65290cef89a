"""The port's command-line entry point (pipeline/cli.py) against the JAX
package's, in float64 on the CPU.

  - flag parsing: the token DSL and make_adapter_options, field for field
  - the port's CLI on the committed golden sessions against their expected
    outputs, at tests/test_golden_session.py's bounds
  - the CLI of both packages on tests/test_cli.py's synthetic session, with
    --recompute-preint and with --trajectory-to-gt: the three output files
    agree (1e-5 absolute in every numeric column), the reports have the same
    keys and costs (1e-8 relative)
  - --compute-covariances: both packages' CLIs on that session write
    rig_covariances.csv and imu_calib_covariances.jsonl in one format, entry
    by entry within 1e-6 (rig blocks) and 1e-4 (IMU calibration blocks) of
    each block's largest entry
  - chip_smoke.py's copies of the golden flag lists equal the originals
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from tools_dev.gen_golden_session import CLI_ARGS, CLI_ARGS_FULL
from visual_inertial_bundle_adjustment_tpu.pipeline import cli as jcli
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import cli as tcli

DATA = pathlib.Path(__file__).parent / "data"
ARGVS = [
    [],
    ["--tracking-obs-lrad", "0.8", "--tracking-obs-lcut", "2.5", "--imu-lrad", "4.0",
     "--imu-lcut", "9.0", "--cam-intr-fprio-infl", "7.0", "--imu-extr-rw-infl", "3.0",
     "--rig-start", "2", "--rig-end", "11"],
    ["--no-fprio", "--imu-calib-fprio-infl", "50.0", "--cam-extr-rw-infl", "2.0",
     "--imu-calib-rw-infl", "0.5", "--cam-intr-rw-infl", "4", "--imu-extr-fprio-infl", "9"],
    ["--calib-constant", "cam-all", "--calib-factory", "imu-extr"],
    ["--calib-constant", "all,-imu-calib", "--calib-factory", "all-extr,-cam-extr"],
    ["--calib-factory", "imu-all,cam-intr", "--calib-constant", "imu-calib,-imu-calib"],
    ["--imu-calib-estimation-options", "gyro-bias,accel-bias"],
    ["--imu-calib-estimation-options", "all,-all-time-offsets,gyro-accel-time-offset"],
    ["--imu-calib-estimation-options", "all-but-biases,-all-non-orths,gyro-scale"],
    ["--imu-calib-estimation-options=-gyro-bias,all-but-time-offsets,-accel-scale"],
    ["--estimate-readout-time", "--estimate-time-offset", "--optimize-detector-bias"],
    ["--trajectory-constant"],
    ["--trajectory-constant", "pose,vel"],
    ["--trajectory-constant", "omega", "--trajectory-to-gt", "pose,-vel,all"],
    ["--trajectory-to-gt", "vel,omega", "--gt-trajectory-base-name", "x.csv"],
]


def _parse(mod, argv):
    return mod.build_arg_parser().parse_args(["-i", "unused", *argv])


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:60] or "defaults")
def test_make_adapter_options_matches(argv):
    jo = jcli.make_adapter_options(_parse(jcli, argv))
    to = tcli.make_adapter_options(_parse(tcli, argv))
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    assert vars(_parse(tcli, argv)) == vars(_parse(jcli, argv))


@pytest.mark.parametrize("text", ["gyro-bias", "all,-accel-bias, ,-", "-all,all-non-orths",
                                  "bogus", "all-time-offsets,-reference-imu-time-offset"])
def test_token_dsl_matches(text):
    assert list(tcli.each_token(text)) == list(jcli.each_token(text))
    for fn in ("parse_imu_options", "parse_calib_groups"):
        try:
            expected = getattr(jcli, fn)(text)
        except SystemExit as e:
            with pytest.raises(SystemExit, match=str(e)):
                getattr(tcli, fn)(text)
        else:
            assert getattr(tcli, fn)(text) == expected


def test_bad_tokens_and_flags_raise():
    with pytest.raises(SystemExit, match="unknown trajectory token"):
        tcli.make_adapter_options(_parse(tcli, ["--trajectory-constant", "posee"]))
    with pytest.raises(SystemExit, match="requires --gt-trajectory-base-name"):
        tcli.main(["-i", str(DATA / "golden_session/input"), "--trajectory-to-gt", "pose"],
                  device="cpu")
    # --compute-covariances gets past the arguments and fails at loading the
    # missing session as the JAX CLI does
    argv = ["-i", "/nonexistent", "--compute-covariances"]
    with pytest.raises(Exception) as jax_err:
        jcli.main(argv)
    with pytest.raises(type(jax_err.value), match="nonexistent"):
        tcli.main(argv, device="cpu")


def test_main_defaults_to_the_card():
    """Without a device the CLI builds on the first CUDA card; without one it
    fails rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tcli.main(["-i", str(DATA / "golden_session/input"), "--max-num-iterations", "1"])


def test_chip_smoke_golden_flags_equal_the_originals():
    import chip_smoke

    assert chip_smoke.CLI_ARGS == CLI_ARGS
    assert chip_smoke.CLI_ARGS_FULL == CLI_ARGS_FULL


def _load_traj(path):
    import csv

    rows = list(csv.DictReader(open(path)))
    t = np.asarray([int(r["tracking_timestamp_us"]) for r in rows])
    pos = np.asarray([[float(r[f"t{a}_world_device"]) for a in "xyz"] for r in rows])
    quat = np.asarray([[float(r[f"q{a}_world_device"]) for a in "wxyz"] for r in rows])
    return t, pos, quat


def _golden(name, argv, tmp_path):
    base = DATA / name
    out = tmp_path / "out"
    assert tcli.main(["-i", str(base / "input"), "-o", str(out), *argv], device="cpu") == 0
    t_e, pos_e, quat_e = _load_traj(base / "expected/closed_loop_framerate_trajectory.csv")
    t_a, pos_a, quat_a = _load_traj(out / "closed_loop_framerate_trajectory.csv")
    np.testing.assert_array_equal(t_a, t_e)
    pos_err = np.linalg.norm(pos_a - pos_e, axis=-1)
    assert pos_err.max() < 1e-4, pos_err.max()  # 0.1 mm
    assert (1.0 - np.abs(np.sum(quat_a * quat_e, axis=-1))).max() < 1e-8
    exp = [json.loads(ln) for ln in open(base / "expected/online_calibration.jsonl")]
    act = [json.loads(ln) for ln in open(out / "online_calibration.jsonl")]
    assert len(exp) == len(act)
    return exp, act


def test_golden_session_outputs(tmp_path):
    """tests/test_golden_session.py's bounds on the committed session."""
    exp, act = _golden("golden_session", CLI_ARGS, tmp_path)
    for e, a in zip(exp[:3] + exp[-3:], act[:3] + act[-3:]):
        for ei, ai in zip(e["ImuCalibrations"], a["ImuCalibrations"], strict=True):
            np.testing.assert_allclose(np.asarray(ai["Gyroscope"]["Bias"]["Offset"], float),
                                       np.asarray(ei["Gyroscope"]["Bias"]["Offset"], float),
                                       atol=1e-6)


def test_full_sensor_golden_session_outputs(tmp_path):
    """tests/test_golden_session.py's bounds on the committed full-sensor
    session (rolling shutter, readout and time offset estimated, two IMUs)."""
    exp, act = _golden("golden_session_full", CLI_ARGS_FULL, tmp_path)
    for e, a in zip(exp[:3] + exp[-3:], act[:3] + act[-3:]):
        for ei, ai in zip(e["ImuCalibrations"], a["ImuCalibrations"], strict=True):
            for sensor in ("Gyroscope", "Accelerometer"):
                np.testing.assert_allclose(np.asarray(ai[sensor]["Bias"]["Offset"], float),
                                           np.asarray(ei[sensor]["Bias"]["Offset"], float),
                                           atol=1e-6)
            np.testing.assert_allclose(float(ai.get("TimeOffsetSec_Device_Gyro", 0.0)),
                                       float(ei.get("TimeOffsetSec_Device_Gyro", 0.0)),
                                       atol=1e-8)
        for ec, ac in zip(e["CameraCalibrations"], a["CameraCalibrations"], strict=True):
            np.testing.assert_allclose(np.asarray(ac["Projection"]["Params"], float),
                                       np.asarray(ec["Projection"]["Params"], float),
                                       rtol=1e-6, atol=1e-7)
            for key in ("ReadoutTimeSec", "TimeOffsetSec_Device_Camera"):
                np.testing.assert_allclose(float(ac.get(key, 0.0)), float(ec.get(key, 0.0)),
                                           atol=1e-8)


@pytest.fixture(scope="module")
def session_dir(tmp_path_factory):
    """tests/test_cli.py's synthetic session directory."""
    from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic_io import write_session_dir

    path = tmp_path_factory.mktemp("cli_session")
    s = SyntheticSession(duration=4.0, keyframe_hz=5.0, gyro_hz=200.0, accel_hz=200.0,
                         num_points=60, num_cameras=1, seed=3, pixel_noise=0.3)
    write_session_dir(s, path, num_imus=2, seed=7)
    return path


def _numeric(path):
    """The numeric columns of an output CSV (the uid column is a string)."""
    return np.genfromtxt(path, delimiter=",", skip_header=1)


@pytest.mark.slow  # the JAX CLI compiles for ~2 min on the CPU
@pytest.mark.parametrize("extra", [
    ["--recompute-preint", "--json-report", "{out}/report.json"],
    ["--trajectory-to-gt", "pose,vel", "--gt-trajectory-base-name",
     "closed_loop_framerate_trajectory.csv", "--json-report", "{out}/report.json"],
], ids=["recompute_preint", "trajectory_to_gt"])
def test_cli_main_matches_jax(session_dir, tmp_path, extra):
    outs = {}
    for name, run in (("jax", jcli.main), ("port", lambda a: tcli.main(a, device="cpu"))):
        out = tmp_path / name
        argv = ["-i", str(session_dir), "-o", str(out), "--calib-constant", "cam-all",
                "--imu-calib-estimation-options", "gyro-bias,accel-bias",
                "--max-num-iterations", "4", *(a.format(out=out) for a in extra)]
        out.mkdir()
        assert run(argv) == 0
        outs[name] = out
    for fn in ("closed_loop_framerate_trajectory.csv", "open_loop_framerate_trajectory.csv"):
        assert ((outs["port"] / fn).read_text().splitlines()[0]
                == (outs["jax"] / fn).read_text().splitlines()[0])
        np.testing.assert_allclose(_numeric(outs["port"] / fn), _numeric(outs["jax"] / fn),
                                   rtol=0, atol=1e-5)
    calib = [[json.loads(ln) for ln in open(outs[k] / "online_calibration.jsonl")]
             for k in ("port", "jax")]
    assert len(calib[0]) == len(calib[1])
    for a, e in zip(*calib):
        assert a.keys() == e.keys() and a["tracking_timestamp_us"] == e["tracking_timestamp_us"]
        for ai, ei in zip(a["ImuCalibrations"], e["ImuCalibrations"], strict=True):
            for sensor in ("Gyroscope", "Accelerometer"):
                np.testing.assert_allclose(ai[sensor]["Bias"]["Offset"],
                                           ei[sensor]["Bias"]["Offset"], atol=1e-6)
    rep = [json.loads((outs[k] / "report.json").read_text()) for k in ("port", "jax")]
    assert rep[0].keys() == rep[1].keys()
    for key in ("initialCost", "finalCost"):
        assert abs(rep[0][key] - rep[1][key]) <= 1e-8 * abs(rep[1][key])
    for key in ("numIterations", "numTroubledSeqs", "largestTroubledSeq"):
        assert rep[0][key] == rep[1][key]


def _cov_csv(path):
    lines = path.read_text().splitlines()
    return lines[0], np.asarray([[float(x) for x in ln.split(",")] for ln in lines[1:]])


@pytest.mark.slow  # the JAX CLI compiles for ~2 min on the CPU
def test_cli_covariances_match_jax(session_dir, tmp_path):
    """tests/test_cli.py::test_cli_compute_covariances's run through both
    CLIs: the same files and rows; every 12x12 block within 1e-6 of its
    largest entry, every IMU calibration block within 1e-4 (measured 2.7e-5:
    the two CLIs end their LM runs a rounding apart, and 150 PCG iterations
    against the 1e4 gauge prior leave these columns short of convergence)."""
    outs = {}
    for name, run in (("jax", jcli.main), ("port", lambda a: tcli.main(a, device="cpu"))):
        out = tmp_path / name
        assert run(["-i", str(session_dir), "-o", str(out), "--calib-constant", "cam-all",
                    "--imu-calib-estimation-options", "gyro-bias,accel-bias",
                    "--max-num-iterations", "2", "--compute-covariances",
                    "--covariance-pcg-iterations", "150"]) == 0
        outs[name] = out
    (head_p, rows_p), (head_j, rows_j) = (_cov_csv(outs[k] / "rig_covariances.csv")
                                          for k in ("port", "jax"))
    assert head_p == head_j and rows_p.shape == rows_j.shape
    np.testing.assert_array_equal(rows_p[:, 0], rows_j[:, 0])
    for a, e in zip(rows_p, rows_j):
        scale = max(np.abs(e[13:]).max(), 1e-300)
        assert np.abs(a[13:] - e[13:]).max() <= 1e-6 * scale
        assert np.abs(a[1:13] - e[1:13]).max() <= 1e-6 * max(np.abs(e[1:13]).max(), 1e-300)
    recs = [[json.loads(ln) for ln in (outs[k] / "imu_calib_covariances.jsonl").open()]
            for k in ("port", "jax")]
    assert len(recs[0]) == len(recs[1]) > 0
    for a, e in zip(*recs):
        assert a.keys() == e.keys()
        assert (a["window"], a["imu"], a["dims"]) == (e["window"], e["imu"], e["dims"])
        ca, ce = np.asarray(a["cov"]), np.asarray(e["cov"])
        assert np.abs(ca - ce).max() <= 1e-4 * max(np.abs(ce).max(), 1e-300)
