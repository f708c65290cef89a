"""The port's preprocessing tools (tools/save_observations.py,
tools/process_vrs.py) against the JAX package's, on the same inputs.

  * keyframe selection gives the same indices on straight, still, rotating
    and random trajectories;
  * the observations CSV the two tools write is byte-equal, and the tracks
    CSV parser returns the same arrays for both column-name variants;
  * the stage pipeline on a synthetic session: the `session_observations.csv`
    and `vrs_source_info.json` both tools write are byte-equal, and a second
    run skips every stage;
  * the tool writes microseconds under the `capture_timestamp_ns` header, as
    the reference's tool does, and both packages' load_session read that
    column as nanoseconds: in a session directory made by the tool no
    observation after t = 0 falls on a trajectory frame (a reference fault,
    ROADMAP C);
  * write_imu_csv output parses through the port's C++ IMU parser;
  * process_vrs exits with the SDK's name when projectaria_tools is missing;
  * the JAX tool's `_triangulate_tracks` raises on any input (flat arrays
    where triangulate_tracks takes padded tracks), so the port leaves it out.
"""

import json
import shutil

import numpy as np
import pytest

from visual_inertial_bundle_adjustment_tpu.tools import save_observations as jso
from visual_inertial_bundle_adjustment_tpu_torch.tools import save_observations as tso


def _motions(n=50):
    ts = np.arange(n, dtype=np.int64) * 100_000_000
    q = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    line = np.stack([np.arange(n) * 0.3, np.zeros(n), np.zeros(n)], -1)
    ang = np.arange(n) * np.deg2rad(6.0)
    qr = np.stack([np.cos(ang / 2), np.sin(ang / 2), np.zeros(n), np.zeros(n)], -1)
    rng = np.random.default_rng(7)
    qn = rng.normal(size=(n, 4))
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    walk = np.cumsum(rng.normal(scale=0.2, size=(n, 3)), axis=0)
    return [(ts, q, line), (ts, q, np.zeros((n, 3))), (ts, qr, np.zeros((n, 3))),
            (ts, qn, walk)]


def test_keyframe_selection_matches_jax():
    for ts, q, t in _motions():
        got = tso.select_keyframes(ts, q, t)
        np.testing.assert_array_equal(got, jso.select_keyframes(ts, q, t))
    opts = (tso.KeyframeSelectorOptions(5.0, 0.5, int(3e8)),
            jso.KeyframeSelectorOptions(5.0, 0.5, int(3e8)))
    ts, q, t = _motions()[3]
    np.testing.assert_array_equal(tso.select_keyframes(ts, q, t, opts[0]),
                                  jso.select_keyframes(ts, q, t, opts[1]))
    assert len(tso.select_keyframes(ts[:0], q[:0], t[:0])) == 0


def test_observations_csv_and_tracks_parser_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 40
    pid = rng.integers(0, 10, n)
    ts = rng.integers(10**12, 2 * 10**12, n)
    cam = rng.integers(0, 2, n)
    xy = rng.uniform(-5.0, 700.0, (n, 2))
    tso.write_observations_csv(tmp_path / "t.csv", pid, ts, cam, xy)
    jso.write_observations_csv(tmp_path / "j.csv", pid, ts, cam, xy)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    sh = rng.uniform(0.1, 1.0, (n, 4))
    tso.write_observations_csv(tmp_path / "t2.csv", pid, ts, cam, xy, sh)
    jso.write_observations_csv(tmp_path / "j2.csv", pid, ts, cam, xy, sh)
    assert (tmp_path / "t2.csv").read_bytes() == (tmp_path / "j2.csv").read_bytes()
    with open(tmp_path / "tracks.csv", "w") as f:
        f.write("point_id,capture_timestamp_us,camera_index,x,y\n")
        for i in range(n):
            f.write(f"{pid[i]},{ts[i] // 1000},{cam[i]},{xy[i, 0]},{xy[i, 1]}\n")
    for path in (tmp_path / "t2.csv", tmp_path / "tracks.csv"):
        for a, b in zip(tso._load_tracks_csv(path), jso._load_tracks_csv(path)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _session(tmp_path):
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic_io import (
        write_session_dir)

    s = SyntheticSession(duration=4.0, keyframe_hz=5.0, gyro_hz=100.0, accel_hz=100.0,
                         num_points=30, seed=2)
    write_session_dir(s, tmp_path / "sess", seed=2)
    obs = np.genfromtxt(tmp_path / "sess" / "session_observations.csv", delimiter=",",
                        names=True)
    with open(tmp_path / "tracks.csv", "w") as f:
        f.write("point_id,capture_timestamp_ns,camera_index,x,y\n")
        for r in obs:
            f.write(f"{int(r['point_id'])},{int(r['capture_timestamp_ns'])},"
                    f"{int(r['camera_index'])},{r['projection_base_res_x']},"
                    f"{r['projection_base_res_y']}\n")
    return tmp_path / "sess"


def test_stage_pipeline_writes_the_jax_tools_bytes(tmp_path, capsys):
    sess = _session(tmp_path)
    info = json.loads((sess / "vrs_source_info.json").read_text())

    def argv(out):
        return ["--trajectory", str(sess / "closed_loop_framerate_trajectory.csv"),
                "--tracks-csv", str(tmp_path / "tracks.csv"), "--output", str(out),
                "--camera-ids", ",".join(info["camera_ids"]),
                "--imu-ids", ",".join(info["imu_ids"])]

    out_t = tso.run(tso.build_arg_parser().parse_args(argv(tmp_path / "port")))
    stages = capsys.readouterr().out
    out_j = jso.run(jso.build_arg_parser().parse_args(argv(tmp_path / "jax")))
    for fn in ("session_observations.csv", "vrs_source_info.json",
               "closed_loop_framerate_trajectory.csv"):
        assert (out_t / fn).read_bytes() == (out_j / fn).read_bytes(), fn
    assert all(f"[stage {st}] {out_t}" in stages for st in ("trajectory", "layout",
                                                             "observations"))
    assert stages.count(" s)") == 2 and "s load, " in stages and " s write)" in stages
    kept = np.genfromtxt(out_t / "session_observations.csv", delimiter=",", names=True)
    assert len(kept) > 50
    _, counts = np.unique(kept["point_id"].astype(int), return_counts=True)
    assert counts.min() >= 3
    before = (out_t / "session_observations.csv").stat().st_mtime_ns
    capsys.readouterr()
    tso.run(tso.build_arg_parser().parse_args(argv(tmp_path / "port")))
    assert capsys.readouterr().out.count("exists, skipping") == 3
    assert (out_t / "session_observations.csv").stat().st_mtime_ns == before


def test_tool_output_loads_with_microseconds_read_as_nanoseconds(tmp_path):
    """The reference fault both packages share: load_session parses the
    tool's directory, but its observation times come out 1000x too small,
    so none after t = 0 falls on a trajectory frame (the adapter would keep
    only the first frame's)."""
    from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as jsd
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd

    sess = _session(tmp_path)
    info = json.loads((sess / "vrs_source_info.json").read_text())
    out = tso.run(tso.build_arg_parser().parse_args([
        "--trajectory", str(sess / "closed_loop_framerate_trajectory.csv"),
        "--tracks-csv", str(tmp_path / "tracks.csv"), "--output", str(tmp_path / "prep"),
        "--camera-ids", ",".join(info["camera_ids"]), "--imu-ids", ",".join(info["imu_ids"])]))
    for fn in sess.iterdir():  # the files process_vrs and the MPS would supply
        if not (out / fn.name).exists():
            shutil.copy(fn, out / fn.name)
    written = np.genfromtxt(out / "session_observations.csv", delimiter=",", names=True)
    for sd in (tsd.load_session(out), jsd.load_session(out)):
        assert len(sd.obs_point_id) == len(written)
        np.testing.assert_array_equal(sd.obs_timestamp_us * 1000,
                                      written["capture_timestamp_ns"].astype(np.int64))
        late = sd.obs_timestamp_us > 0  # the session starts at t = 0: its first frame matches
        assert late.sum() > 50 and not np.isin(sd.obs_timestamp_us[late],
                                                sd.traj_timestamp_us).any()
        assert np.isin(sd.obs_timestamp_us * 1000, sd.traj_timestamp_us).all()


def test_imu_csv_parses_through_the_ports_native_reader(tmp_path):
    from visual_inertial_bundle_adjustment_tpu.tools import process_vrs as jpv
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import native
    from visual_inertial_bundle_adjustment_tpu_torch.tools import process_vrs as tpv

    rng = np.random.default_rng(0)
    ts = (np.arange(50) * 1_250_000 + 10**12).astype(np.int64)
    gyro = rng.normal(size=(50, 3)) * 0.5
    accel = rng.normal(size=(50, 3)) * 3.0 + np.array([0.0, 0.0, 9.81])
    rows = [(t, 25.0, g, a) for t, g, a in zip(ts, gyro, accel)]
    tpv.write_imu_csv(tmp_path / "t.csv", rows)
    jpv.write_imu_csv(tmp_path / "j.csv", rows)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    t2, g2, a2 = native.parse_imu_csv(tmp_path / "t.csv")
    np.testing.assert_array_equal(t2, ts)
    np.testing.assert_allclose(g2, gyro, atol=1e-7)
    np.testing.assert_allclose(a2, accel, atol=1e-7)


def test_process_vrs_is_gated_without_the_sdk(tmp_path):
    from visual_inertial_bundle_adjustment_tpu_torch.tools import process_vrs as tpv

    try:
        import projectaria_tools  # noqa: F401
        pytest.skip("projectaria_tools installed")
    except ImportError:
        pass
    with pytest.raises(SystemExit, match="projectaria_tools"):
        tpv.process_vrs(tmp_path / "x.vrs", tmp_path / "out")
    with pytest.raises(SystemExit, match="projectaria_tools"):
        tpv.main(["-i", str(tmp_path / "x.vrs"), "-o", str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="projectaria_tools"):
        tso.main(["--vrs", str(tmp_path / "x.vrs"), "--output", str(tmp_path / "o"),
                  "--trajectory", __file__])
    assert not (tmp_path / "out").exists()


def test_jax_triangulate_tracks_raises_so_the_port_leaves_it_out():
    from visual_inertial_bundle_adjustment_tpu.ops import camera as cam_ops

    rng = np.random.default_rng(1)
    pid = np.array([0, 0, 0, 1, 1, 1])
    rig = np.array([0, 1, 2, 0, 1, 2])
    q = np.tile([1.0, 0.0, 0.0, 0.0], (3, 1, 1))
    t = np.zeros((3, 1, 3))
    t[:, 0, 0] = [0.0, 0.1, 0.2]
    intr = np.array([[300.0, 300.0, 320.0, 240.0] + [0.0] * 13])
    with pytest.raises(ValueError, match="out of bounds"):
        jso._triangulate_tracks(pid, rig, np.zeros(6, int), rng.uniform(100, 300, (6, 2)),
                                q, t, intr, cam_ops.KIND_FISHEYE624)
    assert not hasattr(tso, "_triangulate_tracks")
