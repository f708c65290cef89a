"""The port's rig initialisation (pipeline/init_rigs.py) and its wiring in the
session adapter, against the JAX package, in float64 on the CPU.

  - each init_rigs function on the cases of tests/test_init_rigs.py: the SO3 /
    SE3 helpers, the keyrig ranges, the interpolated trajectory, the GT
    override, the log-scale drift and the map-interpolated init    1e-12
  - the adapter with map keyrigs, and with a GT trajectory and every
    trajectory_to_gt component, on a tiny session directory: the same rig
    states (1e-9) and landmarks (1e-6 of their max-abs: triangulation draws
    its RANSAC pairs from other generators, tests/test_torch_full_build.py)
"""

import functools
import pathlib
import tempfile

import numpy as np
import pytest
import torch
from _torch_port_fixtures import rel

from visual_inertial_bundle_adjustment_tpu.pipeline import init_rigs as jir
from visual_inertial_bundle_adjustment_tpu_torch.pipeline import init_rigs as tir
from visual_inertial_bundle_adjustment_tpu_torch.pipeline.session_data import (_q_mul,
                                                                                _q_rot,
                                                                                _se3_inv)

TOL = 1e-12


def _close(a, b, tol=TOL):
    for x, y in zip(a, b, strict=True):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            _close(x.values(), y.values(), tol)
        elif x is None:
            assert y is None
        else:
            np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float), rtol=0,
                                       atol=tol * max(1.0, np.abs(np.asarray(y, float)).max()))


def _walk(R, seed):
    """T_bodyImu_world poses, world velocities and omegas of a curvy walk."""
    rng = np.random.default_rng(seed)
    ts = np.arange(R) * 100_000
    pos = np.cumsum(rng.normal(size=(R, 3)) * 0.05, axis=0) + [0, 0, 1.0]
    q_wb = np.stack([jir._so3_exp(rng.normal(size=3) * 0.2) for _ in range(R)])
    q, t = zip(*(_se3_inv(q_wb[i], pos[i]) for i in range(R)))
    return ts, np.stack(q), np.stack(t), rng.normal(size=(R, 3)), rng.normal(size=(R, 3)), rng


@pytest.mark.parametrize("scale", [0.5, 2.5, 1e-14])
def test_so3_se3_helpers_match(scale):
    rng = np.random.default_rng(0)
    r = rng.normal(size=(50, 3)) * scale
    _close([tir._so3_exp(r), tir._so3_log(tir._so3_exp(r))],
           [jir._so3_exp(r), jir._so3_log(jir._so3_exp(r))])
    qa, ta = jir._so3_exp(r[0]), rng.normal(size=3)
    qb, tb = jir._so3_exp(r[1]), rng.normal(size=3)
    for a in (0.0, 0.3, 0.5, 1.0):
        _close(tir._se3_interpolate(qa, ta, qb, tb, a), jir._se3_interpolate(qa, ta, qb, tb, a))


@pytest.mark.parametrize("case", [
    dict(kr_rig_indices=[5, 40, 44], num_rigs=60, reset_rig_indices=[42], rig_window_grow=3),
    dict(kr_rig_indices=[5, 40], num_rigs=60, rig_window_grow=3, same_interval=[7, 7]),
    dict(kr_rig_indices=[0, 3, 9, 50, 59], num_rigs=60, reset_rig_indices=[20, 55]),
])
def test_key_rig_init_ref_matches(case):
    assert tir.compute_key_rig_init_ref(**case) == jir.compute_key_rig_init_ref(**case)


def test_interpolated_trajectory_and_gt_init_match():
    ts, q, t, vel, om, rng = _walk(40, 2)
    tt = tir.InterpolatedTrajectory(ts, q, t, vel, om)
    jt = jir.InterpolatedTrajectory(ts, q, t, vel, om)
    for t_us in (int(ts[7]), int(ts[7]) + 33_000, -5, int(ts[-1]) + 10):
        _close(tt.inertial_pose(t_us), jt.inertial_pose(t_us))
    noisy_q = np.stack([_q_mul(jir._so3_exp(rng.normal(size=3) * 0.05), q[i]) for i in range(40)])
    noisy_t = t + rng.normal(size=(40, 3)) * 0.1
    for flags in ((True, False, False), (True, True, True), (False, True, False)):
        kw = dict(zip(("pose_to_gt", "vel_to_gt", "omega_to_gt"), flags))
        _close(tir.init_rigs_from_gt(noisy_q, noisy_t, vel, om, ts, tt, **kw),
               jir.init_rigs_from_gt(noisy_q, noisy_t, vel, om, ts, jt, **kw))
    _close(tir.init_rigs_from_gt(noisy_q, noisy_t, vel, om, ts, tt, ranges=[(3, 9), (20, 25)]),
           jir.init_rigs_from_gt(noisy_q, noisy_t, vel, om, ts, jt, ranges=[(3, 9), (20, 25)]))


def _map_case():
    """A trajectory that is a scaled, rotated copy of a 5 m loop (the map),
    keyrigs every 8 rigs (tests/test_init_rigs.py)."""
    R = 80
    ts = np.arange(R) * 100_000
    ang = np.linspace(0, 2 * np.pi, R)
    pos_map = np.stack([5 * np.cos(ang), 5 * np.sin(ang), np.zeros(R)], -1)
    q_wb = np.stack([jir._so3_exp([0, 0, a]) for a in ang])
    map_q, map_t = (np.stack(x) for x in zip(*(_se3_inv(q_wb[i], pos_map[i]) for i in range(R))))
    rot = jir._so3_exp([0.0, 0.0, 0.7])
    pos_traj = np.stack([_q_rot(rot, p) * 1.25 for p in pos_map])
    q_traj = np.stack([_q_mul(rot, q_wb[i]) for i in range(R)])
    traj_q, traj_t = (np.stack(x) for x in zip(*(_se3_inv(q_traj[i], pos_traj[i])
                                                 for i in range(R))))
    vel = np.gradient(pos_traj, axis=0) / 0.1
    kr = np.arange(0, R, 8)
    return traj_q, traj_t, vel, np.zeros((R, 3)), ts, kr, map_q[kr], map_t[kr]


@pytest.mark.parametrize("extra", [dict(), dict(reset_rig_indices=[30]),
                                   dict(rig_window_grow=2, same_interval=[0] * 5 + [1] * 5)])
def test_map_interpolated_init_matches(extra):
    args = _map_case()
    _close(tir.init_rigs_interpolating_poses(*args, **extra),
           jir.init_rigs_interpolating_poses(*args, **extra))
    traj_q, traj_t, _, _, ts, kr, kq, kt = args
    _close(tir.compute_log_scalings(ts[kr], kq, kt, traj_q, traj_t, kr),
           jir.compute_log_scalings(ts[kr], kq, kt, traj_q, traj_t, kr))
    _close([tir.scaling_at_timestamps(np.asarray([100, 200]), np.log([2.0, 4.0]),
                                      [0, 100, 150, 200, 500])],
           [jir.scaling_at_timestamps(np.asarray([100, 200]), np.log([2.0, 4.0]),
                                      [0, 100, 150, 200, 500])])


@functools.lru_cache(maxsize=None)
def _session_dir():
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic import SyntheticSession
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline.synthetic_io import (
        write_session_dir)

    path = pathlib.Path(tempfile.mkdtemp(prefix="viba_init_"))
    write_session_dir(SyntheticSession(duration=3.0, keyframe_hz=5.0, gyro_hz=200.0,
                                       accel_hz=200.0, num_points=40, num_cameras=1, seed=3,
                                       pixel_noise=0.3), path, num_imus=1, seed=7)
    return path


def _options(which, pkg, sd, ts_us):
    if which == "map":
        # keyrigs every 4 rigs, in a map world rotated and shifted from the
        # trajectory's, with a little noise
        rng = np.random.default_rng(11)
        rows = np.searchsorted(sd.traj_timestamp_us, ts_us[::4])
        off_q, off_t = jir._so3_exp([0.01, -0.02, 0.3]), np.asarray([0.5, -0.2, 0.1])
        kq, kt = zip(*(jir._se3_mul(sd.traj_pose_q[r], sd.traj_pose_t[r], off_q,
                                    off_t + rng.normal(size=3) * 1e-3) for r in rows))
        return dict(map_keyrigs=(ts_us[::4], np.stack(kq), np.stack(kt)), rig_window_grow=3)
    _, g_ts, g_q, g_t, g_vel, g_om = pkg.session_data.load_trajectory_csv(
        _session_dir() / "closed_loop_framerate_trajectory.csv", sd.q_bodyImu_device,
        sd.t_bodyImu_device, use_closed=True)
    # the ground truth a little off the trajectory the adapter starts from
    g_t = g_t + 0.01
    return dict(gt_trajectory=pkg.init_rigs.InterpolatedTrajectory(g_ts, g_q, g_t, g_vel, g_om),
                trajectory_to_gt=("all",))


@pytest.mark.parametrize("which", ["map", "gt"])
def test_adapter_rig_init_matches(which):
    """The adapter's map-anchored and GT-trajectory initialisations give the
    JAX adapter's variables."""
    import types

    from visual_inertial_bundle_adjustment_tpu.pipeline import adapter as jad
    from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as jsd
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import adapter as tad
    from visual_inertial_bundle_adjustment_tpu_torch.pipeline import session_data as tsd

    out = {}
    for name, ad, sdm in (("jax", jad, jsd), ("port", tad, tsd)):
        pkg = types.SimpleNamespace(session_data=sdm, init_rigs=jir if name == "jax" else tir)
        sd = sdm.load_session(_session_dir())
        kw = dict(device="cpu", dtype=torch.float64) if name == "port" else {}
        probe = ad.SessionAdapter(sd, ad.AdapterOptions(), log=None, **kw)
        opts = ad.AdapterOptions(**_options(which, pkg, sd, probe.rig_ts_us))
        out[name] = ad.SessionAdapter(sd, opts, log=None, **kw).build().variables
    base = tsd.load_session(_session_dir())
    moved = rel(out["port"].pose_t, base.traj_pose_t[:out["port"].pose_t.shape[0]])
    assert moved > 1e-4  # the override moved the rigs
    for key in ("pose_q", "pose_t", "vel", "omega"):
        assert rel(getattr(out["port"], key), getattr(out["jax"], key)) <= 1e-9, key
    assert rel(out["port"].points, out["jax"].points) <= 1e-6
