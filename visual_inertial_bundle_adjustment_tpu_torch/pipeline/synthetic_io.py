"""Emit a SyntheticSession as a reference-format input directory.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/synthetic_io.py`.
Produces the exact file set SessionData::load expects (SessionData.cpp:29-40):
vrs_source_info.json, online_calibration.jsonl, factory_calibration.json,
closed_loop_framerate_trajectory.csv, session_observations.csv,
imu_samples_<label>.csv — so the full pipeline (load -> match -> triangulate ->
optimize -> save) can be exercised end-to-end with known ground truth,
including a device frame distinct from the bodyImu frame and optional
secondary IMUs with their own extrinsics and distorted streams.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models import imu as imu_model
from ..ops import lie
from . import session_data as sio
from .synthetic import SyntheticSession, _exp_so3, _quat_from_mat


def _secondary_imu_stream(s: SyntheticSession, q_imu_body, t_imu_body, calib23,
                          gyro_hz=800.0, accel_hz=800.0, with_noise=True):
    """Raw stream of a secondary IMU rigidly mounted at T_imu_bodyImu."""
    rng = s.rng
    pad = 0.3
    g_t = np.arange(-pad, s.duration + pad, 1.0 / gyro_hz)
    a_t = np.arange(-pad, s.duration + pad, 1.0 / accel_hz)
    c = calib23

    # position of the imu origin in world: p2(t) = p(t) + R_world_body(t) r
    # with r the imu origin in body coords = T_imu_body^-1 translation
    q_bi = sio._q_conj(q_imu_body)
    r = -sio._q_rot(q_bi, t_imu_body)

    def p2(t):
        R_wb = _exp_so3(s.traj.rotvec(t))
        return s.traj.pos(t) + np.einsum("nij,j->ni", R_wb, r)

    def true_signals(t):
        R_wb = _exp_so3(s.traj.rotvec(t))
        R_bw = np.swapaxes(R_wb, -1, -2)
        eps = 1e-6
        Rp, Rm = _exp_so3(s.traj.rotvec(t + eps)), _exp_so3(s.traj.rotvec(t - eps))
        What = np.einsum("nji,njk->nik", R_wb, (Rp - Rm) / (2 * eps))
        w_body = np.stack(
            [What[..., 2, 1] - What[..., 1, 2], What[..., 0, 2] - What[..., 2, 0],
             What[..., 1, 0] - What[..., 0, 1]], -1) / 2.0
        qb = np.broadcast_to(q_imu_body, w_body.shape[:-1] + (4,))
        w_imu = sio._q_rot(qb, w_body)
        # numeric second derivative of the imu position
        h = 1e-3
        acc2 = (p2(t + h) - 2 * p2(t) + p2(t - h)) / (h * h)
        f_body_at_imu = np.einsum("nij,nj->ni", R_bw, acc2 - s.gravity)
        f_imu = sio._q_rot(qb, f_body_at_imu)
        return w_imu, f_imu

    # midpoint sampling (see synthetic._gen_imu)
    w_true, _ = true_signals(g_t - c[imu_model.DT_REF_GYRO] - 0.5 / gyro_hz)
    _, f_true = true_signals(a_t - c[imu_model.DT_REF_ACCEL] - 0.5 / accel_hz)
    ct = torch.from_numpy(np.asarray(c, np.float64))
    gyroN = imu_model.gyro_nonorth_matrix(ct).numpy()
    accelN = imu_model.accel_nonorth_matrix(ct).numpy()
    w_meas = np.einsum("ij,nj->ni", gyroN, w_true + c[imu_model.GYRO_BIAS]) * c[imu_model.GYRO_SCALE]
    f_meas = np.einsum("ij,nj->ni", accelN, f_true + c[imu_model.ACCEL_BIAS]) * c[imu_model.ACCEL_SCALE]
    if with_noise:
        w_meas += rng.normal(size=w_meas.shape) * np.sqrt(s.noise.gyro_sample_var.numpy())
        f_meas += rng.normal(size=f_meas.shape) * np.sqrt(s.noise.accel_sample_var.numpy())
    return g_t, w_meas, a_t, f_meas


def write_session_dir(
    s: SyntheticSession,
    path,
    num_imus: int = 1,
    traj_noise_pos: float = 0.01,
    traj_noise_rot: float = 0.002,
    traj_noise_vel: float = 0.02,
    online_calib_noise: float = 0.0,
    readout_time_sec: float | None = None,
    seed: int = 42,
):
    """Write all input files; returns ground-truth info dict."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # device frame: offset from the bodyImu frame by a fixed transform
    q_bI_dev = _quat_from_mat(_exp_so3(np.array([[0.03, -0.02, 0.4]]))[0][None])[0]
    t_bI_dev = np.array([0.004, -0.012, 0.007])

    cam_serials = [f"serial-cam-{i}" for i in range(s.num_cameras)]
    cam_labels = [f"camera-slam-{'left' if i == 0 else 'right'}" for i in range(s.num_cameras)]
    imu_labels = ["imu-right", "imu-left"][:num_imus]

    with open(path / "vrs_source_info.json", "w") as f:
        json.dump({"camera_ids": cam_serials, "imu_ids": imu_labels}, f, indent=1)

    # secondary imu mounting + calib
    imu_mounts = [(np.array([1.0, 0, 0, 0]), np.zeros(3))]  # imu0 == bodyImu
    imu_calibs = [s.true_calib]
    imu_streams = [(s.gyro_t, s.gyro_v, s.accel_t, s.accel_v)]
    for ii in range(1, num_imus):
        qm = _quat_from_mat(_exp_so3(np.array([[0.02, 3.1, 0.05]]))[0][None])[0]
        tm = np.array([0.05, -0.11, 0.01])
        c = np.array(s.true_calib)
        c[imu_model.GYRO_BIAS] = rng.normal(size=3) * 0.004
        c[imu_model.ACCEL_BIAS] = rng.normal(size=3) * 0.03
        imu_mounts.append((qm, tm))
        imu_calibs.append(c)
        imu_streams.append(_secondary_imu_stream(s, qm, tm, c))

    # factory + online calibration states
    def imu_json_entries(perturb):
        out = []
        for ii in range(num_imus):
            qm, tm = imu_mounts[ii]
            c = np.array(imu_calibs[ii])
            if perturb > 0:
                c[imu_model.GYRO_BIAS] += rng.normal(size=3) * perturb * 0.01
                c[imu_model.ACCEL_BIAS] += rng.normal(size=3) * perturb * 0.05
            # T_Device_Imu = T_Device_BodyImu * T_BodyImu_Imu
            q_dev_bI, t_dev_bI = sio._se3_inv(q_bI_dev, t_bI_dev)
            qi, ti = sio._se3_inv(qm, tm)  # T_bodyImu_imu
            qq, tt = sio._se3_mul(q_dev_bI, t_dev_bI, qi, ti)
            out.append(
                sio._imu_to_json(sio.ImuCalib(imu_labels[ii], c, qq, tt))
            )
        return out

    def cam_json_entries(perturb):
        out = []
        q_dev_bI, t_dev_bI = sio._se3_inv(q_bI_dev, t_bI_dev)
        for ci in range(s.num_cameras):
            qcb, tcb = s.cam_extr[ci]  # T_Cam_BodyImu
            qbc, tbc = sio._se3_inv(np.asarray(qcb), np.asarray(tcb))
            qq, tt = sio._se3_mul(q_dev_bI, t_dev_bI, qbc, tbc)  # T_Device_Camera
            params = np.array(s.camera_params)
            if perturb > 0:
                params[0] += rng.normal() * perturb
            c = sio.CameraCalib(
                label=cam_labels[ci], serial=cam_serials[ci],
                projection_name="FisheyeRadTanThinPrism", params=params,
                q_device_camera=qq, t_device_camera=tt,
                time_offset_sec=0.0, readout_time_sec=readout_time_sec,
                image_size=s.image_size,
            )
            out.append(sio._camera_to_json(c))
        return out

    with open(path / "factory_calibration.json", "w") as f:
        json.dump(
            {"CameraCalibrations": cam_json_entries(0.0),
             "ImuCalibrations": imu_json_entries(0.0)},
            f,
        )

    rig_ts_us = np.round(s.rig_times * 1e6).astype(np.int64)
    # noise-free states are identical across records: serialize ONCE (the
    # per-record path pulls small device arrays per entry — minutes at
    # thousands of rigs)
    frozen = None
    if online_calib_noise == 0.0:
        frozen = json.dumps({
            "CameraCalibrations": cam_json_entries(0.0),
            "ImuCalibrations": imu_json_entries(0.0),
        })[1:-1]
    with open(path / "online_calibration.jsonl", "w") as f:
        for t_us in rig_ts_us:
            if frozen is not None:
                f.write('{"tracking_timestamp_us": %d, %s}\n' % (int(t_us), frozen))
                continue
            f.write(
                json.dumps(
                    {
                        "tracking_timestamp_us": int(t_us),
                        "CameraCalibrations": cam_json_entries(online_calib_noise),
                        "ImuCalibrations": imu_json_entries(online_calib_noise),
                    }
                )
                + "\n"
            )

    # trajectory CSV (closed-loop format, device frame), with tracker noise
    R = s.num_rigs
    pose_q = np.asarray(s.gt_pose_q)
    pose_t = np.asarray(s.gt_pose_t)
    noise_rot = rng.normal(size=(R, 3)) * traj_noise_rot
    noise_pos = rng.normal(size=(R, 3)) * traj_noise_pos
    xi = np.concatenate([noise_pos, noise_rot], axis=1)
    nq, nt = lie.se3_boxplus((torch.from_numpy(pose_q), torch.from_numpy(pose_t)),
                             torch.from_numpy(xi))
    pose_q, pose_t = lie.quat_normalize(nq).numpy(), nt.numpy()
    vel = s.gt_vel_w + rng.normal(size=(R, 3)) * traj_noise_vel
    omega = s.gt_omega + rng.normal(size=(R, 3)) * 0.002

    sd_shim = sio.SessionData(
        slam_camera_serials=cam_serials, slam_imu_labels=imu_labels,
        q_bodyImu_device=q_bI_dev, t_bodyImu_device=t_bI_dev,
        factory=None, online=[],
        traj_timestamp_us=rig_ts_us,
        traj_pose_q=pose_q, traj_pose_t=pose_t, traj_vel_w=vel, traj_omega=omega,
        traj_quality=np.ones(R), traj_session_uid=["synthetic"] * R,
        traj_utc_ns=rig_ts_us * 1000,
        obs_point_id=None, obs_timestamp_us=None, obs_camera_index=None,
        obs_uv=None, obs_sqrt_h=None, imu_times_ns=[], imu_gyro=[], imu_accel=[],
        reset_timestamps_us=np.zeros(0, np.int64),
    )
    sio.save_close_loop_trajectory(
        path / "closed_loop_framerate_trajectory.csv", sd_shim, pose_q, pose_t, vel,
        omega, s.gravity,
    )

    # observations
    obs = s.observations()
    obs_ts_us = rig_ts_us[obs["rig"]]
    n = len(obs["point"])
    sqrt_h = np.broadcast_to(np.eye(2) * 0.7, (n, 2, 2))
    sio.save_observations(
        path / "session_observations.csv", obs["point"], obs_ts_us, obs["cam"],
        obs["uv"], sqrt_h,
    )

    # imu samples: the EuRoC row format carries gyro and accel at the SAME
    # recorded timestamp (ImuDataFormat.h:14-23) — the per-sensor time offsets
    # in the calibration are what de-align their effective sample times.
    for ii, label in enumerate(imu_labels):
        g_t, g_v, a_t, a_v = imu_streams[ii]
        assert len(g_t) == len(a_t) and np.allclose(g_t, a_t), (
            "session files need a common IMU clock; build SyntheticSession with "
            "gyro_hz == accel_hz"
        )
        t_ns = np.round(g_t * 1e9).astype(np.int64)
        sio.save_imu_samples(path / f"imu_samples_{label}.csv", t_ns, g_v, a_v)

    return {
        "q_bodyImu_device": q_bI_dev,
        "t_bodyImu_device": t_bI_dev,
        "rig_ts_us": rig_ts_us,
        "imu_mounts": imu_mounts,
        "imu_calibs": imu_calibs,
    }
