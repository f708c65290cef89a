"""Session-data I/O: the reference input directory layout and output files.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/session_data.py`
(reference interfaces/ark/session_data/SessionData.{h,cpp} and
interfaces/ark/io/*): loads and writes the same file set with the same
schemas —

  vrs_source_info.json            SLAM sensor layout (camera_ids, imu_ids)
  online_calibration.jsonl        per-frame calibration (MPS JSON-lines)
  factory_calibration.json        device factory calibration
  open_loop_trajectory.csv        per-frame poses/velocities (MPS columns)
  closed_loop_framerate_trajectory.csv
  session_observations.csv        point tracks
  imu_samples_<label>.csv         EuRoC-style raw IMU
  reset_events.json               optional tracker-reset timestamps

Loaded quantities use the reference's conventions (SessionData.cpp:278-316):
poses are converted device->bodyImu at load, T_Cam_BodyImu =
(T_bodyImu_device * T_Device_Camera)^-1, velocities corrected by
omega x t_device_bodyImu. The observation and IMU CSVs are parsed with
numpy (`np.loadtxt`); the JAX package's optional C++ parser is not ported.
Everything here is host numpy.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..models import imu as imu_model

# quaternion helpers on numpy (wxyz)


def _q_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _q_conj(q):
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def _q_rot(q, v):
    qv, w = q[..., 1:], q[..., :1]
    uv = np.cross(qv, v)
    return v + 2.0 * (w * uv + np.cross(qv, uv))


def _se3_mul(qa, ta, qb, tb):
    return _q_mul(qa, qb), ta + _q_rot(qa, tb)


def _se3_inv(q, t):
    qi = _q_conj(q)
    return qi, -_q_rot(qi, t)


@dataclasses.dataclass
class CameraCalib:
    label: str
    serial: str
    projection_name: str  # e.g. "FisheyeRadTanThinPrism" / "Linear"
    params: np.ndarray
    q_device_camera: np.ndarray  # (4,) wxyz
    t_device_camera: np.ndarray  # (3,)
    time_offset_sec: float = 0.0
    readout_time_sec: float | None = None
    image_size: tuple = (640, 480)


@dataclasses.dataclass
class ImuCalib:
    label: str
    calib23: np.ndarray  # models.imu data layout
    q_device_imu: np.ndarray
    t_device_imu: np.ndarray


@dataclasses.dataclass
class CalibrationState:
    timestamp_us: int
    cameras: list  # [CameraCalib]
    imus: list  # [ImuCalib]


@dataclasses.dataclass
class SessionData:
    """Mirrors reference SessionData (SessionData.h:56-98)."""

    slam_camera_serials: list
    slam_imu_labels: list
    q_bodyImu_device: np.ndarray
    t_bodyImu_device: np.ndarray
    factory: CalibrationState
    online: list  # [CalibrationState]
    # trajectory (bodyImu frame), one row per frame
    traj_timestamp_us: np.ndarray
    traj_pose_q: np.ndarray  # (N, 4) T_bodyImu_world rotation (wxyz)
    traj_pose_t: np.ndarray  # (N, 3)
    traj_vel_w: np.ndarray  # (N, 3)
    traj_omega: np.ndarray  # (N, 3) bodyImu frame
    traj_quality: np.ndarray
    traj_session_uid: list
    traj_utc_ns: np.ndarray
    # observations
    obs_point_id: np.ndarray
    obs_timestamp_us: np.ndarray
    obs_camera_index: np.ndarray
    obs_uv: np.ndarray
    obs_sqrt_h: np.ndarray  # (N, 2, 2)
    # imu measurements per SLAM imu index
    imu_times_ns: list  # [np.ndarray (S,)]
    imu_gyro: list  # [np.ndarray (S, 3)]
    imu_accel: list  # [np.ndarray (S, 3)]
    reset_timestamps_us: np.ndarray


def _camera_from_json(j) -> CameraCalib:
    T = j.get("T_Device_Camera", {})
    trans = np.asarray(T.get("Translation", [0, 0, 0]), float)
    uq = T.get("UnitQuaternion", [1.0, [0.0, 0.0, 0.0]])
    q = np.asarray([uq[0], *uq[1]], float)
    proj = j.get("Projection", {})
    return CameraCalib(
        label=j.get("Label", ""),
        serial=j.get("SerialNumber", ""),
        projection_name=proj.get("Name", "FisheyeRadTanThinPrism"),
        params=np.asarray(proj.get("Params", []), float),
        q_device_camera=q / np.linalg.norm(q),
        t_device_camera=trans,
        time_offset_sec=float(j.get("TimeOffsetSec_Device_Camera", 0.0)),
        readout_time_sec=j.get("ReadoutTimeSec", None),
        image_size=tuple(j.get("ImageSize", (640, 480))),
    )


def _camera_to_json(c: CameraCalib):
    out = {
        "Label": c.label,
        "SerialNumber": c.serial,
        "Projection": {"Name": c.projection_name, "Params": list(map(float, c.params))},
        "T_Device_Camera": {
            "Translation": list(map(float, c.t_device_camera)),
            "UnitQuaternion": [float(c.q_device_camera[0]), list(map(float, c.q_device_camera[1:]))],
        },
        "TimeOffsetSec_Device_Camera": float(c.time_offset_sec),
        "ImageSize": list(c.image_size),
    }
    if c.readout_time_sec is not None:
        out["ReadoutTimeSec"] = float(c.readout_time_sec)
    return out


def _imu_from_json(j) -> ImuCalib:
    T = j.get("T_Device_Imu", {})
    trans = np.asarray(T.get("Translation", [0, 0, 0]), float)
    uq = T.get("UnitQuaternion", [1.0, [0.0, 0.0, 0.0]])
    q = np.asarray([uq[0], *uq[1]], float)

    c = np.zeros(imu_model.CALIB_DIM)
    c[imu_model.GYRO_SCALE] = 1.0
    c[imu_model.ACCEL_SCALE] = 1.0
    accel = j.get("Accelerometer", {})
    gyro = j.get("Gyroscope", {})
    # rectification = scale * nonorth (ImuMeasurementModelParameters.h:102-116)
    gm = np.asarray(gyro.get("Model", {}).get("RectificationMatrix", np.eye(3).tolist()), float)
    am = np.asarray(accel.get("Model", {}).get("RectificationMatrix", np.eye(3).tolist()), float)
    g_scale = np.linalg.norm(gm, axis=1)
    a_scale = np.linalg.norm(am, axis=1)
    g_no = gm / g_scale[:, None]
    a_no = am / a_scale[:, None]
    c[imu_model.GYRO_SCALE] = g_scale
    c[imu_model.ACCEL_SCALE] = a_scale
    c[imu_model.GYRO_NONORTH] = [g_no[0, 1], g_no[0, 2], g_no[1, 0], g_no[1, 2], g_no[2, 0], g_no[2, 1]]
    c[imu_model.ACCEL_NONORTH] = [a_no[0, 1], a_no[0, 2], a_no[1, 2]]
    c[imu_model.GYRO_BIAS] = np.asarray(gyro.get("Bias", {}).get("Offset", [0, 0, 0]), float)
    c[imu_model.ACCEL_BIAS] = np.asarray(accel.get("Bias", {}).get("Offset", [0, 0, 0]), float)
    c[imu_model.DT_REF_GYRO] = float(j.get("TimeOffsetSec_Device_Gyro", 0.0))
    c[imu_model.DT_REF_ACCEL] = float(j.get("TimeOffsetSec_Device_Accel", 0.0))
    return ImuCalib(
        label=j.get("Label", ""), calib23=c, q_device_imu=q / np.linalg.norm(q), t_device_imu=trans
    )


def _imu_to_json(c: ImuCalib):
    cal = np.asarray(c.calib23, np.float64)
    ct = torch.from_numpy(cal)
    gm = imu_model.gyro_nonorth_matrix(ct).numpy() * cal[imu_model.GYRO_SCALE][:, None]
    am = imu_model.accel_nonorth_matrix(ct).numpy() * cal[imu_model.ACCEL_SCALE][:, None]
    return {
        "Label": c.label,
        "Accelerometer": {
            "Bias": {"Offset": list(map(float, cal[imu_model.ACCEL_BIAS]))},
            "Model": {"RectificationMatrix": am.tolist()},
        },
        "Gyroscope": {
            "Bias": {"Offset": list(map(float, cal[imu_model.GYRO_BIAS]))},
            "Model": {"RectificationMatrix": gm.tolist()},
        },
        "TimeOffsetSec_Device_Gyro": float(cal[imu_model.DT_REF_GYRO]),
        "TimeOffsetSec_Device_Accel": float(cal[imu_model.DT_REF_ACCEL]),
        "T_Device_Imu": {
            "Translation": list(map(float, c.t_device_imu)),
            "UnitQuaternion": [float(c.q_device_imu[0]), list(map(float, c.q_device_imu[1:]))],
        },
    }


def _calib_state_from_json(j, timestamp_us=0) -> CalibrationState:
    return CalibrationState(
        timestamp_us=int(j.get("tracking_timestamp_us", timestamp_us)),
        cameras=[_camera_from_json(cj) for cj in j.get("CameraCalibrations", [])],
        imus=[_imu_from_json(ij) for ij in j.get("ImuCalibrations", [])],
    )


def load_trajectory_csv(traj_path, bq, bt, use_closed):
    """Parse an MPS-format trajectory CSV and convert device -> bodyImu
    (reference SessionData.cpp:278-316). bq/bt = T_bodyImu_device. Returns
    (raw rows, timestamps_us, pose_q, pose_t (T_bodyImu_world), vel_world,
    omega_bodyImu)."""
    rows = np.genfromtxt(traj_path, delimiter=",", names=True, dtype=None, encoding="utf-8")
    rows = np.atleast_1d(rows)
    pre = "world" if use_closed else "odometry"
    t_dev = np.stack([rows[f"t{a}_{pre}_device" if not use_closed else f"t{a}_world_device"]
                      for a in "xyz"], -1)
    q_dev_xyzw = np.stack(
        [rows[f"q{a}_{'world' if use_closed else 'odometry'}_device"] for a in "xyzw"], -1
    )
    q_dev = np.concatenate([q_dev_xyzw[:, 3:4], q_dev_xyzw[:, :3]], axis=1)  # wxyz T_world_device
    vel_field = (
        "device_linear_velocity_x_device" if use_closed else "device_linear_velocity_x_odometry"
    )
    vel = np.stack([rows[vel_field.replace("_x_", f"_{a}_")] for a in "xyz"], -1)
    omega_dev = np.stack([rows[f"angular_velocity_{a}_device"] for a in "xyz"], -1)

    # convert device -> bodyImu (SessionData.cpp:278-316)
    dq, dt = _se3_inv(bq, bt)  # T_device_bodyImu
    qw_dev, tw_dev = q_dev, t_dev  # T_world_device
    q_w_bI, t_w_bI = _se3_mul(qw_dev, tw_dev, np.broadcast_to(dq, q_dev.shape),
                              np.broadcast_to(dt, t_dev.shape))
    q_bI_w, t_bI_w = _se3_inv(q_w_bI, t_w_bI)
    omega_bI = _q_rot(np.broadcast_to(bq, q_dev.shape), omega_dev)
    # velocity of the bodyImu origin in world frame:
    #   v_bI = v_dev + R_world_device (omega_dev x t_device_bodyImu)
    # (reference SessionData.cpp:278-316; closed-loop velocities are stored in
    # the device frame, open-loop in the odometry/world frame)
    dt_b = np.broadcast_to(dt, t_dev.shape)
    if use_closed:
        vel_w = _q_rot(qw_dev, vel + np.cross(omega_dev, dt_b))
    else:
        vel_w = vel + _q_rot(qw_dev, np.cross(omega_dev, dt_b))

    ts_us = rows["tracking_timestamp_us"].astype(np.int64)
    return rows, ts_us, q_bI_w, t_bI_w, vel_w, omega_bI


def _csv_columns(path):
    """(column names, float64 rows) of a numeric CSV with one header line."""
    with open(path) as f:
        names = [c.strip() for c in f.readline().strip().lstrip("#").split(",")]
    rows = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)
    return names, rows


def load_observations_csv(path):
    """(point_id, capture_timestamp_ns, camera_index, uv (N,2), sqrt_h
    (N,2,2)) of a session_observations.csv (save_observations.py:96-171)."""
    names, rows = _csv_columns(path)
    col = {n: rows[:, i] for i, n in enumerate(names)}
    # integer columns hold ids and nanosecond timestamps: parse them exactly
    ints = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2,
                      usecols=[names.index("point_id"), names.index("camera_index")])
    ts_field = ("capture_timestamp_ns" if "capture_timestamp_ns" in col
                else "capture_timestamp_us")
    ts = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=1,
                    usecols=[names.index(ts_field)])
    ts_ns = ts * (1 if ts_field.endswith("ns") else 1000)
    uv = np.stack([col["projection_base_res_x"], col["projection_base_res_y"]], -1)
    sh = np.stack([col["sqrt_h_base_res_00"], col["sqrt_h_base_res_01"],
                   col["sqrt_h_base_res_10"], col["sqrt_h_base_res_11"]], -1).reshape(-1, 2, 2)
    return ints[:, 0], ts_ns, ints[:, 1].astype(np.int32), uv, sh


def load_imu_csv(path):
    """(times_ns, gyro (S,3), accel (S,3)) of an EuRoC-style IMU CSV
    (ImuDataFormat.h:14-23)."""
    t = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=1, usecols=[0])
    arr = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2,
                     usecols=range(2, 8))
    return t, arr[:, 0:3], arr[:, 3:6]


def load_session(path, load_imu=True) -> SessionData:
    """Reference SessionData::load (SessionData.cpp:81-359)."""
    path = Path(path)
    with open(path / "vrs_source_info.json") as f:
        src = json.load(f)
    slam_cams = list(src["camera_ids"])
    slam_imus = list(src["imu_ids"])

    # online calibration (JSON lines)
    online = []
    with open(path / "online_calibration.jsonl") as f:
        for line in f:
            line = line.strip()
            if line:
                online.append(_calib_state_from_json(json.loads(line)))
    if not online:
        raise RuntimeError("Unable to load online calib!")

    # factory calibration
    with open(path / "factory_calibration.json") as f:
        factory = _calib_state_from_json(json.load(f))

    # body imu = first SLAM imu; T_bodyImu_device from factory T_Device_Imu
    body_label = slam_imus[0]
    fact_imu = {i.label: i for i in factory.imus}
    if body_label not in fact_imu:
        raise RuntimeError(f"body imu {body_label} not in factory calibration")
    bq, bt = _se3_inv(fact_imu[body_label].q_device_imu, fact_imu[body_label].t_device_imu)

    # trajectory: prefer closed_loop_framerate, else open_loop
    closed = path / "closed_loop_framerate_trajectory.csv"
    open_loop = path / "open_loop_trajectory.csv"
    use_closed = closed.exists()
    traj_path = closed if use_closed else open_loop
    rows, ts_us, q_bI_w, t_bI_w, vel_w, omega_bI = load_trajectory_csv(
        traj_path, bq, bt, use_closed
    )
    utc = (
        rows["utc_timestamp_ns"].astype(np.int64)
        if "utc_timestamp_ns" in rows.dtype.names
        else np.zeros(len(ts_us), np.int64)
    )
    qual = (
        rows["quality_score"].astype(float)
        if "quality_score" in rows.dtype.names
        else np.ones(len(ts_us))
    )
    uid_field = "graph_uid" if use_closed else "session_uid"
    uids = (
        [str(u) for u in rows[uid_field]]
        if uid_field in rows.dtype.names
        else [""] * len(ts_us)
    )

    obs_pid, obs_ts_ns, obs_cam, obs_uv, sh = load_observations_csv(
        path / "session_observations.csv")
    imu_times, imu_gyro, imu_accel = [], [], []
    if load_imu:
        for label in slam_imus:
            t, g, a = load_imu_csv(path / f"imu_samples_{label}.csv")
            imu_times.append(t)
            imu_gyro.append(g)
            imu_accel.append(a)

    resets = np.zeros(0, np.int64)
    rp = path / "reset_events.json"
    if rp.exists():
        with open(rp) as f:
            resets = np.asarray(json.load(f)["reset_events"], np.int64)

    return SessionData(
        slam_camera_serials=slam_cams,
        slam_imu_labels=slam_imus,
        q_bodyImu_device=bq,
        t_bodyImu_device=bt,
        factory=factory,
        online=online,
        traj_timestamp_us=ts_us,
        traj_pose_q=q_bI_w,
        traj_pose_t=t_bI_w,
        traj_vel_w=vel_w,
        traj_omega=omega_bI,
        traj_quality=qual,
        traj_session_uid=uids,
        traj_utc_ns=utc,
        obs_point_id=obs_pid,
        obs_timestamp_us=obs_ts_ns // 1000,
        obs_camera_index=obs_cam,
        obs_uv=obs_uv,
        obs_sqrt_h=sh,
        imu_times_ns=imu_times,
        imu_gyro=imu_gyro,
        imu_accel=imu_accel,
        reset_timestamps_us=resets,
    )


# ---------------------------------------------------------------------------
# Writers of the session files (reference interfaces/ark/io/
# SaveDeviceTrajectory.cpp:16-115); the output writers of the CLI
# (open-loop trajectory, online calibration) come with the CLI
# ---------------------------------------------------------------------------

CLOSE_LOOP_COLUMNS = [
    "graph_uid", "tracking_timestamp_us", "utc_timestamp_ns",
    "tx_world_device", "ty_world_device", "tz_world_device",
    "qx_world_device", "qy_world_device", "qz_world_device", "qw_world_device",
    "device_linear_velocity_x_device", "device_linear_velocity_y_device",
    "device_linear_velocity_z_device",
    "angular_velocity_x_device", "angular_velocity_y_device", "angular_velocity_z_device",
    "gravity_x_world", "gravity_y_world", "gravity_z_world", "quality_score",
]


def _device_states(sd: SessionData, pose_q, pose_t, vel, omega, gravity):
    """Per-rig device-frame quantities shared by both writers."""
    bq, bt = sd.q_bodyImu_device, sd.t_bodyImu_device
    # T_world_device = T_bodyImu_world^-1 * T_bodyImu_device
    qi, ti = _se3_inv(pose_q, pose_t)
    q_w_dev, t_w_dev = _se3_mul(qi, ti, np.broadcast_to(bq, pose_q.shape),
                                np.broadcast_to(bt, pose_t.shape))
    omega_dev = _q_rot(np.broadcast_to(_q_conj(bq), pose_q.shape), omega)
    return q_w_dev, t_w_dev, omega_dev


def save_close_loop_trajectory(path, sd: SessionData, pose_q, pose_t, vel, omega, gravity):
    q_w_dev, t_w_dev, omega_dev = _device_states(sd, pose_q, pose_t, vel, omega, gravity)
    bq, bt = sd.q_bodyImu_device, sd.t_bodyImu_device
    # velocity of device origin, in DEVICE frame (SaveDeviceTrajectory.cpp:137-140)
    vel_dev = _q_rot(
        np.broadcast_to(_q_conj(bq), pose_q.shape),
        _q_rot(pose_q, vel) + np.cross(omega, np.broadcast_to(bt, pose_t.shape)),
    )
    with open(path, "w") as f:
        f.write(",".join(CLOSE_LOOP_COLUMNS) + "\n")
        for i in range(len(pose_q)):
            q = q_w_dev[i]
            f.write(
                f"{sd.traj_session_uid[i]},{sd.traj_timestamp_us[i]},{sd.traj_utc_ns[i]},"
                f"{t_w_dev[i,0]},{t_w_dev[i,1]},{t_w_dev[i,2]},"
                f"{q[1]},{q[2]},{q[3]},{q[0]},"
                f"{vel_dev[i,0]},{vel_dev[i,1]},{vel_dev[i,2]},"
                f"{omega_dev[i,0]},{omega_dev[i,1]},{omega_dev[i,2]},"
                f"{gravity[0]},{gravity[1]},{gravity[2]},{sd.traj_quality[i]}\n"
            )


def save_observations(path, point_id, timestamp_us, camera_index, uv, sqrt_h):
    pid = np.asarray(point_id).tolist()
    ts = (np.asarray(timestamp_us, np.int64) * 1000).tolist()
    cam = np.asarray(camera_index).tolist()
    uvl = np.asarray(uv).tolist()
    shl = np.asarray(sqrt_h).reshape(-1, 4).tolist()
    with open(path, "w") as f:
        f.write(
            "point_id,capture_timestamp_ns,camera_index,projection_base_res_x,"
            "projection_base_res_y,sqrt_h_base_res_00,sqrt_h_base_res_01,"
            "sqrt_h_base_res_10,sqrt_h_base_res_11\n"
        )
        f.writelines(f"{p},{t},{c},{u[0]},{u[1]},{h[0]},{h[1]},{h[2]},{h[3]}\n"
                     for p, t, c, u, h in zip(pid, ts, cam, uvl, shl))


def save_imu_samples(path, times_ns, gyro, accel):
    tl = np.asarray(times_ns).tolist()
    gl, al = np.asarray(gyro).tolist(), np.asarray(accel).tolist()
    with open(path, "w") as f:
        f.write(
            "#timestamp [ns],temperature [degC],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
            "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]\n"
        )
        f.writelines(f"{t},0.0,{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n"
                     for t, g, a in zip(tl, gl, al))
