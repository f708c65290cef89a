"""Session adapter: builds the full optimization problem from SessionData.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/adapter.py`
(reference viba/single_session/{Matcher,SingleSessionAdapter,InitRigs,
InitCalibration,VisualFactors,InertialFactors,RandomWalkFactors,
FactoryCalibPriors,OmegaPriors}.cpp):

  - rig index set = sorted intersection of trajectory and online-calibration
    timestamps (Matcher.cpp:19-59)
  - calibration windows of at most 5 s per sensor group
    (InitCalibration.cpp:162-183), initialized from the online calibration at
    each window's last rig, chained by random-walk factors whose precision is
    1 / (rate * dt) (RandomWalkFactors.cpp:36-152)
  - factory-calibration priors with std-dev inflation and reference-count
    scaling (FactoryCalibPriors.cpp:33-145)
  - preintegrated inertial factors per (consecutive-rig-pair, imu) with a 10 s
    max gap (InertialFactors.cpp:17-100), secondary IMUs via extrinsics
  - omega priors per (rig, imu) when >= 2 IMUs (OmegaPriors.cpp:19-31)
  - visual factors per inlier observation after triangulation, rolling-shutter
    ones with per-rig RS tables (VisualFactors.cpp:16-62)
  - rig states from the trajectory, optionally anchored to map keyrigs or
    overridden from a ground-truth trajectory (pipeline/init_rigs.py)

Setup numerics (triangulation, preintegration, RS tables) run batched in
float64 on `device`; the factor batches are assembled on the host, and the
finished problem moves to `device` as `dtype` in one pass at the end of
build(). The device is the first CUDA card unless the caller asks for
another. `recompute_preintegrations` re-runs the preintegration on the
device at the current calibration (the --recompute-preint pre-step).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models import imu as imu_model
from ..ops import camera as cam_ops
from ..ops import losses
from ..ops import preintegration as pre
from ..ops import rolling_shutter as rs
from ..problem import factors as fct
from ..problem.optimizer import Problem
from ..problem.structure import GRAVITY_MAG, VariableTables, full_masks
from . import init_rigs as ir
from . import triangulation as tri
from .builder import REPROJ_LOSS, chol_inv_lower, default_device
from .session_data import SessionData, _se3_inv, _se3_mul

# reference InitCalibration.cpp:162-166
CALIB_WINDOW_SEC = 5.0
# reference InertialFactors.cpp:43
MAX_INERTIAL_GAP_SEC = 10.0
# reference Constants.h:19
OMEGA_PRIOR_STD = 10.0 * np.pi / 180.0
# reference RandomWalkCov.cpp (camera_model)
CAM_PROJ_RW_VAR = 1e-6
CAM_DIST_RW_VAR = 1e-10
CAM_TIME_RW_VAR = 1e-10
CAM_PROJ_TURNON_STD = 1.0
CAM_DIST_TURNON_STD = 1e-3
CAM_READOUT_TURNON_STD = 0.01
CAM_TOFF_TURNON_STD = 0.01
# reference RandomWalkCov.cpp (extrinsics_model) + FactoryCalibPriors.cpp:80-81
CAM_EXTR_RW_VAR_POS = (1e-3 * np.pi / 180.0) ** 2
CAM_EXTR_RW_VAR_ROT = 1e-11
CAM_EXTR_TURNON_POS = 4e-4
CAM_EXTR_TURNON_ROT = 0.2 * np.pi / 180.0

F64 = torch.float64


@dataclasses.dataclass
class AdapterOptions:
    """Counterpart of reference InitSettings (viba/common/Settings.h:21-65)."""

    estimate_cam_intr: bool = True
    estimate_cam_extr: bool = True
    estimate_imu_calib: bool = True
    estimate_imu_extr: bool = True
    estimate_gravity: bool = True
    factory_init: bool = False
    imu_options: dict = dataclasses.field(
        default_factory=lambda: dict(
            accelBias=True, gyroBias=True, accelScale=True, gyroScale=True,
            accelNonorth=True, gyroNonorth=True,
            refImuTimeOffset=True, gyroAccelTimeOffset=True,
        )
    )
    estimate_readout: bool = False  # rolling-shutter cameras only
    estimate_cam_time_offset: bool = False
    factory_prior_inflate: float = 100.0  # Settings.h:49-52
    rw_inflate: float = 1.0
    # per-group overrides of the two inflates (cam_intr|cam_extr|imu_calib|imu_extr)
    fprio_inflates: dict = dataclasses.field(default_factory=dict)
    rw_inflates: dict = dataclasses.field(default_factory=dict)
    reproj_loss: tuple = REPROJ_LOSS
    imu_loss: tuple = (losses.TRIVIAL, 0.0, 0.0)
    rig_start: int = -1
    rig_end: int = -1
    fix_first_rig_gauge: bool = False
    rigs_constant: bool = False
    use_detector_bias: bool = False
    max_track_len: int = 64  # padding bound for triangulation
    # trajectory init overrides (Settings.h:34-37; tokens pose|vel|omega|all)
    trajectory_to_gt: tuple = ()  # components initialized from gt_trajectory
    trajectory_constant: tuple = ()  # components held constant
    gt_trajectory: object = None  # init_rigs.InterpolatedTrajectory-like
    # map-anchored init (initRigsInterpolatingPoses): (kr_timestamps_us,
    # kr_pose_q, kr_pose_t), poses T_bodyImu_world in the map world frame;
    # rigs outside the grown keyrig ranges stay on the raw trajectory
    map_keyrigs: tuple = None
    rig_window_grow: int = 10  # SingleSessionAdapter.h:101


class SessionAdapter:
    def __init__(self, sd: SessionData, opts: AdapterOptions | None = None, log=print, *,
                 device=None, dtype=torch.float32):
        self.sd = sd
        self.opts = opts or AdapterOptions()
        self.log = log or (lambda *a: None)
        self.device = torch.device(device) if device is not None else default_device()
        self.dtype = dtype
        self.timings = {}  # seconds per build stage (host clock)
        self._match()

    # -- Matcher (reference Matcher.cpp) ------------------------------------

    def _match(self):
        sd = self.sd
        online_ts = np.asarray([c.timestamp_us for c in sd.online], np.int64)
        rig_ts = np.intersect1d(sd.traj_timestamp_us, online_ts)
        start = max(self.opts.rig_start, 0)
        end = self.opts.rig_end if self.opts.rig_end >= 0 else len(rig_ts)
        rig_ts = rig_ts[start:end]
        self.rig_ts_us = rig_ts
        self.R = len(rig_ts)
        if self.R == 0:
            raise RuntimeError("no rigs: trajectory and online calib timestamps disjoint")
        self.traj_row = {t: i for i, t in enumerate(sd.traj_timestamp_us.tolist())}
        self.online_row = {t: i for i, t in enumerate(online_ts.tolist())}
        self.ts_to_rig = {t: i for i, t in enumerate(rig_ts.tolist())}

        oc = sd.online[0]
        self.num_cams = len(oc.cameras)
        self.num_imus = len(oc.imus)
        fact_cam_by_serial = {c.serial: i for i, c in enumerate(sd.factory.cameras)}
        fact_imu_by_label = {c.label: i for i, c in enumerate(sd.factory.imus)}
        self.cam_to_factory = [fact_cam_by_serial.get(c.serial, min(i, len(sd.factory.cameras) - 1))
                               for i, c in enumerate(oc.cameras)]
        self.imu_to_factory = [fact_imu_by_label.get(c.label, min(i, len(sd.factory.imus) - 1))
                               for i, c in enumerate(oc.imus)]

        # rig windows of <= 5 s (InitCalibration.cpp:169-183)
        win = np.zeros(self.R, np.int64)
        w, start_t = 0, rig_ts[0]
        max_len_us = int(CALIB_WINDOW_SEC * 1e6)
        for i, t in enumerate(rig_ts.tolist()):
            if i > 0 and t - start_t >= max_len_us:
                w += 1
                start_t = t
            win[i] = w
        self.rig_window = win
        self.num_windows = int(win.max()) + 1
        self.window_last_rig = np.asarray(
            [np.nonzero(win == k)[0].max() for k in range(self.num_windows)])
        self.window_mid_ts = np.asarray([rig_ts[win == k].mean() for k in range(self.num_windows)])

    # -- calibration helpers -------------------------------------------------

    def _T_cam_bodyImu(self, calib_state, ci):
        """(T_bodyImu_device * T_Device_Camera)^-1 (SessionData.cpp:252-254)."""
        sd, c = self.sd, calib_state.cameras[ci]
        q, t = _se3_mul(sd.q_bodyImu_device, sd.t_bodyImu_device, c.q_device_camera,
                        c.t_device_camera)
        return _se3_inv(q, t)

    def _T_imu_bodyImu(self, calib_state, ii):
        sd, c = self.sd, calib_state.imus[ii]
        q, t = _se3_mul(sd.q_bodyImu_device, sd.t_bodyImu_device, c.q_device_imu, c.t_device_imu)
        return _se3_inv(q, t)

    def _cam_param_vec(self, calib_state, ci):
        c = calib_state.cameras[ci]
        p = np.zeros(cam_ops.MAX_PARAMS)
        p[: len(c.params)] = c.params
        p[cam_ops.READOUT] = c.readout_time_sec or 0.0
        p[cam_ops.TIME_OFFSET] = c.time_offset_sec
        return p

    def camera_kind(self, ci):
        name = self.sd.online[0].cameras[ci].projection_name
        return cam_ops.KIND_LINEAR if "Linear" in name else cam_ops.KIND_FISHEYE624

    def is_rolling_shutter(self, ci):
        c = self.sd.online[0].cameras[ci]
        return (c.readout_time_sec is not None) or self.opts.estimate_readout

    def has_time_offset(self, ci):
        c = self.sd.online[0].cameras[ci]
        return self.opts.estimate_cam_time_offset or c.time_offset_sec != 0.0

    def _fprio(self, group):
        """Factory-prior inflate of a calib group; <= 0 disables its priors
        (SingleSessionAdapter.cpp:113-126)."""
        return self.opts.fprio_inflates.get(group, self.opts.factory_prior_inflate)

    def _rw_infl(self, group):
        return self.opts.rw_inflates.get(group, self.opts.rw_inflate)

    def imu_noise_model(self, ii):
        """Per-IMU noise model keyed by label (SessionData.cpp:210-224)."""
        return imu_model.noise_model_for_label(self.sd.online[0].imus[ii].label, F64,
                                               self.device)

    # -- main entry ----------------------------------------------------------

    def build(self) -> Problem:
        opts, sd = self.opts, self.sd
        W, nC, nI = self.num_windows, self.num_cams, self.num_imus
        n_sec = max(nI - 1, 0)

        # rig states from the trajectory (InitRigs.cpp:133-139)
        rows = np.asarray([self.traj_row[t] for t in self.rig_ts_us.tolist()])
        pose_q, pose_t = sd.traj_pose_q[rows], sd.traj_pose_t[rows]
        vel, omega = sd.traj_vel_w[rows], sd.traj_omega[rows]

        # map-anchored init (initRigsInterpolatingPoses, InitRigs.cpp:236-400)
        if opts.map_keyrigs is not None:
            kr_ts, kr_q, kr_t = opts.map_keyrigs
            kr_rig = np.asarray([self.ts_to_rig[int(t)] for t in kr_ts], np.int64)
            reset_rigs = [self.ts_to_rig[t] for t in getattr(sd, "reset_timestamps_us", [])
                          if t in self.ts_to_rig]
            pose_q, pose_t, vel, omega, _, _ = ir.init_rigs_interpolating_poses(
                pose_q, pose_t, vel, omega, self.rig_ts_us, kr_rig, np.asarray(kr_q),
                np.asarray(kr_t), reset_rig_indices=reset_rigs,
                rig_window_grow=opts.rig_window_grow, log=self.log)

        # GT-trajectory overrides (initRigsFromGtTrajectory, InitRigs.cpp:146-230)
        to_gt = set(opts.trajectory_to_gt)
        if "all" in to_gt:
            to_gt = {"pose", "vel", "omega"}
        if opts.gt_trajectory is not None and to_gt:
            pose_q, pose_t, vel, omega = ir.init_rigs_from_gt(
                pose_q, pose_t, vel, omega, self.rig_ts_us, opts.gt_trajectory,
                pose_to_gt="pose" in to_gt, vel_to_gt="vel" in to_gt,
                omega_to_gt="omega" in to_gt)

        # calibration window variables, value at each window's LAST rig
        calib_src = sd.factory if opts.factory_init else None
        cam_intr = np.zeros((W * nC, cam_ops.MAX_PARAMS))
        cam_extr_q, cam_extr_t = np.zeros((W * nC, 4)), np.zeros((W * nC, 3))
        imu_calib = np.zeros((W * nI, imu_model.CALIB_DIM))
        imu_extr_q, imu_extr_t = np.zeros((W * n_sec, 4)), np.zeros((W * n_sec, 3))
        for w in range(W):
            last_rig_ts = int(self.rig_ts_us[self.window_last_rig[w]])
            st = calib_src or sd.online[self.online_row[last_rig_ts]]
            for ci in range(nC):
                fci = self.cam_to_factory[ci] if calib_src else ci
                cam_intr[w * nC + ci] = self._cam_param_vec(st, fci)
                cam_extr_q[w * nC + ci], cam_extr_t[w * nC + ci] = self._T_cam_bodyImu(st, fci)
            for ii in range(nI):
                fii = self.imu_to_factory[ii] if calib_src else ii
                imu_calib[w * nI + ii] = st.imus[fii].calib23
                if ii >= 1:
                    q, t = self._T_imu_bodyImu(st, fii)
                    imu_extr_q[w * n_sec + (ii - 1)], imu_extr_t[w * n_sec + (ii - 1)] = q, t
        gravity = np.array([0.0, 0.0, -GRAVITY_MAG])  # odometry frames are gravity-aligned

        # observation -> rig matching (drop obs at non-rig timestamps)
        pos = np.clip(np.searchsorted(self.rig_ts_us, sd.obs_timestamp_us), 0, self.R - 1)
        keep = self.rig_ts_us[pos] == sd.obs_timestamp_us
        obs_rig, obs_cam = pos[keep], sd.obs_camera_index[keep]
        obs_uv, obs_sqrt_h, obs_pid = sd.obs_uv[keep], sd.obs_sqrt_h[keep], sd.obs_point_id[keep]

        # track filtering (>= 3 obs, InitPointTracks.cpp:17-65)
        _, inv, counts = np.unique(obs_pid, return_inverse=True, return_counts=True)
        keep2 = counts[inv] >= tri.MIN_INLIER_OBS
        obs_rig, obs_cam = obs_rig[keep2], obs_cam[keep2]
        obs_uv, obs_sqrt_h, obs_pid = obs_uv[keep2], obs_sqrt_h[keep2], obs_pid[keep2]
        uniq, inv = np.unique(obs_pid, return_inverse=True)
        obs_point = inv.astype(np.int64)  # dense landmark index

        t0 = time.perf_counter()
        points, obs_inlier = self._triangulate(
            uniq, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h, pose_q, pose_t, cam_intr,
            cam_extr_q, cam_extr_t)
        self.timings["triangulation"] = time.perf_counter() - t0

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float64))

        v = VariableTables(
            pose_q=t(pose_q), pose_t=t(pose_t), vel=t(vel), omega=t(omega), points=t(points),
            gravity=t(gravity), cam_intr=t(cam_intr), cam_extr_q=t(cam_extr_q),
            cam_extr_t=t(cam_extr_t), imu_calib=t(imu_calib), imu_extr_q=t(imu_extr_q),
            imu_extr_t=t(imu_extr_t), det_bias=torch.zeros((nC, 2), dtype=F64))
        problem = Problem(v, self._masks(v))
        self.problem = problem

        # rolling-shutter tables must exist before RS visual batches
        self._rs_tables = None
        if any(self.is_rolling_shutter(ci) or self.has_time_offset(ci) for ci in range(nC)):
            t0 = time.perf_counter()
            self._rs_tables = self._build_rs_tables(v)
            self.timings["rs_tables"] = time.perf_counter() - t0

        self._add_visual(problem, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h, obs_inlier)
        t0 = time.perf_counter()
        self._add_inertial(problem, imu_calib)
        self.timings["preintegration"] = time.perf_counter() - t0
        self._add_random_walks(problem)
        self._add_factory_priors(problem)
        self._add_omega_priors(problem)
        # the host-built problem lands on the device in one pass
        t0 = time.perf_counter()
        problem.to(self.device, self.dtype)
        self.timings["to_device"] = time.perf_counter() - t0
        if self._rs_tables is not None:
            self._rs_tables = next(d["rs_tables"] for c, d in zip(problem.cfgs, problem.datas)
                                   if c.kind == "rs_visual")
        return problem

    # -- masks ---------------------------------------------------------------

    def _masks(self, v):
        opts = self.opts
        masks = full_masks(v)
        rig = masks.rig.clone()
        if opts.rigs_constant:
            rig[:] = 0.0
        const = set(opts.trajectory_constant)
        if "all" in const:
            const = {"pose", "vel", "omega"}
        if "pose" in const:
            rig[:, 0:6] = 0.0
        if "vel" in const:
            rig[:, 6:9] = 0.0
        if "omega" in const:
            rig[:, 9:12] = 0.0
        if opts.fix_first_rig_gauge:
            rig[0] = 0.0
        masks = masks._replace(rig=rig)
        if not opts.estimate_gravity:
            masks = masks._replace(gravity=torch.zeros_like(masks.gravity))

        ci_mask = np.zeros(tuple(v.cam_intr.shape), bool)
        if opts.estimate_cam_intr:
            for w in range(self.num_windows):
                for ci in range(self.num_cams):
                    row = w * self.num_cams + ci
                    ci_mask[row, :cam_ops.NUM_MODEL_PARAMS[self.camera_kind(ci)]] = True
                    if self.is_rolling_shutter(ci) and opts.estimate_readout:
                        ci_mask[row, cam_ops.READOUT] = True
                    if opts.estimate_cam_time_offset:
                        ci_mask[row, cam_ops.TIME_OFFSET] = True
        masks = masks._replace(cam_intr=torch.from_numpy(ci_mask.astype(np.float64)))
        if not opts.estimate_cam_extr:
            masks = masks._replace(cam_extr=torch.zeros_like(masks.cam_extr))
        imu_mask = (imu_model.options_mask(**opts.imu_options) if opts.estimate_imu_calib
                    else np.zeros(imu_model.CALIB_DIM, bool))
        self.imu_calib_mask = imu_mask
        masks = masks._replace(imu_calib=torch.from_numpy(
            np.broadcast_to(imu_mask.astype(np.float64), tuple(v.imu_calib.shape)).copy()))
        if not opts.estimate_imu_extr:
            masks = masks._replace(imu_extr=torch.zeros_like(masks.imu_extr))
        if not opts.use_detector_bias:
            masks = masks._replace(det_bias=torch.zeros_like(masks.det_bias))
        return masks

    # -- triangulation -------------------------------------------------------

    def _triangulate(self, uniq, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h,
                     pose_q, pose_t, cam_intr, cam_extr_q, cam_extr_t):
        T = min(self.opts.max_track_len, int(np.bincount(obs_point).max()))
        L = len(uniq)
        nC = self.num_cams
        wrow = self.rig_window[obs_rig] * nC + obs_cam
        cq, ct = _se3_mul(cam_extr_q[wrow], cam_extr_t[wrow], pose_q[obs_rig],
                          pose_t[obs_rig])  # T_cam_world
        intr = cam_intr[wrow]

        # per-track slot of each observation (its rank within its track, < T)
        n_obs = len(obs_point)
        order = np.argsort(obs_point, kind="stable")
        counts = np.bincount(obs_point, minlength=L)
        track_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        obs_slot = np.empty(n_obs, np.int64)
        obs_slot[order] = np.arange(n_obs) - track_start[obs_point[order]]
        obs_slot = np.where(obs_slot < T, obs_slot, -1)
        sel = obs_slot >= 0
        dev = self.device

        def padded(x):
            out = np.zeros((L, T) + x.shape[1:], np.float64)
            out[obs_point[sel], obs_slot[sel]] = x[sel]
            return torch.from_numpy(out).to(dev)

        valid = np.zeros((L, T), bool)
        valid[obs_point[sel], obs_slot[sel]] = True
        pts, ok, inl = tri.triangulate_tracks(
            torch.from_numpy(uniq).to(dev), padded(cq), padded(ct), padded(intr), padded(obs_uv),
            padded(obs_sqrt_h), torch.from_numpy(valid).to(dev), camera_kind=self.camera_kind(0))
        pts, ok, inl = pts.cpu().numpy(), ok.cpu().numpy(), inl.cpu().numpy()
        self.log(f"triangulated {ok.sum()}/{L} tracks")
        obs_inlier = np.zeros(n_obs, bool)
        obs_inlier[sel] = inl[obs_point[sel], obs_slot[sel]] & ok[obs_point[sel]]
        pts = np.where(ok[:, None], pts, np.nan_to_num(pts))
        return pts, obs_inlier

    # -- factor wiring -------------------------------------------------------

    def _add_visual(self, problem, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h, inlier):
        nC = self.num_cams
        for ci in range(nC):
            sel = (obs_cam == ci) & inlier
            if not sel.any():
                continue
            n = int(sel.sum())
            wrow = self.rig_window[obs_rig[sel]] * nC + ci
            data = fct.make_visual_batch(
                point=obs_point[sel], rig=obs_rig[sel], intr=wrow, extr=wrow,
                bias=np.full(n, ci), obs_uv=obs_uv[sel], sqrt_h=obs_sqrt_h[sel],
                bias_on=np.full(n, 1.0 if self.opts.use_detector_bias else 0.0))
            if self.is_rolling_shutter(ci) or self.has_time_offset(ci):
                data = {k: a for k, a in data.items() if k not in ("bias", "bias_on")}
                data["rs_row"] = data["rig"]  # tables indexed per rig
                data["rs_tables"] = self._rs_tables
                h = self.sd.online[0].cameras[ci].image_size[1]
                # per-row capture-time fraction (constant per observation)
                data["rs_tpf"] = data["obs_uv"][:, 1] / float(h) - 0.5
                problem.add_batch(
                    fct.BatchCfg(kind="rs_visual", loss=self.opts.reproj_loss,
                                 camera_kind=self.camera_kind(ci), label=f"rs_visual_cam{ci}",
                                 image_height=float(h)), data)
            else:
                problem.add_batch(
                    fct.BatchCfg(kind="visual", loss=self.opts.reproj_loss,
                                 camera_kind=self.camera_kind(ci), label=f"visual_cam{ci}"),
                    data)

    def _rs_half_length(self):
        """Integration span around the frame midpoint: readout/2 + |time
        offset| + slack (InitCalibration.cpp:195-297)."""
        half = 0.01
        for ci in range(self.num_cams):
            c = self.sd.online[0].cameras[ci]
            ro = c.readout_time_sec or (0.03 if self.opts.estimate_readout else 0.0)
            half = max(half, ro / 2 + abs(c.time_offset_sec) + 0.01)
        return half

    def _build_rs_tables(self, v):
        """Per-rig RS tables from the body-IMU stream at the calibration and
        gravity of `v` (updateRollingShutterData, InitCalibration.cpp:
        299-325), in float64 on the device."""
        if getattr(self, "_rs_intervals", None) is None:
            half = self._rs_half_length()
            rig_t = self.rig_ts_us.astype(np.float64) * 1e-6
            iv1, n1 = self._intervals_for(0, rig_t - half, rig_t, slack=0.02)
            iv2, n2 = self._intervals_for(0, rig_t, rig_t + half, slack=0.02)
            self._rs_intervals = (iv1, iv2, max(n1, n2))
        iv1, iv2, num_steps = self._rs_intervals
        dev = self.device
        calib_rows = torch.from_numpy(self.rig_window * self.num_imus).to(dev)
        calibs = v.imu_calib.to(dev, F64).index_select(0, calib_rows)
        return rs.build_rs_tables(calibs, iv1, iv2, v.gravity.to(dev, F64), num_steps,
                                  num_steps + 2)

    def update_rolling_shutter_data(self):
        """Refresh the RS tables at the current estimates and swap them into
        all rs_visual batches (the reference pre-step refresh, main:95-101)."""
        if self._rs_tables is None:
            return
        self._rs_tables = rs.tables_to(self._build_rs_tables(self.problem.variables),
                                       self.device, self.dtype)
        for cfg, data in zip(self.problem.cfgs, self.problem.datas):
            if cfg.kind == "rs_visual":
                data["rs_tables"] = self._rs_tables

    def recompute_preintegrations(self):
        """Re-run the preintegration on the device, in float64, at the
        CURRENT calibration estimates and refresh every inertial batch (the
        reference's --recompute-preint pre-step, main_AriaKit_ViBa.cpp:95-101
        + regenerateAllPreintegrationsFromImuMeasurements). The build-time
        buckets are kept on the device (`_preint_cache`), each with the batch
        rows of its intervals; a row whose interval turns invalid keeps its
        sqrt information."""
        v = self.problem.variables
        for cfg, data in zip(self.problem.cfgs, self.problem.datas):
            if cfg.kind not in ("inertial", "inertial_secondary"):
                continue
            ii = 0 if cfg.kind == "inertial" else int(cfg.label.rsplit("imu", 1)[-1])
            noise = self.imu_noise_model(ii)
            for iv, num_steps, rows in self._preint_cache[ii]:
                calibs = v.imu_calib.index_select(0, data["calib"].index_select(0, rows).long())
                p = pre.preintegrate_batch(calibs.to(F64), iv, noise, num_steps)
                sqrt_info = torch.where(p.valid[:, None, None], chol_inv_lower(p.cov),
                                        data["sqrt_info"].index_select(0, rows).to(F64))
                for key, val in (("preint_q", p.rvp.q), ("preint_dv", p.rvp.dV),
                                 ("preint_dp", p.rvp.dP), ("preint_dt", p.rvp.dt),
                                 ("preint_J", p.J), ("calib_eval", p.calib_eval),
                                 ("sqrt_info", sqrt_info)):
                    data[key] = data[key].index_copy(0, rows, val.to(data[key].dtype))

    def make_pre_step_callback(self, recompute_preint: bool = False):
        """Pre-step hook for the LM loop (reference preStepCallback): after
        the first iteration, optionally recompute the preintegrations, then
        refresh the RS tables."""

        def cb(iteration, problem):
            if iteration == 0:
                return
            if recompute_preint:
                self.recompute_preintegrations()
            self.update_rolling_shutter_data()

        return cb

    def _imu_stream(self, ii):
        sd = self.sd
        return sd.imu_times_ns[ii].astype(np.float64) * 1e-9, sd.imu_gyro[ii], sd.imu_accel[ii]

    def _intervals_for(self, ii, t0s, t1s, slack=0.05, S=None):
        """Padded PreintInterval batch (on the device, float64) for [t0, t1]
        second ranges; `S` fixes the per-interval sample padding (default:
        the longest interval of the call). Returns (interval, num_steps)."""
        t_abs, gyro, accel = self._imu_stream(ii)
        rate = 1.0 / max(np.diff(t_abs).min(), 1e-5)
        t0s, t1s = np.asarray(t0s, np.float64), np.asarray(t1s, np.float64)
        if S is None:
            S = int(np.ceil(float((t1s - t0s).max() + 2 * slack) * rate)) + 4
        i0 = np.maximum(np.searchsorted(t_abs, t0s - slack), 0)
        idx = i0[:, None] + np.arange(S)[None, :]
        inside = idx < len(t_abs)
        idx_c = np.minimum(idx, len(t_abs) - 1)
        out_t = np.where(inside, t_abs[idx_c] - t0s[:, None], 1e9)
        gv = np.where(inside[..., None], gyro[idx_c], 0.0)
        av = np.where(inside[..., None], accel[idx_c], 0.0)
        dev = self.device

        def d(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dev)

        iv = pre.PreintInterval(d(out_t), d(gv), d(out_t), d(av), d(t1s - t0s))
        return iv, 2 * S + 4

    def _preintegrate_pairs(self, ii, t0s, t1s, calibs, noise, slack=0.05):
        """Batched preintegration over [t0, t1] pairs, grouped by the pow-2
        bucket of each interval's sample count (each bucket padded only to
        its own size). Returns the merged Preintegration (original order) as
        host numpy, and the buckets (interval indices, intervals on the
        device, num_steps) for recompute_preintegrations."""
        t_abs, _, _ = self._imu_stream(ii)
        rate = 1.0 / max(np.diff(t_abs).min(), 1e-5)
        need = np.ceil((np.asarray(t1s) - np.asarray(t0s) + 2 * slack) * rate) + 4
        S = np.maximum(2 ** np.ceil(np.log2(np.maximum(need, 1))).astype(np.int64), 8)
        n = len(t0s)
        merged, buckets = None, []
        for s_val in np.unique(S):
            sel = np.nonzero(S == s_val)[0]
            iv, num_steps = self._intervals_for(ii, np.asarray(t0s)[sel], np.asarray(t1s)[sel],
                                                slack=slack, S=int(s_val))
            p = pre.preintegrate_batch(torch.from_numpy(calibs[sel]).to(self.device), iv,
                                       noise, num_steps)
            buckets.append((sel, iv, num_steps))
            flat = {"q": p.rvp.q, "dV": p.rvp.dV, "dP": p.rvp.dP, "dt": p.rvp.dt, "J": p.J,
                    "cov": p.cov, "omega_at_end": p.omega_at_end, "calib_eval": p.calib_eval,
                    "valid": p.valid}
            if merged is None:
                merged = {k: np.zeros((n,) + tuple(a.shape[1:]), a.cpu().numpy().dtype)
                          for k, a in flat.items()}
            for k, a in flat.items():
                merged[k][sel] = a.cpu().numpy()
        return merged, buckets

    def _add_inertial(self, problem, imu_calib_init):
        R, nI = self.R, self.num_imus
        rig_t = self.rig_ts_us.astype(np.float64) * 1e-6
        prev = np.nonzero(np.diff(rig_t) <= MAX_INERTIAL_GAP_SEC)[0]
        nxt = prev + 1
        if len(prev) == 0:
            return
        self._omega_meas = {}
        self._preint_cache = {}
        for ii in range(nI):
            noise = self.imu_noise_model(ii)
            calib_rows = self.rig_window[prev] * nI + ii
            p, buckets = self._preintegrate_pairs(ii, rig_t[prev], rig_t[nxt],
                                                  imu_calib_init[calib_rows], noise)
            ok = p["valid"]
            if not ok.all():
                self.log(f"imu {ii}: {int((~ok).sum())} invalid preint intervals dropped")
            sel = np.nonzero(ok)[0]
            # batch row of each kept interval; each bucket keeps its kept
            # intervals and their batch rows
            row_of = np.full(len(prev), -1, np.int64)
            row_of[sel] = np.arange(len(sel))
            self._preint_cache[ii] = []
            for bsel, iv, num_steps in buckets:
                keep = np.nonzero(row_of[bsel] >= 0)[0]
                if len(keep):
                    k = torch.from_numpy(keep).to(self.device)
                    self._preint_cache[ii].append((pre.PreintInterval(*(
                        a.index_select(0, k) for a in iv)), num_steps,
                        torch.from_numpy(row_of[bsel[keep]]).to(self.device)))
            sqrt_info = chol_inv_lower(torch.from_numpy(p["cov"][sel]).to(self.device)).cpu()
            self._omega_meas[ii] = (nxt[sel], p["omega_at_end"][sel])
            mask = np.asarray(self.imu_calib_mask, np.float64)

            def t(a, dtype=None):
                return torch.from_numpy(np.ascontiguousarray(a, dtype))

            common = {
                "prev_rig": t(prev[sel], np.int32),
                "next_rig": t(nxt[sel], np.int32),
                "calib": t(calib_rows[sel], np.int32),
                "preint_q": t(p["q"][sel]), "preint_dv": t(p["dV"][sel]),
                "preint_dp": t(p["dP"][sel]), "preint_dt": t(p["dt"][sel]),
                "preint_J": t(p["J"][sel]), "calib_eval": t(p["calib_eval"][sel]),
                "calib_mask": t(np.broadcast_to(mask, (len(sel), imu_model.CALIB_DIM))),
                "sqrt_info": sqrt_info,
            }
            if ii == 0:
                problem.add_batch(fct.BatchCfg(kind="inertial", loss=self.opts.imu_loss,
                                               label="inertial"), common)
            else:
                n_sec = nI - 1
                common["prev_extr"] = t(self.rig_window[prev[sel]] * n_sec + (ii - 1), np.int32)
                common["next_extr"] = t(self.rig_window[nxt[sel]] * n_sec + (ii - 1), np.int32)
                problem.add_batch(fct.BatchCfg(kind="inertial_secondary", loss=self.opts.imu_loss,
                                               label=f"inertial_imu{ii}"), common)

    def _add_random_walks(self, problem):
        """RW factors between consecutive windows (RandomWalkFactors.cpp:36-152)."""
        opts = self.opts
        W, nC, nI = self.num_windows, self.num_cams, self.num_imus
        n_sec = max(nI - 1, 0)
        if W < 2:
            return
        noise = imu_model.default_noise_model()
        dts = np.diff(self.window_mid_ts) * 1e-6  # seconds between window centers

        def add(kind, prevs, nxts, shs):
            problem.add_batch(fct.BatchCfg(kind=kind, label=kind), {
                "prev": torch.tensor(prevs, dtype=torch.int32),
                "next": torch.tensor(nxts, dtype=torch.int32),
                "sqrt_h": torch.from_numpy(np.stack(shs))})

        if opts.estimate_imu_calib:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("imu_calib")
            for ii in range(nI):
                rw_rate = self.imu_noise_model(ii).rw_var_per_sec.cpu().numpy()
                for w in range(W - 1):
                    q = rw_rate * dts[w] * infl**2
                    prevs.append(w * nI + ii)
                    nxts.append((w + 1) * nI + ii)
                    shs.append(np.where(self.imu_calib_mask,
                                        1.0 / np.sqrt(np.maximum(q, 1e-30)), 0.0))
            add("rw_imu_calib", prevs, nxts, shs)

        if opts.estimate_cam_intr:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("cam_intr")
            for ci in range(nC):
                n_model = cam_ops.NUM_MODEL_PARAMS[self.camera_kind(ci)]
                n_proj = 3 if self.camera_kind(ci) == cam_ops.KIND_FISHEYE624 else 4
                q = np.zeros(cam_ops.MAX_PARAMS)
                q[:n_proj] = CAM_PROJ_RW_VAR
                q[n_proj:n_model] = CAM_DIST_RW_VAR
                q[cam_ops.READOUT] = CAM_TIME_RW_VAR
                q[cam_ops.TIME_OFFSET] = CAM_TIME_RW_VAR
                for w in range(W - 1):
                    sh = 1.0 / np.sqrt(np.maximum(q * dts[w] * infl**2, 1e-30))
                    sh[n_model:cam_ops.READOUT] = 0.0
                    prevs.append(w * nC + ci)
                    nxts.append((w + 1) * nC + ci)
                    shs.append(sh)
            add("rw_cam_intr", prevs, nxts, shs)

        if opts.estimate_cam_extr:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("cam_extr")
            for ci in range(nC):
                for w in range(W - 1):
                    q = np.concatenate([np.full(3, CAM_EXTR_RW_VAR_POS * dts[w]),
                                        np.full(3, CAM_EXTR_RW_VAR_ROT * dts[w])]) * infl**2
                    prevs.append(w * nC + ci)
                    nxts.append((w + 1) * nC + ci)
                    shs.append(1.0 / np.sqrt(q))
            add("rw_cam_extr", prevs, nxts, shs)

        if opts.estimate_imu_extr and n_sec:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("imu_extr")
            pos_rate = noise.extr_rw_pos_var_per_sec.numpy()
            rot_rate = noise.extr_rw_rot_var_per_sec.numpy()
            for ii in range(n_sec):
                for w in range(W - 1):
                    q = np.concatenate([pos_rate * dts[w], rot_rate * dts[w]]) * infl**2
                    prevs.append(w * n_sec + ii)
                    nxts.append((w + 1) * n_sec + ii)
                    shs.append(1.0 / np.sqrt(q))
            add("rw_imu_extr", prevs, nxts, shs)

    def _add_factory_priors(self, problem):
        """Factory priors, std x inflate, H x ref-count (FactoryCalibPriors.cpp);
        an inflate <= 0 disables a group (SingleSessionAdapter.cpp:113-126)."""
        opts, sd = self.opts, self.sd
        W, nC, nI = self.num_windows, self.num_cams, self.num_imus
        n_sec = max(nI - 1, 0)
        noise = imu_model.default_noise_model()
        counts = np.bincount(self.rig_window, minlength=W)  # rigs per window

        def tt(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype))

        if opts.estimate_cam_intr and (inflate := self._fprio("cam_intr")) > 0:
            idxs, refs, shs = [], [], []
            for ci in range(nC):
                ref = self._cam_param_vec(sd.factory, self.cam_to_factory[ci])
                kindn = self.camera_kind(ci)
                n_model = cam_ops.NUM_MODEL_PARAMS[kindn]
                n_proj = 3 if kindn == cam_ops.KIND_FISHEYE624 else 4
                online_f = self.sd.online[0].cameras[ci].params[0]
                if abs(ref[0] - online_f) / max(ref[0], 1e-9) > 0.1:
                    raise RuntimeError(
                        f"camera {ci}: factory focal {ref[0]} vs online {online_f} "
                        "differ >10% — resolution mismatch? (FactoryCalibPriors.cpp:50-63)")
                std = np.zeros(cam_ops.MAX_PARAMS)
                std[:n_proj] = CAM_PROJ_TURNON_STD
                std[n_proj:n_model] = CAM_DIST_TURNON_STD
                std[cam_ops.READOUT] = CAM_READOUT_TURNON_STD
                std[cam_ops.TIME_OFFSET] = CAM_TOFF_TURNON_STD
                for w in range(W):
                    sh = np.where(std > 0, np.sqrt(counts[w]) / (std * inflate + 1e-30), 0.0)
                    sh[n_model:cam_ops.READOUT] = 0.0
                    idxs.append(w * nC + ci)
                    refs.append(ref)
                    shs.append(sh)
            problem.add_batch(fct.BatchCfg(kind="cam_intr_prior", label="factory_cam_intr"),
                              {"intr": tt(idxs, np.int32), "ref": tt(np.stack(refs)),
                               "sqrt_h": tt(np.stack(shs))})

        if opts.estimate_cam_extr and (inflate := self._fprio("cam_extr")) > 0:
            idxs, rq, rt, shs = [], [], [], []
            std = np.concatenate([np.full(3, CAM_EXTR_TURNON_POS), np.full(3, CAM_EXTR_TURNON_ROT)])
            for ci in range(nC):
                q, t = self._T_cam_bodyImu(sd.factory, self.cam_to_factory[ci])
                for w in range(W):
                    idxs.append(w * nC + ci)
                    rq.append(q)
                    rt.append(t)
                    shs.append(np.sqrt(counts[w]) / (std * inflate))
            problem.add_batch(fct.BatchCfg(kind="cam_extr_prior", label="factory_cam_extr"),
                              {"idx": tt(idxs, np.int32), "ref_q": tt(np.stack(rq)),
                               "ref_t": tt(np.stack(rt)), "sqrt_h": tt(np.stack(shs))})

        if opts.estimate_imu_calib and (inflate := self._fprio("imu_calib")) > 0:
            idxs, refs, shs = [], [], []
            std = noise.turnon_std.numpy()
            for ii in range(nI):
                ref = sd.factory.imus[self.imu_to_factory[ii]].calib23
                for w in range(W):
                    idxs.append(w * nI + ii)
                    refs.append(ref)
                    shs.append(np.where(self.imu_calib_mask,
                                        np.sqrt(counts[w]) / (std * inflate + 1e-30), 0.0))
            problem.add_batch(fct.BatchCfg(kind="imu_calib_prior", label="factory_imu_calib"),
                              {"calib": tt(idxs, np.int32), "ref": tt(np.stack(refs)),
                               "sqrt_h": tt(np.stack(shs))})

        if opts.estimate_imu_extr and n_sec and (inflate := self._fprio("imu_extr")) > 0:
            idxs, rq, rt, shs = [], [], [], []
            std = np.concatenate([noise.extr_turnon_pos_std.numpy(),
                                  noise.extr_turnon_rot_std.numpy()])
            for ii in range(1, nI):
                q, t = self._T_imu_bodyImu(sd.factory, self.imu_to_factory[ii])
                for w in range(W):
                    idxs.append(w * n_sec + (ii - 1))
                    rq.append(q)
                    rt.append(t)
                    shs.append(np.sqrt(counts[w]) / (std * inflate))
            problem.add_batch(fct.BatchCfg(kind="imu_extr_prior", label="factory_imu_extr"),
                              {"idx": tt(idxs, np.int32), "ref_q": tt(np.stack(rq)),
                               "ref_t": tt(np.stack(rt)), "sqrt_h": tt(np.stack(shs))})

    def _add_omega_priors(self, problem):
        """One omega prior per (rig, imu) when >= 2 imus (OmegaPriors.cpp:19-31)."""
        if self.num_imus < 2 or not hasattr(self, "_omega_meas"):
            return
        n_sec = self.num_imus - 1
        rigs, extrs, meas, has_extr = [], [], [], []
        for ii, (rig_rows, omegas) in self._omega_meas.items():
            rigs.append(rig_rows)
            meas.append(omegas)
            if ii == 0:
                extrs.append(np.zeros(len(rig_rows), np.int64))
                has_extr.append(np.zeros(len(rig_rows)))
            else:
                extrs.append(self.rig_window[rig_rows] * n_sec + (ii - 1))
                has_extr.append(np.ones(len(rig_rows)))
        n = sum(len(r) for r in rigs)
        problem.add_batch(fct.BatchCfg(kind="omega_prior", label="omega_prior"), {
            "rig": torch.from_numpy(np.concatenate(rigs).astype(np.int32)),
            "extr": torch.from_numpy(np.concatenate(extrs).astype(np.int32)),
            "omega_meas": torch.from_numpy(np.concatenate(meas)),
            "sqrt_w": torch.full((n,), 1.0 / OMEGA_PRIOR_STD, dtype=F64),
            "has_extr": torch.from_numpy(np.concatenate(has_extr)),
        })
