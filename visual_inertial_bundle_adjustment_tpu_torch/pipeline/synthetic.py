"""Synthetic visual-inertial session generator (ground truth + measurements).

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/synthetic.py`: a
smooth SE(3) trajectory, gravity, landmarks, fisheye observations, and raw
IMU streams generated through the full measurement model (scale/nonorth/bias
distortion + clock offsets + noise), all from one numpy `default_rng(seed)`
in the same draw order as the JAX package, so both packages produce the same
session from the same seed. Projection and rotation use the port's own
camera and Lie ops (torch, float64 on the host).

Conventions: poses are T_bodyImu_world (p_imu = R p_w + t), gravity is the
world acceleration vector (|g| = 9.81, pointing down), the gyro measures the
body angular velocity, the accelerometer the specific force R_imu_world
(xdd - g).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import imu as imu_model
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import preintegration as pre

G = 9.81


@dataclasses.dataclass
class Trajectory:
    """Smooth sinusoidal trajectory with analytic derivatives."""

    pos_amp: np.ndarray  # (K, 3)
    pos_freq: np.ndarray  # (K,)
    pos_phase: np.ndarray  # (K,)
    rot_amp: np.ndarray  # (K, 3)
    rot_freq: np.ndarray  # (K,)
    rot_phase: np.ndarray  # (K,)
    drift_vel: np.ndarray  # (3,) linear drift m/s

    @staticmethod
    def random(rng, speed=0.8, rot_deg=25.0, n_harmonics=3):
        k = np.arange(1, n_harmonics + 1)[:, None]
        return Trajectory(
            pos_amp=rng.normal(size=(n_harmonics, 3)) * speed / k,
            pos_freq=rng.uniform(0.15, 0.7, n_harmonics),
            pos_phase=rng.uniform(0, 2 * np.pi, n_harmonics),
            rot_amp=rng.normal(size=(n_harmonics, 3)) * np.deg2rad(rot_deg) / k,
            rot_freq=rng.uniform(0.1, 0.5, n_harmonics),
            rot_phase=rng.uniform(0, 2 * np.pi, n_harmonics),
            drift_vel=rng.normal(size=3) * 0.2,
        )

    def pos(self, t):
        t = np.asarray(t)[..., None]
        w = 2 * np.pi * self.pos_freq
        return ((self.pos_amp * np.sin(w * t + self.pos_phase)[..., None]).sum(-2)
                + self.drift_vel * t[..., 0, None])

    def vel(self, t):
        t = np.asarray(t)[..., None]
        w = 2 * np.pi * self.pos_freq
        return (self.pos_amp * w[:, None] * np.cos(w * t + self.pos_phase)[..., None]).sum(-2) \
            + self.drift_vel

    def acc(self, t):
        t = np.asarray(t)[..., None]
        w = 2 * np.pi * self.pos_freq
        return -(self.pos_amp * (w**2)[:, None] * np.sin(w * t + self.pos_phase)[..., None]).sum(-2)

    def rotvec(self, t):
        t = np.asarray(t)[..., None]
        w = 2 * np.pi * self.rot_freq
        return (self.rot_amp * np.sin(w * t + self.rot_phase)[..., None]).sum(-2)


def _exp_so3(w):
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    th = np.where(th < 1e-12, 1e-12, th)
    k = w / th
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s = np.sin(th)[..., None]
    c = np.cos(th)[..., None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def _quat_from_mat(R):
    """(..., 3, 3) -> (..., 4) wxyz (numpy, batched)."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    q = np.zeros(m.shape[:-2] + (4,))
    w = np.sqrt(np.maximum(1 + tr, 1e-12)) / 2
    q[..., 0] = w
    q[..., 1] = (m[..., 2, 1] - m[..., 1, 2]) / (4 * w)
    q[..., 2] = (m[..., 0, 2] - m[..., 2, 0]) / (4 * w)
    q[..., 3] = (m[..., 1, 0] - m[..., 0, 1]) / (4 * w)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _body_rates(traj, t):
    """Body angular velocity from central differences of R_world_imu(t)."""
    R_wi = _exp_so3(traj.rotvec(t))
    eps = 1e-6
    dR = (_exp_so3(traj.rotvec(t + eps)) - _exp_so3(traj.rotvec(t - eps))) / (2 * eps)
    What = np.einsum("nji,njk->nik", R_wi, dR)
    return R_wi, np.stack([What[..., 2, 1] - What[..., 1, 2], What[..., 0, 2] - What[..., 2, 0],
                           What[..., 1, 0] - What[..., 0, 1]], -1) / 2.0


class SyntheticSession:
    """Ground truth + raw measurements for a synthetic recording."""

    def __init__(self, duration=10.0, keyframe_hz=10.0, gyro_hz=800.0, accel_hz=1000.0,
                 num_points=300, num_cameras=1, seed=0, pixel_noise=0.3, imu_noise=True,
                 true_calib=None, gravity_dir=None, camera_params=None, image_size=(640, 480),
                 track_lifetime_sec=None):
        """`track_lifetime_sec`: if set, each landmark is only observed within
        a window of that length (birth times spread over the session in
        point-id order, like a real tracker) and is placed near the
        trajectory at its birth time."""
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.duration = duration
        self.traj = Trajectory.random(rng)
        self.noise = imu_model.default_noise_model()
        gdir = np.asarray(gravity_dir if gravity_dir is not None else [0.02, -0.01, -1.0])
        self.gravity = gdir / np.linalg.norm(gdir) * G

        if true_calib is None:
            c = np.zeros(imu_model.CALIB_DIM)
            c[imu_model.GYRO_BIAS] = rng.normal(size=3) * 0.005
            c[imu_model.ACCEL_BIAS] = rng.normal(size=3) * 0.03
            c[imu_model.GYRO_SCALE] = 1.0 + rng.normal(size=3) * 0.003
            c[imu_model.ACCEL_SCALE] = 1.0 + rng.normal(size=3) * 0.003
            c[imu_model.GYRO_NONORTH] = rng.normal(size=6) * 0.002
            c[imu_model.ACCEL_NONORTH] = rng.normal(size=3) * 0.002
            c[imu_model.DT_REF_GYRO] = rng.normal() * 2e-4
            c[imu_model.DT_REF_ACCEL] = rng.normal() * 2e-4
            true_calib = c
        self.true_calib = np.asarray(true_calib)

        self.rig_times = np.arange(0.0, duration, 1.0 / keyframe_hz)
        self.num_rigs = len(self.rig_times)
        # rotvec parameterizes R_world_imu; poses store T_bodyImu_world
        R_wi, self.gt_omega = _body_rates(self.traj, self.rig_times)
        self.gt_R_iw = np.swapaxes(R_wi, -1, -2)
        self.gt_pos_w = self.traj.pos(self.rig_times)
        self.gt_vel_w = self.traj.vel(self.rig_times)
        self.gt_pose_q = _quat_from_mat(self.gt_R_iw)
        self.gt_pose_t = -np.einsum("nij,nj->ni", self.gt_R_iw, self.gt_pos_w)

        self._gen_imu(gyro_hz, accel_hz, imu_noise)

        self.track_lifetime_sec = track_lifetime_sec
        if track_lifetime_sec is None:
            center = self.gt_pos_w.mean(0)
            self.points_w = center + rng.normal(size=(num_points, 3)) * np.array([6.0, 6.0, 4.0])
            self.point_birth = None
        else:
            birth = np.sort(rng.uniform(-0.5, duration - 0.5, num_points))
            anchors = self.traj.pos(np.clip(birth, 0.0, duration))
            self.points_w = anchors + rng.normal(size=(num_points, 3)) * np.array([4.0, 4.0, 3.0])
            self.point_birth = birth

        if camera_params is None:
            camera_params = np.array(
                [241.0, image_size[0] / 2, image_size[1] / 2,
                 -0.02, 0.05, -0.04, 0.009, 0.002, -0.0015,
                 0.0004, -0.0002, 0.0012, -0.0008, 0.0006, -0.0003])
        self.camera_params = np.asarray(camera_params)
        self.image_size = image_size
        self.num_cameras = num_cameras
        extr = []
        for ci in range(num_cameras):
            wv = np.array([0.0, 0.25 * (ci - (num_cameras - 1) / 2), 0.0])
            Rcb = _exp_so3(wv[None])[0]
            extr.append((_quat_from_mat(Rcb[None])[0], np.array([0.05 * ci, 0.01, -0.02])))
        self.cam_extr = extr  # T_Cam_BodyImu
        self.pixel_noise = pixel_noise

    def _gen_imu(self, gyro_hz, accel_hz, with_noise):
        rng = self.rng
        pad = 0.3
        g_t = np.arange(-pad, self.duration + pad, 1.0 / gyro_hz)
        a_t = np.arange(-pad, self.duration + pad, 1.0 / accel_hz)
        c = self.true_calib

        def true_signals(t):
            R_wi, w_body = _body_rates(self.traj, t)
            f_body = np.einsum("nij,nj->ni", np.swapaxes(R_wi, -1, -2),
                               self.traj.acc(t) - self.gravity)
            return w_body, f_body

        # samples are interval-midpoint values of the signal at
        # tReference = t - dtRef (see the JAX package)
        w_true, _ = true_signals(g_t - c[imu_model.DT_REF_GYRO] - 0.5 / gyro_hz)
        _, f_true = true_signals(a_t - c[imu_model.DT_REF_ACCEL] - 0.5 / accel_hz)
        ct = torch.from_numpy(c)
        gyroN = imu_model.gyro_nonorth_matrix(ct).numpy()
        accelN = imu_model.accel_nonorth_matrix(ct).numpy()
        w_meas = np.einsum("ij,nj->ni", gyroN, w_true + c[imu_model.GYRO_BIAS]) \
            * c[imu_model.GYRO_SCALE]
        f_meas = np.einsum("ij,nj->ni", accelN, f_true + c[imu_model.ACCEL_BIAS]) \
            * c[imu_model.ACCEL_SCALE]
        if with_noise:
            w_meas = w_meas + rng.normal(size=w_meas.shape) * np.sqrt(
                self.noise.gyro_sample_var.numpy())
            f_meas = f_meas + rng.normal(size=f_meas.shape) * np.sqrt(
                self.noise.accel_sample_var.numpy())
        self.gyro_t, self.gyro_v = g_t, w_meas
        self.accel_t, self.accel_v = a_t, f_meas

    def observations(self, min_track_len=3, rig_chunk=512):
        """Project landmarks into every (rig, camera); returns obs arrays
        (point, rig, cam, uv (noisy)), all numpy. With a track lifetime only
        candidate points (birth window overlapping the rig chunk) are
        projected. Cached: the same session always yields the same obs."""
        if hasattr(self, "_obs_cache"):
            return self._obs_cache
        pts, rigs, cams, uvs = [], [], [], []
        W, H = self.image_size
        R = self.num_rigs
        params = torch.from_numpy(self.camera_params)
        for ci in range(self.num_cameras):
            qcb, tcb = (torch.from_numpy(a) for a in self.cam_extr[ci])
            pose_q = torch.from_numpy(self.gt_pose_q)
            q_cw = lie.quat_mul(qcb[None], pose_q)
            t_cw = (tcb[None] + lie.quat_rotate(qcb[None], torch.from_numpy(self.gt_pose_t))).numpy()
            for r0 in range(0, R, rig_chunk):
                r1 = min(r0 + rig_chunk, R)
                if self.point_birth is not None:
                    lo = int(np.searchsorted(self.point_birth,
                                             self.rig_times[r0] - self.track_lifetime_sec))
                    hi = int(np.searchsorted(self.point_birth, self.rig_times[r1 - 1]))
                else:
                    lo, hi = 0, len(self.points_w)
                if hi <= lo:
                    continue
                # candidate windows padded to a pow-2 bucket (the JAX package's
                # compile-once bucketing; kept so both yield the same obs)
                bucket = 1 << max(hi - lo - 1, 1).bit_length()
                hi_pad = min(lo + bucket, len(self.points_w))
                lo_pad = max(hi_pad - bucket, 0)
                cand = self.points_w[lo_pad:lo_pad + bucket] \
                    if lo_pad + bucket <= len(self.points_w) \
                    else np.pad(self.points_w[lo_pad:],
                                ((0, lo_pad + bucket - len(self.points_w)), (0, 0)))
                lo = lo_pad
                p_cam = (lie.quat_rotate(q_cw[r0:r1, None], torch.from_numpy(cand)[None]).numpy()
                         + t_cw[r0:r1, None])
                uv, valid = cam_ops.project(cam_ops.KIND_FISHEYE624, params,
                                            torch.from_numpy(p_cam))
                uv, valid = uv.numpy(), valid.numpy()
                inside = (valid & (uv[..., 0] > 5) & (uv[..., 0] < W - 5)
                          & (uv[..., 1] > 5) & (uv[..., 1] < H - 5) & (p_cam[..., 2] > 0.3))
                cand_idx = np.arange(lo, lo + cand.shape[0])
                inside &= (cand_idx < len(self.points_w))[None, :]  # bucket-padding phantoms
                if self.point_birth is not None:
                    birth = self.point_birth[np.minimum(cand_idx, len(self.points_w) - 1)]
                    trel = self.rig_times[r0:r1, None] - birth[None, :]
                    inside &= (trel >= 0.0) & (trel <= self.track_lifetime_sec)
                ri, pi = np.nonzero(inside)
                pts.append(pi + lo)
                rigs.append(ri + r0)
                cams.append(np.full(len(pi), ci))
                uvs.append(uv[ri, pi] + self.rng.normal(size=(len(pi), 2)) * self.pixel_noise)
        pts = np.concatenate(pts)
        rigs = np.concatenate(rigs)
        cams = np.concatenate(cams)
        uvs = np.concatenate(uvs)
        counts = np.bincount(pts, minlength=len(self.points_w))
        keep = counts[pts] >= min_track_len
        self._obs_cache = {"point": pts[keep], "rig": rigs[keep], "cam": cams[keep],
                           "uv": uvs[keep]}
        return self._obs_cache

    def preint_intervals(self, max_steps=None):
        """Padded PreintInterval batch for consecutive rig pairs + step bound."""
        t0s = self.rig_times[:-1]
        t1s = self.rig_times[1:]
        slack = 0.05
        span = (t1s - t0s).max() + 2 * slack
        n_g = int(np.ceil(span / np.diff(self.gyro_t).min())) + 4
        n_a = int(np.ceil(span / np.diff(self.accel_t).min())) + 4

        def window(ts, vs, t0, S):
            i0 = max(np.searchsorted(ts, t0 - slack), 0)
            sel_t = ts[i0:i0 + S] - t0
            sel_v = vs[i0:i0 + S]
            out_t = np.full(S, 1e9)
            out_v = np.zeros((S, 3))
            out_t[:len(sel_t)] = sel_t
            out_v[:len(sel_v)] = sel_v
            return out_t, out_v

        g = [window(self.gyro_t, self.gyro_v, t0, n_g) for t0 in t0s]
        a = [window(self.accel_t, self.accel_v, t0, n_a) for t0 in t0s]
        iv = pre.PreintInterval(
            torch.from_numpy(np.stack([x[0] for x in g])),
            torch.from_numpy(np.stack([x[1] for x in g])),
            torch.from_numpy(np.stack([x[0] for x in a])),
            torch.from_numpy(np.stack([x[1] for x in a])),
            torch.from_numpy(t1s - t0s),
        )
        return iv, max_steps or (n_g + n_a + 4)
