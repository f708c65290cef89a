"""Rig-state initialization modes beyond plain trajectory loading.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/init_rigs.py`
(reference viba/single_session/InitRigs.cpp:32-400 and
InitRescaling.cpp:23-123), numpy as there:

  - GT-trajectory init: override pose / velocity / angular velocity per rig
    from an external trajectory (the reference's TrajectoryBase consumer,
    InitRigs.cpp:146-230). `InterpolatedTrajectory` is a concrete trajectory
    (the reference ships only the abstract base, TrajectoryBase.h).
  - keyrig-anchored ranges: grow matched keyrig indices up/down by
    `rig_window_grow`, stopping at tracker resets, merging overlapping
    requested time intervals (computeKeyRigInitRef, InitRigs.cpp:58-131).
  - map-interpolated init: adapt open-loop trajectory poses to map keyrig
    poses by SE3-interpolating the traj->map world correction between
    matched keyrigs, with velocity rescaling from the estimated traj/map
    log-scale drift (initRigsInterpolatingPoses, InitRigs.cpp:236-400)
    and drift-distortion statistics.

Everything here is one-time host-side setup (numpy), like the reference's
single-threaded adapter code; the arrays feed the device variable tables.

Frames: pose = T_bodyImu_world (quaternion wxyz maps world -> bodyImu),
velocity in world frame, omega in bodyImu frame — same as SessionData.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .session_data import _q_conj, _q_rot, _se3_inv, _se3_mul

# reference InitRigs.cpp:224-228
WALKED_DISTANCE_ADD = 0.5
ROT_DRIFT_DEG_PER_SQRT_M = 0.2
TR_DRIFT_CM_PER_SQRT_M = 2.0
TIME_DELTA_CLOSE_TO_RESET_US = 300_000
# reference InitRescaling.cpp:20-21
MIN_SQ_RADIUS_COMPARISON_M = 4.0 * 4.0
MAX_SQ_RADIUS_RESTART_M = 2.0 * 2.0
DEFAULT_RIG_WINDOW_GROW = 10  # SingleSessionAdapter.h:101


# -- numpy SO3/SE3 helpers ---------------------------------------------------


def _so3_log(q):
    """wxyz quaternion(s) -> rotation vector(s)."""
    q = np.asarray(q, float)
    w = np.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    n = np.linalg.norm(v, axis=-1)
    angle = 2.0 * np.arctan2(n, w)
    angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
    scale = np.where(n > 1e-12, angle / np.maximum(n, 1e-30), 2.0 / np.maximum(np.abs(w), 1e-30))
    return v * scale[..., None]


def _so3_exp(r):
    r = np.asarray(r, float)
    n = np.linalg.norm(r, axis=-1)
    half = 0.5 * n
    s = np.where(n > 1e-12, np.sin(half) / np.maximum(n, 1e-30), 0.5)
    q = np.concatenate([np.cos(half)[..., None], r * s[..., None]], -1)
    return q


def _se3_interpolate(qa, ta, qb, tb, alpha):
    """Sophus::interpolate(a, b, alpha) = a * exp(alpha * log(a^-1 b))."""
    qai, tai = _se3_inv(qa, ta)
    qd, td = _se3_mul(qai, tai, qb, tb)
    # SE3 log: rot part + V^-1 t; interpolate in the tangent then exp
    r = _so3_log(qd)
    n = np.linalg.norm(r, axis=-1)
    # V matrix for SE3 exp/log (Barfoot 7.85)
    def _V(rv, nn):
        eye = np.eye(3)
        K = np.array([
            [0.0, -rv[2], rv[1]],
            [rv[2], 0.0, -rv[0]],
            [-rv[1], rv[0], 0.0],
        ])
        if nn < 1e-8:
            return eye + 0.5 * K + K @ K / 6.0
        a = (1 - np.cos(nn)) / nn**2
        b = (nn - np.sin(nn)) / nn**3
        return eye + a * K + b * (K @ K)

    V = _V(r, n)
    rho = np.linalg.solve(V, td)
    r2 = alpha * r
    rho2 = alpha * rho
    V2 = _V(r2, np.linalg.norm(r2))
    qd2 = _so3_exp(r2)
    td2 = V2 @ rho2
    return _se3_mul(qa, ta, qd2, td2)


# -- concrete trajectory (reference TrajectoryBase.h has no in-repo impl) ----


@dataclasses.dataclass
class InterpolatedTrajectory:
    """TrajectoryBase from timestamped poses: SE3-interpolated pose queries,
    optional velocities/omegas (linearly interpolated)."""

    ts_us: np.ndarray  # (N,) sorted
    pose_q: np.ndarray  # (N, 4) T_bodyImu_world wxyz
    pose_t: np.ndarray  # (N, 3)
    vel_world: np.ndarray | None = None  # (N, 3)
    omega: np.ndarray | None = None  # (N, 3) bodyImu frame
    gravity_world: np.ndarray | None = None  # (3,)

    def have_velocities(self) -> bool:
        return self.vel_world is not None

    def _bracket(self, t_us):
        i = int(np.searchsorted(self.ts_us, t_us, side="right")) - 1
        i = max(0, min(i, len(self.ts_us) - 2))
        t0, t1 = self.ts_us[i], self.ts_us[i + 1]
        a = 0.0 if t1 == t0 else float(np.clip((t_us - t0) / (t1 - t0), 0.0, 1.0))
        return i, a

    def T_bodyImu_world(self, t_us):
        i, a = self._bracket(t_us)
        return _se3_interpolate(
            self.pose_q[i], self.pose_t[i], self.pose_q[i + 1], self.pose_t[i + 1], a
        )

    def inertial_pose(self, t_us):
        """(q, t, vel_world, omega) at t_us."""
        i, a = self._bracket(t_us)
        q, t = _se3_interpolate(
            self.pose_q[i], self.pose_t[i], self.pose_q[i + 1], self.pose_t[i + 1], a
        )
        vel = None
        if self.vel_world is not None:
            vel = (1 - a) * self.vel_world[i] + a * self.vel_world[i + 1]
        om = None
        if self.omega is not None:
            om = (1 - a) * self.omega[i] + a * self.omega[i + 1]
        return q, t, vel, om


# -- keyrig-anchored ranges (computeKeyRigInitRef, InitRigs.cpp:58-131) ------


def _grow_up(i, grow, num_rigs, resets: set):
    j = i
    while j < i + grow and j < num_rigs - 1 and j not in resets:
        j += 1
    return j


def _grow_down(i, grow, resets: set):
    j = i
    while j > i - grow and j > 0 and (j - 1) not in resets:
        j -= 1
    return j


def compute_key_rig_init_ref(
    kr_rig_indices,
    num_rigs,
    reset_rig_indices=(),
    rig_window_grow=DEFAULT_RIG_WINDOW_GROW,
    same_interval=None,
):
    """Ranges of rigs to initialize around matched keyrigs.

    kr_rig_indices: rig index of each keyrig (sorted). same_interval: optional
    (K,) group id per keyrig; consecutive keyrigs in the same group never
    split ranges (the reference's merged time intervals). Returns
    (rig_to_kr dict, list of (start, end) half-open ranges).
    """
    kr_rig_indices = [int(i) for i in kr_rig_indices]
    resets = set(int(r) for r in reset_rig_indices)
    rig_to_kr = {}
    ranges = [[-1, -1]]
    prev = None
    for k, rig in enumerate(kr_rig_indices):
        no_split = (
            same_interval is not None
            and prev is not None
            and same_interval[k] == same_interval[k - 1]
            and same_interval[k] >= 0
        )
        if prev is not None and not no_split:
            brk = any(i in resets for i in range(prev, rig))
            if rig - prev > rig_window_grow * 3 or brk:
                ranges[-1][1] = _grow_up(prev, rig_window_grow, num_rigs, resets) + 1
                ranges.append([_grow_down(rig, rig_window_grow, resets), -1])
        rig_to_kr[rig] = k
        prev = rig
    ranges[0][0] = _grow_down(kr_rig_indices[0], rig_window_grow, resets)
    ranges[-1][1] = _grow_up(kr_rig_indices[-1], rig_window_grow, num_rigs, resets) + 1
    return rig_to_kr, [tuple(r) for r in ranges]


# -- log-scale drift (InitRescaling.cpp) --------------------------------------


def scaling_eval_ranges(kr_q, kr_t):
    """Keyrig index ranges with >= 4 m baseline (scalingEvalRanges)."""
    K = len(kr_q)
    ranges = []
    start, end = 0, 1
    while True:
        while end < K:
            # relative baseline; squared norm is frame-independent
            qe, te = _se3_mul(kr_q[end], kr_t[end], *_se3_inv(kr_q[start], kr_t[start]))
            if float(te @ te) > MIN_SQ_RADIUS_COMPARISON_M:
                break
            end += 1
        if end >= K:
            break
        ranges.append((start, end))
        while start < end:
            start += 1
            qe, te = _se3_mul(kr_q[end], kr_t[end], *_se3_inv(kr_q[start], kr_t[start]))
            if float(te @ te) < MAX_SQ_RADIUS_RESTART_M:
                break
    if not ranges:
        ranges.append((0, K - 1))
    return ranges


def compute_log_scalings(kr_ts_us, kr_q, kr_t, traj_q, traj_t, kr_rig_indices):
    """(timestamps, log_scales): log of map/traj relative-baseline ratio over
    >= 4 m keyrig ranges (computeLogScalings, InitRescaling.cpp:96-123)."""
    ranges = scaling_eval_ranges(kr_q, kr_t)
    ts, vals = [], []
    for s, e in ranges:
        mid = (int(kr_ts_us[s]) + int(kr_ts_us[e])) // 2
        if s == e:
            ts.append(mid)
            vals.append(0.0)
            continue
        _, te = _se3_mul(kr_q[e], kr_t[e], *_se3_inv(kr_q[s], kr_t[s]))
        rs, re = kr_rig_indices[s], kr_rig_indices[e]
        # trajectory poses are T_bodyImu_world: T_rigEnd_rigStart =
        # T_e_w * (T_s_w)^-1 in the reference's T_w_IMU convention equals
        # (T_bI_w[e])^... use world positions of the body origin
        pw_s = -_q_rot(_q_conj(traj_q[rs]), traj_t[rs])
        pw_e = -_q_rot(_q_conj(traj_q[re]), traj_t[re])
        d_traj = pw_e - pw_s
        ts.append(mid)
        vals.append(0.5 * np.log(float(te @ te) / max(float(d_traj @ d_traj), 1e-30)))
    order = np.argsort(ts)
    return np.asarray(ts, np.int64)[order], np.asarray(vals)[order]


def scaling_at_timestamps(log_ts, log_vals, query_ts):
    """exp(interpolated log scaling), clamped at the extremes."""
    if len(log_ts) == 0:
        return np.ones(len(query_ts))
    return np.exp(np.interp(np.asarray(query_ts, float), log_ts.astype(float), log_vals))


# -- GT-trajectory init (initRigsFromGtTrajectory, InitRigs.cpp:146-230) -----


def init_rigs_from_gt(
    pose_q, pose_t, vel, omega, rig_ts_us, trajectory,
    pose_to_gt=True, vel_to_gt=False, omega_to_gt=False, ranges=None,
):
    """Override rig states from a trajectory over the given rig ranges
    (default: all). Mutates copies; returns (pose_q, pose_t, vel, omega)."""
    pose_q, pose_t = pose_q.copy(), pose_t.copy()
    vel, omega = vel.copy(), omega.copy()
    R = len(rig_ts_us)
    if ranges is None:
        ranges = [(0, R)]
    any_vel = vel_to_gt or omega_to_gt
    if any_vel and not trajectory.have_velocities():
        raise ValueError("trajectory has no velocities for vel/omega-to-gt")
    for s, e in ranges:
        for i in range(s, e):
            t_us = int(rig_ts_us[i])
            gq, gt, gvel, gom = trajectory.inertial_pose(t_us)
            # body-frame velocity under the ORIGINAL pose (world vel is
            # frame-dependent; reference InitRigs.cpp:188-227)
            vel_body = _q_rot(pose_q[i], vel[i])
            if pose_to_gt:
                pose_q[i], pose_t[i] = gq, gt
            if vel_to_gt:
                vel_body = _q_rot(gq, gvel)
            if omega_to_gt:
                omega[i] = gom
            # re-express in the (possibly new) pose's world frame
            vel[i] = _q_rot(_q_conj(pose_q[i]), vel_body)
    return pose_q, pose_t, vel, omega


# -- map-interpolated init (initRigsInterpolatingPoses) -----------------------


def init_rigs_interpolating_poses(
    pose_q, pose_t, vel, omega, rig_ts_us,
    kr_rig_indices, kr_q, kr_t,
    reset_rig_indices=(),
    rig_window_grow=DEFAULT_RIG_WINDOW_GROW,
    same_interval=None,
    log=None,
):
    """Adapt trajectory poses to map keyrig poses (InitRigs.cpp:236-400).

    kr_q/kr_t: T_bodyImu_world of each matched keyrig in the MAP world.
    Returns (pose_q, pose_t, vel, omega, active_mask, stats) where
    active_mask flags rigs covered by the keyrig ranges and stats holds the
    relative drift-distortion samples (rot, transl)."""
    pose_q_in, pose_t_in = pose_q, pose_t
    pose_q, pose_t = pose_q.copy(), pose_t.copy()
    vel, omega = vel.copy(), omega.copy()
    R = len(rig_ts_us)
    kr_rig_indices = np.asarray(kr_rig_indices, np.int64)
    rig_to_kr, ranges = compute_key_rig_init_ref(
        kr_rig_indices, R, reset_rig_indices, rig_window_grow, same_interval
    )
    resets = np.asarray(sorted(int(r) for r in reset_rig_indices), np.int64)

    # world positions of the body origin on the trajectory (for distortion /
    # walked distance / scaling)
    pw = -_q_rot(_q_conj(pose_q_in), pose_t_in)

    # drift-distortion stats between consecutive keyrigs (InitRigs.cpp:252-315)
    dist_rot, dist_tr = [], []
    for k in range(1, len(kr_rig_indices)):
        r0, r1 = int(kr_rig_indices[k - 1]), int(kr_rig_indices[k])
        i = np.searchsorted(resets, r0)
        if i < len(resets):
            reset_ts = rig_ts_us[int(resets[i])]
            if reset_ts <= rig_ts_us[r1] + TIME_DELTA_CLOSE_TO_RESET_US:
                continue
        # map_T_prev_next and traj_T_prev_next (both bodyImu frames)
        mq, mt = _se3_mul(kr_q[k - 1], kr_t[k - 1], *_se3_inv(kr_q[k], kr_t[k]))
        tq0, tt0 = pose_q_in[r0], pose_t_in[r0]
        tq1, tt1 = pose_q_in[r1], pose_t_in[r1]
        tq, tt = _se3_mul(tq0, tt0, *_se3_inv(tq1, tt1))
        dq, dt_ = _se3_mul(tq, tt, *_se3_inv(mq, mt))
        rot_deg = np.degrees(np.linalg.norm(_so3_log(dq)))
        tr_cm = np.linalg.norm(dt_) * 100.0
        walked = float(np.sum(np.linalg.norm(np.diff(pw[r0 : r1 + 1], axis=0), axis=-1)))
        sw = np.sqrt(walked + WALKED_DISTANCE_ADD)
        dist_rot.append(rot_deg / (ROT_DRIFT_DEG_PER_SQRT_M * sw))
        dist_tr.append(tr_cm / (TR_DRIFT_CM_PER_SQRT_M * sw))
    if log and dist_rot:
        log(
            f"map init distortion: rot p50 {np.percentile(dist_rot, 50):.2f} "
            f"p90 {np.percentile(dist_rot, 90):.2f} max {np.max(dist_rot):.2f} "
            f"(rel {ROT_DRIFT_DEG_PER_SQRT_M} deg/sqrt(m)); "
            f"transl p50 {np.percentile(dist_tr, 50):.2f} "
            f"p90 {np.percentile(dist_tr, 90):.2f} max {np.max(dist_tr):.2f} "
            f"(rel {TR_DRIFT_CM_PER_SQRT_M} cm/sqrt(m))"
        )

    log_ts, log_vals = compute_log_scalings(
        rig_ts_us[kr_rig_indices], kr_q, kr_t, pose_q_in, pose_t_in, kr_rig_indices
    )

    matched = np.asarray(sorted(rig_to_kr.keys()), np.int64)
    active = np.zeros(R, bool)
    for s, e in ranges:
        for i in range(s, e):
            t_us = int(rig_ts_us[i])
            scale = float(scaling_at_timestamps(log_ts, log_vals, [t_us])[0])
            # T_trajWorld_krWorld = T_w_IMU(traj) * T_bodyImu_world(kr)
            j = int(np.searchsorted(matched, i, side="left"))
            if j < len(matched) and matched[j] == i:
                k = rig_to_kr[int(matched[j])]
                aq, at_ = _se3_mul(*_se3_inv(pose_q_in[i], pose_t_in[i]), kr_q[k], kr_t[k])
            elif j == 0:
                r0 = int(matched[0])
                k = rig_to_kr[r0]
                aq, at_ = _se3_mul(*_se3_inv(pose_q_in[r0], pose_t_in[r0]), kr_q[k], kr_t[k])
            elif j >= len(matched):
                r0 = int(matched[-1])
                k = rig_to_kr[r0]
                aq, at_ = _se3_mul(*_se3_inv(pose_q_in[r0], pose_t_in[r0]), kr_q[k], kr_t[k])
            else:
                rp, rn = int(matched[j - 1]), int(matched[j])
                kp, kn = rig_to_kr[rp], rig_to_kr[rn]
                pq, pt = _se3_mul(*_se3_inv(pose_q_in[rp], pose_t_in[rp]), kr_q[kp], kr_t[kp])
                nq, ntt = _se3_mul(*_se3_inv(pose_q_in[rn], pose_t_in[rn]), kr_q[kn], kr_t[kn])
                t0, t1 = int(rig_ts_us[rp]), int(rig_ts_us[rn])
                a = 0.0 if t1 == t0 else (t_us - t0) / (t1 - t0)
                aq, at_ = _se3_interpolate(pq, pt, nq, ntt, a)
            # T_bodyImu_world(new) = T_bodyImu_trajWorld * T_trajWorld_krWorld
            pose_q[i], pose_t[i] = _se3_mul(pose_q_in[i], pose_t_in[i], aq, at_)
            # vel: rotate traj-world vel into kr world, rescale
            vel[i] = _q_rot(_q_conj(aq), vel[i]) * scale
            active[i] = True
    stats = {"dist_rot_rel": np.asarray(dist_rot), "dist_tr_rel": np.asarray(dist_tr)}
    return pose_q, pose_t, vel, omega, active, stats
