"""Batched factor types: dense per-type tensors + pure local residual functions.

Port of `visual_inertial_bundle_adjustment_tpu/problem/factors.py`, with
the kinds the session adapter emits (residual formulas and citations as in
the JAX package):
  - VisualFactor               viba/problem/VisualFactor.cpp:36-120
  - RollingShutterVisualFactor VisualFactor.cpp:122-214
  - InertialFactor             viba/problem/InertialFactor.cpp:19-127
  - SecondaryImuInertialFactor InertialFactor.cpp:131-305
  - OmegaPriorFactor           viba/problem/OmegaPriorFactor.cpp:16-62
  - RandomWalkFactor           viba/problem/RandomWalkFactor.cpp:16-168
  - PriorFactor (factory calibration priors, the pose prior and the
    position + yaw gauge prior of problem/covariance.py) PriorFactor.cpp:17-176
  - BaseMapVisualFactor (multi-session base maps, pipeline/multi_session.py)
    BaseMapVisualFactor.{h,cpp}: a reprojection into a constant keyrig,
    linearized by the generic path and never blocked (rcs.VISUAL_KINDS
    leaves it out), so it reaches the solver as a point-coupled small batch

Each kind's residual is a pure function of the tangents of the variables it
touches, evaluated at the current linearization point; the generic
linearizer differentiates it with `torch.func.vmap(jacrev/jacfwd)`. Blocked
visual batches (rcs.finalize_blocks) go through fused linearizers instead:
plain visual with only pose + point active through ops/visual_fused.py (CUDA
kernel K1), plain visual with the camera calibration active too through the
same module's K11, rolling-shutter visual through ops/rs_fused.py (K7); on
the CPU each takes its plain PyTorch version.

Validity (reference std::optional returns) is a mask; every local function is
total and finite so AD never sees NaNs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from ..models import imu as imu_model
from ..ops import camera as cam_ops
from ..ops import lie, losses
from .structure import GRAVITY_MAG, OMEGA, POSE, VEL, Masks, VariableTables

# variable group names (match Tangent/Masks fields; 'points' is the Schur set)
RIG = "rig"
POINTS = "points"
CAM_INTR = "cam_intr"
CAM_EXTR = "cam_extr"
IMU_CALIB = "imu_calib"
IMU_EXTR = "imu_extr"
DET_BIAS = "det_bias"
GRAVITY = "gravity"

# factor-axis chunk for the vmapped generic linearizer (bounded temporaries)
LINEARIZE_CHUNK = 1 << 18

GROUP_DIMS = {
    RIG: 12,
    POINTS: 3,
    CAM_INTR: 17,
    CAM_EXTR: 6,
    IMU_CALIB: 23,
    IMU_EXTR: 6,
    DET_BIAS: 2,
    GRAVITY: 2,
}


@dataclasses.dataclass(frozen=True)
class BatchCfg:
    """Static configuration of a factor batch."""

    kind: str  # factor type name
    loss: tuple = (losses.TRIVIAL, 0.0, 0.0)  # (loss kind, a, k)
    camera_kind: int = cam_ops.KIND_FISHEYE624  # visual factors only
    label: str = ""  # for histograms / reports
    image_height: float = 480.0  # rolling-shutter visual factors only
    # groups whose tangents are differentiated; None = all (set by
    # Problem._build from the masks)
    active_groups: tuple | None = None
    # rcs.BlockInfo when the batch is laid out in ragged rig tiles
    # (rcs.finalize_blocks); None = generic layout
    block_info: object = None


class Lin(NamedTuple):
    """Linearized batch: whitened residuals + Jacobian blocks.

    The factor axis N is LAST everywhere (res (d, N), jac blocks
    (d, dim, N)), as in the JAX package, so kernels read each Jacobian
    column contiguously. `ell` entries are the transpose plans of
    build_transpose_plans (a padded (rows, K) int64 ELL plan whose row r lists
    the factors touching variable row r, sentinel N, or a TwoLevelPlan), or
    None: scatter_rows sums through them in a fixed order."""

    res: torch.Tensor  # (d, N)
    valid: torch.Tensor  # (N,) 0/1
    groups: tuple  # tuple of group names
    idx: tuple  # tuple of (N,) index tensors
    jac: tuple  # tuple of (d, dim, N) blocks
    ell: tuple = ()  # tuple of transpose plans (ELL or TwoLevelPlan) or None per entry


# row entries summed per chunk of the two-level transpose plan: a one-level
# plan pads every row to the busiest one (the gravity row is touched by every
# inertial factor: 12,000 at the full-sensor size, ~80M padded entries)
ELL_WIDTH = 64


class TwoLevelPlan(NamedTuple):
    """Deterministic transpose plan of an index array for rows too unevenly
    touched for a padded one-level plan (see two_level_plan)."""

    ell: torch.Tensor  # (n_chunks, width) int64 entries of each chunk (sentinel N)
    ell2: torch.Tensor  # (n_rows, max chunks per row) int64 chunks of each row (sentinel n_chunks)


def two_level_plan(rows_flat, n_rows, width=ELL_WIDTH):
    """Transpose plan of an index array, built on its device: the entries of
    each row (in index order) cut into chunks of at most `width`; ell
    (n_chunks, width) lists each chunk's entries (sentinel len(rows_flat)),
    ell2 (n_rows, max chunks per row) each row's chunks (sentinel n_chunks).
    Sums over ell then ell2 run in a fixed order (deterministic)."""
    n = rows_flat.shape[0]
    device = rows_flat.device
    order = torch.argsort(rows_flat, stable=True)
    srt = rows_flat[order]
    counts = torch.bincount(rows_flat, minlength=n_rows)
    pos = torch.arange(n, device=device) - (torch.cumsum(counts, 0) - counts)[srt]
    n_ch = (counts + width - 1) // width
    ch_start = torch.cumsum(n_ch, 0) - n_ch
    n_chunks, max_ch = int(n_ch.sum()), max(int(n_ch.max()), 1) if n_rows else 1
    ell = torch.full((n_chunks, width), n, dtype=torch.int64, device=device)
    ell[ch_start[srt] + pos // width, pos % width] = order
    j = torch.arange(max_ch, device=device)
    ell2 = torch.where(j[None, :] < n_ch[:, None], ch_start[:, None] + j[None, :],
                       torch.full((), n_chunks, device=device))
    return TwoLevelPlan(ell, ell2)


def scatter_rows(ell, idx, contrib, num_rows):
    """Sum per-factor columns into variable rows, in a fixed order.

    contrib: (dim..., N) with the factor axis LAST; returns (num_rows, dim...).
    A gather-sum over the batch's transpose plan: a padded one-level ELL plan
    (rows, K), a TwoLevelPlan, or, for a batch given none, a two-level plan
    built here from idx. No float atomics on any device."""
    lead = contrib.shape[:-1]
    flat = contrib.reshape(-1, contrib.shape[-1])  # (D, N)
    if ell is None:
        ell = two_level_plan(idx.to(torch.int64), num_rows)
    ext = torch.cat([flat, flat.new_zeros((flat.shape[0], 1))], dim=1)
    if isinstance(ell, TwoLevelPlan):
        chunks = ext[:, ell.ell].sum(-1)  # (D, n_chunks)
        chunks = torch.cat([chunks, chunks.new_zeros((chunks.shape[0], 1))], dim=1)
        out = chunks[:, ell.ell2].sum(-1)  # (D, rows)
    else:
        out = ext[:, ell].sum(-1)  # (D, rows)
    return out.T.reshape((num_rows,) + lead)


def ell_plan(idx: np.ndarray, rows: int):
    """(rows, K) int64 transpose plan of an index array (sentinel len(idx))."""
    n = len(idx)
    counts = np.bincount(idx, minlength=rows)
    K = int(counts.max()) if n else 0
    plan = np.full((rows, max(K, 1)), n, np.int64)
    order = np.argsort(idx, kind="stable")
    sorted_idx = idx[order]
    pos_in_row = np.arange(n) - np.concatenate([[0], np.cumsum(counts)])[sorted_idx]
    plan[sorted_idx, pos_in_row] = order
    return plan


def build_transpose_plans(cfgs, datas, num_rows_by_group, max_expand=4.0):
    """Add per-(batch, tangent) transpose plans into the data dicts.

    Stored under data["_ell{i}"] for tangent position i: a padded ELL plan
    (host numpy), or a TwoLevelPlan (built on the batch's device) where the
    padded plan would exceed max_expand x the factor count (a few rows
    touched by most factors). Blocked batches get none: their reductions run
    in the segment kernels."""
    for cfg, data in zip(cfgs, datas):
        if cfg.block_info is not None:
            continue
        spec = REGISTRY[cfg.kind]
        for i, (group, field) in enumerate(spec["tangents"]):
            key = f"_ell{i}"
            if key in data or group == GRAVITY or field is None:
                continue
            idx = data[field].cpu().numpy().astype(np.int64)
            n = len(idx)
            rows = num_rows_by_group[group]
            if rows == 0 or n == 0:
                continue
            K = int(np.bincount(idx, minlength=rows).max())
            if K * rows > max_expand * n + 1024:
                data[key] = two_level_plan(data[field].to(torch.int64), rows)
                continue
            data[key] = torch.from_numpy(ell_plan(idx, rows)).to(data[field].device)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _mvec(M, x):
    """Matrix-vector product for small per-factor blocks as an elementwise
    contraction (the JAX package's summation order)."""
    return (M * x[..., None, :]).sum(-1)


def _se3_at(q, t, xi):
    return lie.se3_boxplus((q, t), xi)


def _take(a, idx):
    return a.index_select(0, idx)


# ---------------------------------------------------------------------------
# Visual factor (global shutter), VisualFactor.cpp:36-120
# data fields: point, rig, intr, extr, bias: (N,) int32 indices;
#   obs_uv (N,2); sqrt_h (N,2,2); bias_on (N,)
# ---------------------------------------------------------------------------


def _visual_local(ts, ar, cfg):
    xi_pt, xi_rig, xi_extr, xi_intr, xi_bias = ts
    pt = ar["pt"] + xi_pt
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    Eq, Et = _se3_at(ar["extr_q"], ar["extr_t"], xi_extr)
    intr = ar["intr"] + xi_intr
    bias = ar["bias"] + xi_bias
    p_rig = lie.quat_rotate(Tq, pt) + Tt
    p_cam = lie.quat_rotate(Eq, p_rig) + Et
    uv, valid = cam_ops.project(cfg.camera_kind, intr, p_cam)
    err = uv - ar["obs_uv"] + ar["bias_on"] * bias
    res = _mvec(ar["sqrt_h"], err)
    return res, (res, valid)


def make_visual_batch(point, rig, intr, extr, bias, obs_uv, sqrt_h, bias_on=None):
    """Visual batch dict on the host (numpy in, CPU tensors out)."""
    obs_uv = torch.as_tensor(np.asarray(obs_uv))
    n = len(point)
    if bias_on is None:
        bias_on = np.zeros(n)

    def idx(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32)

    return {
        "point": idx(point),
        "rig": idx(rig),
        "intr": idx(intr),
        "extr": idx(extr),
        "bias": idx(bias),
        "obs_uv": obs_uv,
        "sqrt_h": torch.as_tensor(np.ascontiguousarray(sqrt_h), dtype=obs_uv.dtype),
        "bias_on": torch.as_tensor(np.asarray(bias_on), dtype=obs_uv.dtype),
    }


def _visual_args(v: VariableTables, d):
    return {
        "pt": _take(v.points, d["point"]),
        "pose_q": _take(v.pose_q, d["rig"]),
        "pose_t": _take(v.pose_t, d["rig"]),
        "extr_q": _take(v.cam_extr_q, d["extr"]),
        "extr_t": _take(v.cam_extr_t, d["extr"]),
        "intr": _take(v.cam_intr, d["intr"]),
        "bias": _take(v.det_bias, d["bias"]),
        "obs_uv": d["obs_uv"],
        "sqrt_h": d["sqrt_h"],
        "bias_on": d["bias_on"][..., None],
    }


# ---------------------------------------------------------------------------
# Rolling-shutter visual factor, VisualFactor.cpp:122-214
# extra fields: rs_row (N,) rows of rs_tables (per rig); rs_tpf (N,) per-row
#   capture-time fraction; rs_tables (ops.rolling_shutter.RSTables)
# ---------------------------------------------------------------------------


def _rs_visual_local(ts, ar, cfg):
    from ..ops import rolling_shutter as rs

    xi_pt, xi_rig, xi_extr, xi_intr = ts
    pt = ar["pt"] + xi_pt
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    vel = ar["vel"] + xi_rig[VEL]
    Eq, Et = _se3_at(ar["extr_q"], ar["extr_t"], xi_extr)
    intr = ar["intr"] + xi_intr
    # per-row capture time; the interpolation SEGMENT was chosen at the
    # current readout/time-offset (rs_segment_lookup) and is locally constant
    # under AD — dtt still carries the readout/time-offset derivative
    dtt = intr[cam_ops.READOUT] * ar["tpf"] - intr[cam_ops.TIME_OFFSET]
    est = rs.rs_estimate_seg(
        ar["seg_dt"], ar["seg_q"], ar["seg_dv"], ar["seg_dp"], ar["seg_ig"], ar["seg_ia"],
        ar["seg_idv"], ar["seg_valid"], ar["rs_grav"], dtt, vel, Tq)
    # T_bodyImuAtT_world = T_midImu_imuAtT^-1 * T_bodyImu_world
    Sq, St = lie.se3_inverse((est.q_mid_t, est.p_mid_t))
    Tq2, Tt2 = lie.se3_mul((Sq, St), (Tq, Tt))
    p_rig = lie.quat_rotate(Tq2, pt) + Tt2
    p_cam = lie.quat_rotate(Eq, p_rig) + Et
    uv, pvalid = cam_ops.project(cfg.camera_kind, intr, p_cam)
    res = _mvec(ar["sqrt_h"], uv - ar["obs_uv"])
    return res, (res, pvalid & est.valid)


def rs_segment_args(v: VariableTables, d):
    """Per-observation RS segment data at the current readout/time offset."""
    from ..ops import rolling_shutter as rs

    intr = _take(v.cam_intr, d["intr"])
    dtt0 = intr[:, cam_ops.READOUT] * d["rs_tpf"] - intr[:, cam_ops.TIME_OFFSET]
    return intr, rs.rs_segment_lookup(d["rs_tables"], d["rs_row"], dtt0)


def _rs_visual_args(v: VariableTables, d):
    intr, segd = rs_segment_args(v, d)
    n = d["rs_row"].shape[0]
    return {
        "pt": _take(v.points, d["point"]),
        "pose_q": _take(v.pose_q, d["rig"]),
        "pose_t": _take(v.pose_t, d["rig"]),
        "vel": _take(v.vel, d["rig"]),
        "extr_q": _take(v.cam_extr_q, d["extr"]),
        "extr_t": _take(v.cam_extr_t, d["extr"]),
        "intr": intr,
        "obs_uv": d["obs_uv"],
        "sqrt_h": d["sqrt_h"],
        "tpf": d["rs_tpf"],
        "rs_grav": d["rs_tables"].gravity_w.to(intr.dtype).expand(n, 3),
        **segd,
    }


# ---------------------------------------------------------------------------
# Base-map visual factor: reprojection into a CONSTANT keyrig; only the
# landmark is a variable (multi-session mode, BaseMapVisualFactor.{h,cpp})
# fields: point (N,) int32; q_cw/t_cw (N,4)/(N,3) T_cam_world (frozen);
#   intr (N, >=15) frozen intrinsics; obs_uv (N,2); sqrt_h (N,2,2)
# ---------------------------------------------------------------------------


def _base_map_visual_local(ts, ar, cfg):
    (xi_pt,) = ts
    pt = ar["pt"] + xi_pt
    p_cam = lie.quat_rotate(ar["q_cw"], pt) + ar["t_cw"]
    uv, valid = cam_ops.project(cfg.camera_kind, ar["intr"], p_cam)
    res = _mvec(ar["sqrt_h"], uv - ar["obs_uv"])
    return res, (res, valid)


def _base_map_visual_args(v: VariableTables, d):
    return {
        "pt": _take(v.points, d["point"]),
        "q_cw": d["q_cw"],
        "t_cw": d["t_cw"],
        "intr": d["intr"],
        "obs_uv": d["obs_uv"],
        "sqrt_h": d["sqrt_h"],
    }


# ---------------------------------------------------------------------------
# Inertial factor, body IMU (imu 0), InertialFactor.cpp:19-127
# fields: prev_rig, next_rig, calib (N,) int32;
#   preint_q (N,4), preint_dv (N,3), preint_dp (N,3), preint_dt (N,),
#   preint_J (N,9,23), calib_eval (N,23), calib_mask (N,23), sqrt_info (N,9,9)
# ---------------------------------------------------------------------------


def _inertial_core(calib, calib_eval, calib_mask, preint_J, q_pi, dv_pi, dp_pi, dt_pi,
                   Tq_p, Tt_p, vel_p, Tq_n, Tt_n, vel_n, grav):
    delta = calib_mask * imu_model.calib_boxminus(calib, calib_eval)
    corr = _mvec(preint_J, delta)
    q_corr = lie.so3_exp(-corr[0:3])
    corrected = lie.quat_mul(q_corr, lie.quat_conj(q_pi))  # R_next_prev corrected
    q_rot_err = lie.quat_mul(corrected, lie.quat_mul(Tq_p, lie.quat_conj(Tq_n)))
    log_rot_err = -lie.so3_log(q_rot_err)

    dv_w = vel_n - vel_p - grav * dt_pi
    dv_prev = lie.quat_rotate(Tq_p, dv_w)
    vel_err = dv_pi - dv_prev + corr[3:6]

    q_pn = lie.quat_mul(Tq_p, lie.quat_conj(Tq_n))
    dp_prev = (
        Tt_p
        - lie.quat_rotate(q_pn, Tt_n)
        - lie.quat_rotate(Tq_p, vel_p * dt_pi + grav * (0.5 * dt_pi * dt_pi))
    )
    pos_err = dp_pi - dp_prev + corr[6:9]
    return torch.cat([log_rot_err, vel_err, pos_err])


def _inertial_local(ts, ar, cfg):
    xi_calib, xi_prev, xi_next, xi_grav = ts
    calib = imu_model.calib_boxplus(ar["calib"], xi_calib)
    Tq_p, Tt_p = _se3_at(ar["pose_q_p"], ar["pose_t_p"], xi_prev[POSE])
    Tq_n, Tt_n = _se3_at(ar["pose_q_n"], ar["pose_t_n"], xi_next[POSE])
    vel_p = ar["vel_p"] + xi_prev[VEL]
    vel_n = ar["vel_n"] + xi_next[VEL]
    grav = lie.s2_boxplus(ar["grav"], GRAVITY_MAG, xi_grav)
    raw = _inertial_core(
        calib, ar["calib_eval"], ar["calib_mask"], ar["preint_J"],
        ar["preint_q"], ar["preint_dv"], ar["preint_dp"], ar["preint_dt"],
        Tq_p, Tt_p, vel_p, Tq_n, Tt_n, vel_n, grav,
    )
    res = _mvec(ar["sqrt_info"], raw)
    return res, (res, torch.ones_like(res[0], dtype=torch.bool))


def _inertial_args(v: VariableTables, d):
    n = d["prev_rig"].shape[0]
    return {
        "calib": _take(v.imu_calib, d["calib"]),
        "pose_q_p": _take(v.pose_q, d["prev_rig"]),
        "pose_t_p": _take(v.pose_t, d["prev_rig"]),
        "pose_q_n": _take(v.pose_q, d["next_rig"]),
        "pose_t_n": _take(v.pose_t, d["next_rig"]),
        "vel_p": _take(v.vel, d["prev_rig"]),
        "vel_n": _take(v.vel, d["next_rig"]),
        "grav": v.gravity.expand(n, 3),
        "preint_q": d["preint_q"],
        "preint_dv": d["preint_dv"],
        "preint_dp": d["preint_dp"],
        "preint_dt": d["preint_dt"],
        "preint_J": d["preint_J"],
        "calib_eval": d["calib_eval"],
        "calib_mask": d["calib_mask"],
        "sqrt_info": d["sqrt_info"],
    }


# ---------------------------------------------------------------------------
# Secondary-IMU inertial factor, InertialFactor.cpp:131-305
# extra fields: prev_extr, next_extr (N,) int32 (may be equal rows)
# ---------------------------------------------------------------------------


def _secondary_state(Tq_b, Tt_b, vel_b, omega_b, Eq, Et):
    """imu pose/velocity from body state + T_imu_bodyImu (InertialFactor.cpp:139-155)."""
    _, t_body_imu = lie.se3_inverse((Eq, Et))
    vel_imu_body = lie.cross(omega_b, t_body_imu)
    q_iw, t_iw = lie.se3_mul((Eq, Et), (Tq_b, Tt_b))
    vel_imu_w = vel_b + lie.quat_rotate(lie.quat_conj(Tq_b), vel_imu_body)
    return q_iw, t_iw, vel_imu_w


def _secondary_local(ts, ar, cfg):
    xi_calib, xi_prev, xi_next, xi_ep, xi_en, xi_grav = ts
    calib = imu_model.calib_boxplus(ar["calib"], xi_calib)
    Tq_p, Tt_p = _se3_at(ar["pose_q_p"], ar["pose_t_p"], xi_prev[POSE])
    Tq_n, Tt_n = _se3_at(ar["pose_q_n"], ar["pose_t_n"], xi_next[POSE])
    vel_p = ar["vel_p"] + xi_prev[VEL]
    vel_n = ar["vel_n"] + xi_next[VEL]
    om_p = ar["omega_p"] + xi_prev[OMEGA]
    om_n = ar["omega_n"] + xi_next[OMEGA]
    Eq_p, Et_p = _se3_at(ar["extr_q_p"], ar["extr_t_p"], xi_ep)
    Eq_n, Et_n = _se3_at(ar["extr_q_n"], ar["extr_t_n"], xi_en)
    grav = lie.s2_boxplus(ar["grav"], GRAVITY_MAG, xi_grav)
    q_p, t_p, v_p = _secondary_state(Tq_p, Tt_p, vel_p, om_p, Eq_p, Et_p)
    q_n, t_n, v_n = _secondary_state(Tq_n, Tt_n, vel_n, om_n, Eq_n, Et_n)
    raw = _inertial_core(
        calib, ar["calib_eval"], ar["calib_mask"], ar["preint_J"],
        ar["preint_q"], ar["preint_dv"], ar["preint_dp"], ar["preint_dt"],
        q_p, t_p, v_p, q_n, t_n, v_n, grav,
    )
    res = _mvec(ar["sqrt_info"], raw)
    return res, (res, _ok(res))


def _secondary_args(v: VariableTables, d):
    base = _inertial_args(v, d)
    base.update(
        omega_p=_take(v.omega, d["prev_rig"]),
        omega_n=_take(v.omega, d["next_rig"]),
        extr_q_p=_take(v.imu_extr_q, d["prev_extr"]),
        extr_t_p=_take(v.imu_extr_t, d["prev_extr"]),
        extr_q_n=_take(v.imu_extr_q, d["next_extr"]),
        extr_t_n=_take(v.imu_extr_t, d["next_extr"]),
    )
    return base


# ---------------------------------------------------------------------------
# Omega prior, OmegaPriorFactor.cpp:16-62
# fields: rig, extr (N,) int32; omega_meas (N,3); sqrt_w (N,); has_extr (N,)
# ---------------------------------------------------------------------------


def _omega_prior_local(ts, ar, cfg):
    xi_rig, xi_extr = ts
    om = ar["omega"] + xi_rig[OMEGA]
    Eq, _ = _se3_at(ar["extr_q"], ar["extr_t"], xi_extr)
    om_imu = lie.quat_rotate(Eq, om)
    om_used = ar["has_extr"] * om_imu + (1.0 - ar["has_extr"]) * om
    res = (om_used - ar["omega_meas"]) * ar["sqrt_w"]
    return res, (res, _ok(res))


def _omega_prior_args(v: VariableTables, d):
    return {
        "omega": _take(v.omega, d["rig"]),
        "extr_q": _take(v.imu_extr_q, d["extr"]),
        "extr_t": _take(v.imu_extr_t, d["extr"]),
        "omega_meas": d["omega_meas"],
        "sqrt_w": d["sqrt_w"][..., None],
        "has_extr": d["has_extr"][..., None],
    }


# ---------------------------------------------------------------------------
# Random-walk factors, RandomWalkFactor.cpp:16-168; priors, PriorFactor.cpp
# ---------------------------------------------------------------------------


def _ok(res):
    return torch.ones_like(res[0], dtype=torch.bool)


def _rw_imu_calib_local(ts, ar, cfg):
    xi_p, xi_n = ts
    cp = imu_model.calib_boxplus(ar["prev"], xi_p)
    cn = imu_model.calib_boxplus(ar["next"], xi_n)
    res = ar["sqrt_h"] * imu_model.calib_boxminus(cn, cp)
    return res, (res, _ok(res))


def _rw_cam_intr_local(ts, ar, cfg):
    xi_p, xi_n = ts
    res = ar["sqrt_h"] * ((ar["next"] + xi_n) - (ar["prev"] + xi_p))
    return res, (res, _ok(res))


def _rw_se3_local(ts, ar, cfg):
    xi_p, xi_n = ts
    Pq, Pt = _se3_at(ar["prev_q"], ar["prev_t"], xi_p)
    Nq, Nt = _se3_at(ar["next_q"], ar["next_t"], xi_n)
    res = ar["sqrt_h"] * lie.se3_boxminus((Nq, Nt), (Pq, Pt))
    return res, (res, _ok(res))


def _imu_calib_prior_local(ts, ar, cfg):
    (xi,) = ts
    c = imu_model.calib_boxplus(ar["calib"], xi)
    res = ar["sqrt_h"] * imu_model.calib_boxminus(c, ar["ref"])
    return res, (res, _ok(res))


def _cam_intr_prior_local(ts, ar, cfg):
    (xi,) = ts
    res = ar["sqrt_h"] * ((ar["intr"] + xi) - ar["ref"])
    return res, (res, _ok(res))


def _se3_prior_local(ts, ar, cfg):
    (xi,) = ts
    Tq, Tt = _se3_at(ar["q"], ar["t"], xi)
    res = ar["sqrt_h"] * lie.se3_boxminus((Tq, Tt), (ar["ref_q"], ar["ref_t"]))
    return res, (res, _ok(res))


def _pose_prior_local(ts, ar, cfg):
    (xi_rig,) = ts
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    res = _mvec(ar["sqrt_h"], lie.se3_boxminus((Tq, Tt), (ar["ref_q"], ar["ref_t"])))
    return res, (res, _ok(res))


def _position_yaw_prior_local(ts, ar, cfg):
    """Gauge prior: position + yaw about gravity (PriorFactor.cpp:17-32)."""
    (xi_rig,) = ts
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    d = lie.se3_boxminus((Tq, Tt), (ar["ref_q"], ar["ref_t"]))
    yaw = (d[3:6] * ar["grav_dir"]).sum()
    res = torch.cat([d[0:3] * ar["sqrt_h_pos"], yaw[None] * ar["sqrt_h_yaw"]])
    return res, (res, _ok(res))


def _position_yaw_prior_args(v, d):
    g = v.gravity / torch.linalg.vector_norm(v.gravity)
    return {"pose_q": _take(v.pose_q, d["rig"]), "pose_t": _take(v.pose_t, d["rig"]),
            "ref_q": d["ref_q"], "ref_t": d["ref_t"],
            "grav_dir": g.expand(d["rig"].shape[0], 3),
            "sqrt_h_pos": d["sqrt_h_pos"], "sqrt_h_yaw": d["sqrt_h_yaw"]}


def _rw_pair_args(table_getter):
    def fn(v, d):
        tab = table_getter(v)
        return {"prev": _take(tab, d["prev"]), "next": _take(tab, d["next"]),
                "sqrt_h": d["sqrt_h"]}
    return fn


def _rw_se3_args(q_get, t_get):
    def fn(v, d):
        return {"prev_q": _take(q_get(v), d["prev"]), "prev_t": _take(t_get(v), d["prev"]),
                "next_q": _take(q_get(v), d["next"]), "next_t": _take(t_get(v), d["next"]),
                "sqrt_h": d["sqrt_h"]}
    return fn


def _se3_prior_args(q_get, t_get):
    def fn(v, d):
        return {"q": _take(q_get(v), d["idx"]), "t": _take(t_get(v), d["idx"]),
                "ref_q": d["ref_q"], "ref_t": d["ref_t"], "sqrt_h": d["sqrt_h"]}
    return fn


# ---------------------------------------------------------------------------
# Registry: type name -> (local fn, tangent spec, args fn, residual dim)
# tangent spec: tuple of (group, data-index-field)
# ---------------------------------------------------------------------------

REGISTRY: dict[str, dict[str, Any]] = {
    "visual": dict(
        local=_visual_local,
        args=_visual_args,
        tangents=[(POINTS, "point"), (RIG, "rig"), (CAM_EXTR, "extr"), (CAM_INTR, "intr"),
                  (DET_BIAS, "bias")],
        optional=True,
        res_dim=2,
    ),
    "rs_visual": dict(
        local=_rs_visual_local,
        args=_rs_visual_args,
        tangents=[(POINTS, "point"), (RIG, "rig"), (CAM_EXTR, "extr"), (CAM_INTR, "intr")],
        optional=True,
        res_dim=2,
    ),
    "base_map_visual": dict(
        local=_base_map_visual_local,
        args=_base_map_visual_args,
        tangents=[(POINTS, "point")],
        optional=True,
        res_dim=2,
    ),
    "inertial": dict(
        local=_inertial_local,
        args=_inertial_args,
        tangents=[(IMU_CALIB, "calib"), (RIG, "prev_rig"), (RIG, "next_rig"), (GRAVITY, None)],
        optional=False,
        res_dim=9,
    ),
    "inertial_secondary": dict(
        local=_secondary_local,
        args=_secondary_args,
        tangents=[(IMU_CALIB, "calib"), (RIG, "prev_rig"), (RIG, "next_rig"),
                  (IMU_EXTR, "prev_extr"), (IMU_EXTR, "next_extr"), (GRAVITY, None)],
        optional=False,
        res_dim=9,
    ),
    "omega_prior": dict(
        local=_omega_prior_local,
        args=_omega_prior_args,
        tangents=[(RIG, "rig"), (IMU_EXTR, "extr")],
        optional=False,
        res_dim=3,
    ),
    "rw_imu_calib": dict(
        local=_rw_imu_calib_local,
        args=_rw_pair_args(lambda v: v.imu_calib),
        tangents=[(IMU_CALIB, "prev"), (IMU_CALIB, "next")],
        optional=False,
        res_dim=23,
    ),
    "rw_cam_intr": dict(
        local=_rw_cam_intr_local,
        args=_rw_pair_args(lambda v: v.cam_intr),
        tangents=[(CAM_INTR, "prev"), (CAM_INTR, "next")],
        optional=False,
        res_dim=17,
    ),
    "rw_cam_extr": dict(
        local=_rw_se3_local,
        args=_rw_se3_args(lambda v: v.cam_extr_q, lambda v: v.cam_extr_t),
        tangents=[(CAM_EXTR, "prev"), (CAM_EXTR, "next")],
        optional=False,
        res_dim=6,
    ),
    "rw_imu_extr": dict(
        local=_rw_se3_local,
        args=_rw_se3_args(lambda v: v.imu_extr_q, lambda v: v.imu_extr_t),
        tangents=[(IMU_EXTR, "prev"), (IMU_EXTR, "next")],
        optional=False,
        res_dim=6,
    ),
    "pose_prior": dict(
        local=_pose_prior_local,
        args=lambda v, d: {"pose_q": _take(v.pose_q, d["rig"]), "pose_t": _take(v.pose_t, d["rig"]),
                           "ref_q": d["ref_q"], "ref_t": d["ref_t"], "sqrt_h": d["sqrt_h"]},
        tangents=[(RIG, "rig")],
        optional=False,
        res_dim=6,
    ),
    "position_yaw_prior": dict(
        local=_position_yaw_prior_local,
        args=_position_yaw_prior_args,
        tangents=[(RIG, "rig")],
        optional=False,
        res_dim=4,
    ),
    "imu_calib_prior": dict(
        local=_imu_calib_prior_local,
        args=lambda v, d: {"calib": _take(v.imu_calib, d["calib"]), "ref": d["ref"],
                           "sqrt_h": d["sqrt_h"]},
        tangents=[(IMU_CALIB, "calib")],
        optional=False,
        res_dim=23,
    ),
    "cam_intr_prior": dict(
        local=_cam_intr_prior_local,
        args=lambda v, d: {"intr": _take(v.cam_intr, d["intr"]), "ref": d["ref"],
                           "sqrt_h": d["sqrt_h"]},
        tangents=[(CAM_INTR, "intr")],
        optional=False,
        res_dim=17,
    ),
    "cam_extr_prior": dict(
        local=_se3_prior_local,
        args=_se3_prior_args(lambda v: v.cam_extr_q, lambda v: v.cam_extr_t),
        tangents=[(CAM_EXTR, "idx")],
        optional=False,
        res_dim=6,
    ),
    "imu_extr_prior": dict(
        local=_se3_prior_local,
        args=_se3_prior_args(lambda v: v.imu_extr_q, lambda v: v.imu_extr_t),
        tangents=[(IMU_EXTR, "idx")],
        optional=False,
        res_dim=6,
    ),
}


def batch_indices(cfg: BatchCfg, data) -> list:
    """(group, index tensor) pairs of the batch's tangents in REGISTRY order
    (a group without an index field, gravity, gets index 0)."""
    n = _batch_size(data)
    device = next(a.device for k, a in data.items()
                  if isinstance(a, torch.Tensor) and not k.startswith("_"))
    return [(group, torch.zeros(n, dtype=torch.int32, device=device) if field is None
             else data[field]) for group, field in REGISTRY[cfg.kind]["tangents"]]


def _batch_size(data) -> int:
    for k, a in data.items():
        if k.startswith("_"):
            continue
        if isinstance(a, torch.Tensor) and a.ndim >= 1:
            return a.shape[0]
    raise ValueError("empty batch")


def _fused_visual(cfg, data):
    return cfg.kind == "visual" and cfg.block_info is not None


# the active groups a fused linearizer computes: pose + point, or pose +
# point + extrinsics + intrinsics
_FUSED_GROUPS = ({POINTS, RIG}, {POINTS, RIG, CAM_EXTR, CAM_INTR})


def fused_linearizer(cfg) -> bool:
    """Whether linearize_batch takes a fused kernel for cfg: K1 or K11 for a
    blocked visual batch, K7 for a blocked rolling-shutter one, each with
    pose + point (+ extr + intr) active."""
    return (cfg.kind in ("visual", "rs_visual") and cfg.block_info is not None
            and cfg.active_groups is not None and set(cfg.active_groups) in _FUSED_GROUPS)


def residual_batch(cfg: BatchCfg, data, v: VariableTables):
    """Whitened residuals (N, d) + validity at the current variables."""
    if _fused_visual(cfg, data):
        from ..ops import visual_fused

        res, valid = visual_fused.residual_visual_fused(
            cfg.camera_kind, data, v, None, cfg.block_info)
        return res.T, valid
    if cfg.kind == "rs_visual" and cfg.block_info is not None:
        from ..ops import rs_fused

        res, valid = rs_fused.residual_rs_fused(cfg.camera_kind, data, v)
        return res.T, valid
    return residual_generic(cfg, data, v)


def residual_generic(cfg: BatchCfg, data, v: VariableTables):
    """residual_batch through the vmapped local function."""
    spec = REGISTRY[cfg.kind]
    args = spec["args"](v, data)
    zeros = tuple(torch.zeros(GROUP_DIMS[g], dtype=v.points.dtype, device=v.points.device)
                  for g, _ in spec["tangents"])

    def row(ar):
        _, (res, valid) = spec["local"](zeros, ar, cfg)
        return res, valid

    res, valid = vmap(row)(args)
    valid = valid.to(v.points.dtype)
    if "_pad" in data:  # padded grid rows never count as failing
        valid = torch.maximum(valid, data["_pad"].to(valid.dtype))
    return res, valid


def linearize_batch(cfg: BatchCfg, data, v: VariableTables, masks: Masks) -> Lin:
    """Residuals + per-factor Jacobian blocks (vmapped AD, or a fused
    linearizer for blocked visual batches).

    Tangents of groups not in cfg.active_groups are held at zero as constants
    (not differentiated), so constant variable groups cost nothing."""
    if not fused_linearizer(cfg):
        return linearize_generic(cfg, data, v, masks)
    if CAM_INTR in cfg.active_groups:
        if cfg.kind == "visual":
            from ..ops import visual_fused

            res, valid, J_pt, J_r, J_cal = visual_fused.linearize_visual_cal_fused(
                cfg.camera_kind, data, v, masks, cfg.block_info)
        else:
            from ..ops import rs_fused

            res, valid, J_pt, J_r, J_cal = rs_fused.linearize_rs_fused(
                cfg.camera_kind, data, v, masks, True)
        return Lin(res=res, valid=valid, groups=(POINTS, RIG, CAM_EXTR, CAM_INTR),
                   idx=(data["point"], data["rig"], data["extr"], data["intr"]),
                   jac=(J_pt, J_r, J_cal[:, 0:6], J_cal[:, 6:23]),
                   ell=(None, None, None, None))
    if cfg.kind == "visual":
        from ..ops import visual_fused

        res, valid, J_pt, J_r = visual_fused.linearize_visual_fused(
            cfg.camera_kind, data, v, masks, cfg.block_info)
    else:
        from ..ops import rs_fused

        res, valid, J_pt, J_r = rs_fused.linearize_rs_fused(cfg.camera_kind, data, v, masks,
                                                             False)
    return Lin(res=res, valid=valid, groups=(POINTS, RIG),
               idx=(data["point"], data["rig"]), jac=(J_pt, J_r), ell=(None, None))


def linearize_generic(cfg: BatchCfg, data, v: VariableTables, masks: Masks) -> Lin:
    """linearize_batch through vmapped AD of the local function, in chunks
    of LINEARIZE_CHUNK factors."""
    spec = REGISTRY[cfg.kind]
    args = spec["args"](v, data)
    n = _batch_size(data)
    dtype, device = v.points.dtype, v.points.device
    tangents = spec["tangents"]
    if cfg.active_groups is not None:
        active = [i for i, (g, _) in enumerate(tangents) if g in cfg.active_groups]
    else:
        active = list(range(len(tangents)))
    if not active:  # every group constant: the batch only adds its cost
        res, valid = residual_generic(cfg, data, v)
        return Lin(res=res.T.contiguous(), valid=valid, groups=(), idx=(), jac=(), ell=())
    zeros_full = tuple(torch.zeros(GROUP_DIMS[g], dtype=dtype, device=device)
                       for g, _ in tangents)
    zeros_active = tuple(zeros_full[i] for i in active)

    # reverse mode when the active tangent is much wider than the residual
    # (the JAX package's rule; both are exact AD of the same function)
    n_active_dims = sum(GROUP_DIMS[tangents[i][0]] for i in active)
    jac_mode = jacrev if n_active_dims > spec["res_dim"] + 2 else jacfwd

    def row(ar):
        def f(ts_active):
            ts = list(zeros_full)
            for pos, i in enumerate(active):
                ts[i] = ts_active[pos]
            return spec["local"](tuple(ts), ar, cfg)

        jacs_active, (res, valid) = jac_mode(f, has_aux=True)(zeros_active)
        return jacs_active, res, valid

    outs = [vmap(row)({k: a[s:s + LINEARIZE_CHUNK] for k, a in args.items()})
            for s in range(0, n, LINEARIZE_CHUNK)]
    if len(outs) == 1:
        jacs_active, res, valid = outs[0]
    else:
        jacs_active = tuple(torch.cat([o[0][p] for o in outs]) for p in range(len(active)))
        res = torch.cat([o[1] for o in outs])
        valid = torch.cat([o[2] for o in outs])
    res = res.T.contiguous()  # (d, N)
    valid = valid.to(dtype)
    if "_pad" in data:  # padded grid rows never count as failing
        valid = torch.maximum(valid, data["_pad"].to(dtype))

    idx, masked_jacs, groups_out, ells = [], [], [], []
    for pos, i in enumerate(active):
        group, field = tangents[i]
        J = jacs_active[pos]  # (N, d, dim)
        ix = (torch.zeros(n, dtype=torch.int32, device=device) if field is None
              else data[field])
        m = getattr(masks, group)
        mgT = m[:, None].expand(m.shape[0], n) if m.ndim == 1 else _take(m, ix).T
        # (forward-mode AD through so3_log returns float64 tangents from
        # float32 inputs: cast back to the problem's type)
        masked_jacs.append((J.permute(1, 2, 0).to(dtype) * mgT[None]).contiguous())
        idx.append(ix)
        groups_out.append(group)
        ells.append(data.get(f"_ell{i}"))
    return Lin(res=res, valid=valid, groups=tuple(groups_out),
               idx=tuple(idx), jac=tuple(masked_jacs), ell=tuple(ells))
