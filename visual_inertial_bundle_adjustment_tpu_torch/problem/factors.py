"""Batched factor types: dense per-type tensors + pure local residual functions.

Port of `visual_inertial_bundle_adjustment_tpu/problem/factors.py`, limited
to the two kinds of the bias-only slice: `visual` (global-shutter
reprojection, reference viba/problem/VisualFactor.cpp:36-120) and `inertial`
(body IMU, viba/problem/InertialFactor.cpp:19-127). The other 14 kinds come
with the full-sensor slice.

Each kind's residual is a pure function of the tangents of the variables it
touches, evaluated at the current linearization point; the generic
linearizer differentiates it with `torch.func.vmap(jacrev/jacfwd)`. Blocked
visual batches (rcs.finalize_blocks) with only pose + point active go through
the fused linearizer of ops/visual_fused.py instead (CUDA kernel K1 on the
card, its plain PyTorch version on the CPU).

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
from .structure import GRAVITY_MAG, POSE, VEL, Masks, VariableTables

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
    column contiguously. `ell` entries are optional transpose plans
    (rows, K) int64 whose row r lists the factors touching variable row r
    (sentinel N for padding): a deterministic gather-sum scatter."""

    res: torch.Tensor  # (d, N)
    valid: torch.Tensor  # (N,) 0/1
    groups: tuple  # tuple of group names
    idx: tuple  # tuple of (N,) index tensors
    jac: tuple  # tuple of (d, dim, N) blocks
    ell: tuple = ()  # tuple of (rows, K) plans or None per entry


def scatter_rows(ell, idx, contrib, num_rows):
    """Sum per-factor columns into variable rows.

    contrib: (dim..., N) with the factor axis LAST; returns (num_rows, dim...).
    ELL gather-sum (deterministic) when a plan exists, index_add_ otherwise."""
    lead = contrib.shape[:-1]
    flat = contrib.reshape(-1, contrib.shape[-1])  # (D, N)
    if ell is None:
        out = torch.zeros((num_rows, flat.shape[0]), dtype=contrib.dtype,
                          device=contrib.device)
        out.index_add_(0, idx, flat.T)
        return out.reshape((num_rows,) + lead)
    ext = torch.cat([flat, flat.new_zeros((flat.shape[0], 1))], dim=1)
    out = ext[:, ell].sum(-1)  # (D, rows)
    return out.T.reshape((ell.shape[0],) + lead)


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
    """Host-side: add per-(batch, tangent) ELL plans into the data dicts.

    Stored under data["_ell{i}"] for tangent position i. Skipped (scatter
    fallback) when the padded plan would exceed max_expand x the factor
    count, and for blocked batches (their reductions run in the segment
    kernels)."""
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
    "inertial": dict(
        local=_inertial_local,
        args=_inertial_args,
        tangents=[(IMU_CALIB, "calib"), (RIG, "prev_rig"), (RIG, "next_rig"), (GRAVITY, None)],
        optional=False,
        res_dim=9,
    ),
}


def _batch_size(data) -> int:
    for k, a in data.items():
        if k.startswith("_"):
            continue
        if isinstance(a, torch.Tensor) and a.ndim >= 1:
            return a.shape[0]
    raise ValueError("empty batch")


def _fused_visual(cfg, data):
    return cfg.kind == "visual" and cfg.block_info is not None


def residual_batch(cfg: BatchCfg, data, v: VariableTables):
    """Whitened residuals (N, d) + validity at the current variables."""
    if _fused_visual(cfg, data):
        from ..ops import visual_fused

        res, valid = visual_fused.residual_visual_fused(
            cfg.camera_kind, data, v, None, cfg.block_info)
        return res.T, valid

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
    """Residuals + per-factor Jacobian blocks (vmapped AD).

    Tangents of groups not in cfg.active_groups are held at zero as constants
    (not differentiated), so constant variable groups cost nothing."""
    if (_fused_visual(cfg, data) and cfg.active_groups is not None
            and set(cfg.active_groups) == {POINTS, RIG}):
        from ..ops import visual_fused

        res, valid, J_pt, J_r = visual_fused.linearize_visual_fused(
            cfg.camera_kind, data, v, masks, cfg.block_info)
        return Lin(res=res, valid=valid, groups=(POINTS, RIG),
                   idx=(data["point"], data["rig"]), jac=(J_pt, J_r),
                   ell=(None, None))

    spec = REGISTRY[cfg.kind]
    args = spec["args"](v, data)
    n = _batch_size(data)
    dtype, device = v.points.dtype, v.points.device
    tangents = spec["tangents"]
    if cfg.active_groups is not None:
        active = [i for i, (g, _) in enumerate(tangents) if g in cfg.active_groups]
    else:
        active = list(range(len(tangents)))
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
        masked_jacs.append((J.permute(1, 2, 0) * mgT[None]).contiguous())
        idx.append(ix)
        groups_out.append(group)
        ells.append(data.get(f"_ell{i}"))
    return Lin(res=res, valid=valid, groups=tuple(groups_out),
               idx=tuple(idx), jac=tuple(masked_jacs), ell=tuple(ells))
