"""Rolling-shutter pose-shift tables as fixed-size tensors + interpolation.

Port of `visual_inertial_bundle_adjustment_tpu/ops/rolling_shutter.py`
(reference lib/motion/preintegration/RollingShutterData.{h,cpp}): per rig,
IMU-integrated relative poses (RVPs) are sampled at gyro boundaries over
+-(readout/2 + slack) around the frame midpoint, re-based to the midpoint,
and turned into per-interval constant-signal interpolants via
`rvp_differentiate`. The reference's std::vector + upper_bound becomes
fixed-K padded tensors + a bucketed search; the out-of-range throw
(RollingShutterData.cpp:83-91) becomes a validity flag that masks the factor.
The JAX package's per-rig `vmap` is the leading batch dimension here.

Tables are rebuilt whenever the IMU calibration / gravity estimate is
refreshed, the counterpart of updateRollingShutterData
(viba/single_session/InitCalibration.cpp:299-325).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .motion import (RotVelPos, RVPInterpolation, rvp_combine, rvp_differentiate,
                     rvp_integrate_interp, rvp_uncombine_left)
from .preintegration import PreintInterval, integrate_measurements


class RSTables(NamedTuple):
    """Per-rig sampled relative motion around the frame midpoint."""

    dt: torch.Tensor  # (R, K) sample times rel. midpoint, ascending, +inf pad
    q: torch.Tensor  # (R, K, 4) R_mid_t
    dV: torch.Tensor  # (R, K, 3)
    dP: torch.Tensor  # (R, K, 3)
    i_gyro: torch.Tensor  # (R, K, 3) interpolants for segment [k, k+1)
    i_accel: torch.Tensor  # (R, K, 3)
    i_dvel: torch.Tensor  # (R, K, 3)
    count: torch.Tensor  # (R,) valid sample count (int64)
    gravity_w: torch.Tensor  # (3,) gravity at table build time (constant)


def tables_to(tables: RSTables, device=None, dtype=None) -> RSTables:
    """Move the tables; float fields to `dtype`, the count stays integral."""
    return RSTables(*(a.to(device=device, dtype=dtype) if a.is_floating_point()
                      else a.to(device=device) for a in tables))


def _compact(values, mask, K):
    """Scatter the masked steps of each row into its first `count` slots of K:
    values are (R, S, ...) tensors, mask (R, S)."""
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    idx = torch.where(mask, pos, torch.full_like(pos, K))  # dumped to the overflow slot
    R = mask.shape[0]

    def scat(v):
        out = torch.zeros((R, K + 1) + v.shape[2:], dtype=v.dtype, device=v.device)
        ix = idx.reshape(idx.shape + (1,) * (v.ndim - 2)).expand(v.shape)
        return out.scatter(1, ix, v)[:, :K]

    return tuple(scat(v) for v in values), mask.to(torch.int64).sum(1)


def _bcast(a, like):
    return a.reshape(a.shape + (1,) * (like.ndim - a.ndim))


def build_rs_tables(calibs, first_halves: PreintInterval, second_halves: PreintInterval,
                    gravity_w, num_steps: int, K: int) -> RSTables:
    """Tables of R rigs: calibs (R, 23); first_halves cover [mid - half,
    mid], second_halves [mid, mid + half] (times relative to each window's
    start)."""
    rvp1, pre1, gyro1, _, act1 = integrate_measurements(calibs, first_halves, num_steps)
    rvp2, pre2, gyro2, _, act2 = integrate_measurements(calibs, second_halves, num_steps)

    # first half: prefixes at gyro boundaries, re-based to the midpoint
    reb = rvp_uncombine_left(pre1, RotVelPos(rvp1.q[:, None], rvp1.dV[:, None],
                                             rvp1.dP[:, None], rvp1.dt[:, None]))
    c1, n1 = _compact((reb.q, reb.dV, reb.dP, reb.dt), gyro1 & act1, K)
    # second half: prefixes (identity at mid is the first emission) + final
    c2, n2 = _compact((pre2.q, pre2.dV, pre2.dP, pre2.dt), gyro2 & act2, K)

    R = calibs.shape[0]
    idx = torch.arange(K, device=calibs.device)[None, :].expand(R, K)
    n1e, n2e = n1[:, None], n2[:, None]

    def merge(a, b, fin):  # [a[0:n1], b[0:n2], fin]
        shifted_b = torch.gather(
            b, 1, _bcast(torch.clamp(idx - n1e, 0, K - 1), b).expand(b.shape))
        out = torch.where(_bcast(idx < n1e, a), a, torch.zeros_like(a))
        out = torch.where(_bcast((idx >= n1e) & (idx < n1e + n2e), a), shifted_b, out)
        return torch.where(_bcast(idx == n1e + n2e, a), fin[:, None].expand_as(a), out)

    count = n1 + n2 + 1
    q = merge(c1[0], c2[0], rvp2.q)
    dV = merge(c1[1], c2[1], rvp2.dV)
    dP = merge(c1[2], c2[2], rvp2.dP)
    dt = merge(c1[3], c2[3], rvp2.dt)
    dt = torch.where(idx < count[:, None], dt, torch.full_like(dt, float("inf")))

    # interpolants per segment
    nxt = torch.clamp(idx + 1, 0, K - 1)
    seg_valid = (idx + 1) < count[:, None]
    cur = RotVelPos(q, dV, dP, torch.where(torch.isfinite(dt), dt, torch.zeros_like(dt)))
    nxt_rvp = RotVelPos(*(torch.gather(a, 1, _bcast(nxt, a).expand(a.shape)) for a in cur))
    delta = rvp_uncombine_left(nxt_rvp, cur)
    safe_dt = torch.where(seg_valid & (delta.dt > 0), delta.dt, torch.ones_like(delta.dt))
    interp = rvp_differentiate(delta._replace(dt=safe_dt))
    sv = seg_valid[..., None]
    zero = torch.zeros_like(interp.gyro)
    return RSTables(dt, q, dV, dP, torch.where(sv, interp.gyro, zero),
                    torch.where(sv, interp.accel, zero), torch.where(sv, interp.delta_vel, zero),
                    count, gravity_w)


def build_rs_table(calib, first_half: PreintInterval, second_half: PreintInterval, gravity_w,
                   num_steps: int, K: int):
    """One rig's table: calib (23,), the halves' fields without the batch
    axis; build_rs_tables on a batch of one. Returns ((dt, q, dV, dP,
    i_gyro, i_accel, i_dvel, count), gravity_w), as the JAX package's does."""
    one = build_rs_tables(calib[None], PreintInterval(*(a[None] for a in first_half)),
                          PreintInterval(*(a[None] for a in second_half)), gravity_w,
                          num_steps, K)
    return tuple(a[0] for a in one[:-1]), gravity_w


class RSEstimate(NamedTuple):
    q_mid_t: torch.Tensor  # (..., 4) R_mid_imuAtT
    p_mid_t: torch.Tensor  # (..., 3) pos of imuAtT in mid frame
    valid: torch.Tensor  # (...,) bool


def rs_segment_lookup(tables: RSTables, rows, t_delta):
    """Per-observation interpolation-segment data without the (N, K) table
    gathers: a two-level bucketed search (every-16th boundary, then the 16
    boundaries of the bucket) with the semantics of searchsorted(side=
    "right"), and one row gather of the packed segment payload. The segment
    is chosen at the CURRENT readout/time-offset and is locally constant
    under AD (reference re-query-per-evaluation, RollingShutterData.cpp:
    70-113)."""
    R, K = tables.dt.shape
    rows = rows.to(torch.int64)
    B = 16
    L1 = -(-K // B)
    dt_pad = torch.nn.functional.pad(tables.dt, (0, L1 * B + 1 - K), value=float("inf"))
    coarse = dt_pad[:, ::B][:, :L1].index_select(0, rows)  # (N, L1)
    cb = (coarse <= t_delta[:, None]).to(torch.int64).sum(1) - 1
    cb = torch.clamp(cb, 0, L1 - 1)
    fine_tab = dt_pad[:, 1:L1 * B + 1].reshape(R * L1, B)
    w = fine_tab.index_select(0, rows * L1 + cb)  # (N, B)
    idx = cb * B + 1 + (w <= t_delta[:, None]).to(torch.int64).sum(1)
    idx = torch.where(coarse[:, 0] <= t_delta, idx, torch.zeros_like(idx))
    valid = (idx > 0) & (idx < tables.count.index_select(0, rows))
    seg = torch.clamp(idx - 1, 0, K - 1)
    packed = torch.cat([tables.dt[..., None], tables.q, tables.dV, tables.dP,
                        tables.i_gyro, tables.i_accel, tables.i_dvel], dim=-1).reshape(R * K, 20)
    seg_row = packed.index_select(0, rows * K + seg)  # (N, 20)
    dt = seg_row[:, 0]
    return dict(
        seg_dt=torch.where(torch.isfinite(dt), dt, torch.zeros_like(dt)),
        seg_q=seg_row[:, 1:5],
        seg_dv=seg_row[:, 5:8],
        seg_dp=seg_row[:, 8:11],
        seg_ig=seg_row[:, 11:14],
        seg_ia=seg_row[:, 14:17],
        seg_idv=seg_row[:, 17:20],
        seg_valid=valid,
    )


def rs_estimate_seg(seg_dt, seg_q, seg_dv, seg_dp, seg_ig, seg_ia, seg_idv, seg_valid,
                    gravity_w, t_delta, vel_world, pose_q):
    """Shifted pose at t_delta (sec, rel. midpoint) from pre-gathered segment
    data (reference RollingShutterData::getEstimate, RollingShutterData.cpp:
    70-113); pose_q is the T_bodyImu_world rotation at the midpoint."""
    prev = RotVelPos(seg_q, seg_dv, seg_dp, seg_dt)
    local = rvp_integrate_interp(RVPInterpolation(seg_ig, seg_ia, seg_idv), t_delta - prev.dt)
    rvp_t = rvp_combine(prev, local)
    grav_mid = lie.quat_rotate(pose_q, gravity_w)
    vel_mid = lie.quat_rotate(pose_q, vel_world)
    td = t_delta[..., None]
    pos_mid_t = rvp_t.dP + vel_mid * td + grav_mid * (0.5 * td * td)
    return RSEstimate(rvp_t.q, pos_mid_t, seg_valid)


def rs_estimate(dt_row, q_row, dV_row, dP_row, ig_row, ia_row, idv_row, count, gravity_w,
                t_delta, vel_world, pose_q):
    """rs_estimate_seg with the segment searched in one rig's table rows
    (dt_row (K,), ...) for a batch of times t_delta (N,)."""
    idx = torch.searchsorted(dt_row.contiguous(), t_delta.contiguous(), right=True)
    valid = (idx > 0) & (idx < count)
    seg = torch.clamp(idx - 1, 0, dt_row.shape[0] - 1)
    sdt = dt_row[seg]
    return rs_estimate_seg(torch.where(torch.isfinite(sdt), sdt, torch.zeros_like(sdt)),
                           q_row[seg], dV_row[seg], dP_row[seg], ig_row[seg], ia_row[seg],
                           idv_row[seg], valid, gravity_w, t_delta, vel_world, pose_q)
