"""IMU preintegration as a two-pointer walk over sample boundaries.

Port of `visual_inertial_bundle_adjustment_tpu/ops/preintegration.py`
(reference lib/motion/preintegration/PreIntegration.cpp). Given padded
per-interval windows of raw gyro / accel samples, one Python loop over the
merged boundary steps, batched over all intervals, merges the two boundary
streams (each shifted by its own clock offset, PreIntegration.cpp:28-111),
compensates each raw sample through the calibration model with Jacobians,
integrates closed-form RVP steps, chains the 9x23 calibration Jacobian, and
propagates the 9x9 covariance with each raw sample's noise independent
across sample transitions (PreIntegration.cpp:237-258). The two time-offset
Jacobian columns follow the reference (PreIntegration.cpp:113-134,
198-215, 260-266). Intervals shorter than the padded step count finish
early and carry their state unchanged (masked updates).

This is host preprocessing for the problem builder (f64, CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import imu as imu_model
from . import lie
from .motion import RotVelPos, rvp_integrate

_MARGIN = 1e-6  # seconds; reference kMarginNs = 1000


class PreintInterval(NamedTuple):
    """Padded raw-sample windows for a batch of integration intervals."""

    gyro_t: torch.Tensor  # (B, S) seconds relative to interval start; padded 1e9
    gyro_v: torch.Tensor  # (B, S, 3) rad/s raw
    accel_t: torch.Tensor  # (B, S) seconds relative to interval start; padded 1e9
    accel_v: torch.Tensor  # (B, S, 3) m/s^2 raw
    t_len: torch.Tensor  # (B,) interval length in seconds


class Preintegration(NamedTuple):
    rvp: RotVelPos  # 9-dof motion integral
    J: torch.Tensor  # (B, 9, 23) Jacobian wrt calibration tangent
    cov: torch.Tensor  # (B, 9, 9) covariance of the RVP tangent
    omega_at_end: torch.Tensor  # (B, 3) compensated gyro at interval end
    calib_eval: torch.Tensor  # (B, 23) calibration evaluation point
    valid: torch.Tensor  # (B,) bool: interval had enough samples


def _d_rvp_d_left_meas(rvp: RotVelPos, gyro, accel):
    """Effect on the total RVP of a (gyro, accel) impulse at its start
    (PreIntegration.cpp:116-125)."""
    return torch.cat([gyro, lie.cross(-rvp.dV, gyro) + accel,
                      accel * rvp.dt[..., None] + lie.cross(-rvp.dP, gyro)], -1)


def _d_rvp_d_end_time(rvp: RotVelPos, gyro, accel):
    """PreIntegration.cpp:131-134."""
    return torch.cat([lie.quat_rotate(rvp.q, gyro), lie.quat_rotate(rvp.q, accel), rvp.dV], -1)


def _left_transform(aRbV, aRbP, b_dt):
    """(B, 9, 9) tangent transform T of `a` under c = combine(a, b)."""
    B = aRbV.shape[0]
    I3 = torch.eye(3, dtype=aRbV.dtype, device=aRbV.device).expand(B, 3, 3)
    Z3 = torch.zeros_like(I3)
    return torch.cat([torch.cat([I3, Z3, Z3], -1),
                      torch.cat([lie.so3_hat(-aRbV), I3, Z3], -1),
                      torch.cat([lie.so3_hat(-aRbP), b_dt[:, None, None] * I3, I3], -1)], -2)


def _block_diag3(R):
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, Z, Z], -1), torch.cat([Z, R, Z], -1),
                      torch.cat([Z, Z, R], -1)], -2)


def _row(a, i):
    """a[b, i[b]] for a (B, S, ...) and i (B,)."""
    return a[torch.arange(a.shape[0], device=a.device), i]


DONE_CHECK_STEPS = 32  # preintegrate_batch's early stop: steps between host reads


def preintegrate_batch(calibs, iv: PreintInterval, noise: imu_model.ImuNoiseModel,
                       num_steps: int) -> Preintegration:
    """Full preintegration of B intervals with per-interval calibrations
    (B, 23); `num_steps` bounds the merged boundary count (gyro + accel).
    The loop stops once every interval is done (checked every
    DONE_CHECK_STEPS steps, one host read each): the steps after that change
    nothing, and a bucket's padding makes num_steps ~3x the steps its
    intervals take."""
    dtype, device = calibs.dtype, calibs.device
    Bn = calibs.shape[0]
    dt_gyro = calibs[:, imu_model.DT_REF_GYRO]
    dt_accel = calibs[:, imu_model.DT_REF_ACCEL]
    t_len = iv.t_len
    ag_all = iv.gyro_t - dt_gyro[:, None]
    aa_all = iv.accel_t - dt_accel[:, None]
    margin = torch.full((Bn, 1), _MARGIN, dtype=dtype, device=device)
    gi = torch.clamp(torch.searchsorted(ag_all.contiguous(), margin, right=True)[:, 0], min=1)
    ai = torch.clamp(torch.searchsorted(aa_all.contiguous(), margin, right=True)[:, 0], min=1)
    S_g, S_a = iv.gyro_t.shape[1], iv.accel_t.shape[1]
    valid = (ag_all[:, S_g - 1] > t_len - _MARGIN) & (aa_all[:, S_a - 1] > t_len - _MARGIN)
    valid &= (gi >= 1) & (ai >= 1)
    sigma_g = noise.gyro_sample_var.to(dtype)
    sigma_a = noise.accel_sample_var.to(dtype)

    def z(*shape):
        return torch.zeros((Bn,) + shape, dtype=dtype, device=device)

    false = torch.zeros(Bn, dtype=torch.bool, device=device)
    s = dict(gi=gi, ai=ai, t_prev=z(),
             q=lie.quat_identity((Bn,), dtype, device), dV=z(3), dP=z(3), dt=z(),
             J=z(9, imu_model.CALIB_DIM), cov=z(9, 9), from_g=z(9, 3), from_a=z(9, 3),
             prev_cg=z(3), prev_ca=z(3), prev_rg=z(3), prev_ra=z(3),
             trans_g=false, trans_a=false, start_g=z(3), start_a=z(3), done=false)

    for step in range(num_steps):
        is_first = step == 0
        gic = torch.clamp(s["gi"], 0, S_g - 1)
        aic = torch.clamp(s["ai"], 0, S_a - 1)
        ag = _row(iv.gyro_t, gic) - dt_gyro
        aa = _row(iv.accel_t, aic) - dt_accel
        last = (ag > t_len - _MARGIN) & (aa > t_len - _MARGIN)
        t_end = torch.where(last, t_len, torch.minimum(ag, aa))
        dt = t_end - s["t_prev"]
        active = ~s["done"]

        raw_g = _row(iv.gyro_v, gic)
        raw_a = _row(iv.accel_v, aic)
        cg, ca, calib_jac, meas_jac = imu_model.compensate_with_jac(calibs, raw_g, raw_a)
        step_rvp, J_cm = rvp_integrate(cg, ca, dt, with_jac=True)  # (B, 9, 6)
        step_raw_jac = J_cm @ meas_jac
        step_calib_jac = J_cm @ calib_jac

        # gyro/accel time-offset column by boundary sliding at accel transitions
        fg, fa = imu_model.compensate(calibs, raw_g, s["prev_ra"])
        bg, ba = imu_model.compensate(calibs, s["prev_rg"], raw_a)
        use_al = (s["trans_g"] & s["trans_a"])[:, None]
        dg = torch.where(use_al, (bg - s["prev_cg"] + cg - fg) * 0.5, cg - s["prev_cg"])
        da = torch.where(use_al, (ba - s["prev_ca"] + ca - fa) * 0.5, ca - s["prev_ca"])
        slide_col = _d_rvp_d_left_meas(step_rvp, dg, da)
        col = torch.where(s["trans_a"][:, None], slide_col, torch.zeros_like(slide_col))
        step_calib_jac = torch.cat([step_calib_jac[:, :, :imu_model.GYRO_ACCEL_TIME_OFFSET],
                                    (step_calib_jac[:, :, imu_model.GYRO_ACCEL_TIME_OFFSET]
                                     + col)[:, :, None]], -1)

        q, dV, dP = s["q"], s["dV"], s["dP"]
        aRbV = lie.quat_rotate(q, step_rvp.dV)
        aRbP = lie.quat_rotate(q, step_rvp.dP)
        T = _left_transform(aRbV, aRbP, step_rvp.dt)
        Rb = _block_diag3(lie.quat_to_matrix(q))
        new_J = T @ s["J"] + Rb @ step_calib_jac
        new_cov = T @ s["cov"] @ T.transpose(-1, -2)
        from_g = T @ s["from_g"]
        from_a = T @ s["from_a"]
        tg = s["trans_g"][:, None, None]
        ta = s["trans_a"][:, None, None]
        new_cov = new_cov + torch.where(tg, (from_g * sigma_g) @ from_g.transpose(-1, -2),
                                        torch.zeros_like(new_cov))
        from_g = torch.where(tg, torch.zeros_like(from_g), from_g)
        new_cov = new_cov + torch.where(ta, (from_a * sigma_a) @ from_a.transpose(-1, -2),
                                        torch.zeros_like(new_cov))
        from_a = torch.where(ta, torch.zeros_like(from_a), from_a)
        rb_raw = Rb @ step_raw_jac
        bump_g = ag <= aa
        bump_a = aa <= ag
        new = dict(
            gi=gic + bump_g.to(gic.dtype),
            ai=aic + bump_a.to(aic.dtype),
            t_prev=t_end,
            q=lie.quat_mul(q, step_rvp.q),
            dV=dV + aRbV,
            dP=dP + dV * step_rvp.dt[:, None] + aRbP,
            dt=s["dt"] + step_rvp.dt,
            J=new_J, cov=new_cov,
            from_g=from_g + rb_raw[:, :, 0:3], from_a=from_a + rb_raw[:, :, 3:6],
            prev_cg=cg, prev_ca=ca, prev_rg=raw_g, prev_ra=raw_a,
            trans_g=bump_g & ~last, trans_a=bump_a & ~last,
            start_g=cg if is_first else s["start_g"],
            start_a=ca if is_first else s["start_a"],
            done=s["done"] | last,
        )
        s = {k: torch.where(active.reshape((Bn,) + (1,) * (a.ndim - 1)), a, s[k])
             for k, a in new.items()}
        if step % DONE_CHECK_STEPS == DONE_CHECK_STEPS - 1 and bool(s["done"].all()):
            break

    valid = valid & s["done"]
    rvp = RotVelPos(s["q"], s["dV"], s["dP"], s["dt"])
    cov = (s["cov"] + (s["from_g"] * sigma_g) @ s["from_g"].transpose(-1, -2)
           + (s["from_a"] * sigma_a) @ s["from_a"].transpose(-1, -2))
    ref_col = (_d_rvp_d_left_meas(rvp, -s["start_g"], -s["start_a"])
               + _d_rvp_d_end_time(rvp, s["prev_cg"], s["prev_ca"]))
    J = torch.cat([s["J"][:, :, :imu_model.REF_TIME_OFFSET], ref_col[:, :, None],
                   s["J"][:, :, imu_model.REF_TIME_OFFSET + 1:]], -1)
    return Preintegration(rvp=rvp, J=J, cov=cov, omega_at_end=s["prev_cg"],
                          calib_eval=calibs, valid=valid)


def integrate_measurements(calibs, iv: PreintInterval, num_steps: int):
    """RVP-only integration of B intervals (reference PreIntegration.cpp:
    278-311), plus the per-step prefix RVPs and boundary flags that the
    rolling-shutter tables need (forEachIntegratedMeasurement,
    PreIntegration.cpp:313-349).

    Returns (final_rvp, prefix_rvps, at_gyro_boundary, at_accel_boundary,
    step_active); prefix arrays are (B, num_steps, ...), and prefix k is the
    integral BEFORE step k (the first flagged entry is the identity at the
    interval start)."""
    dtype, device = calibs.dtype, calibs.device
    Bn = calibs.shape[0]
    dt_gyro = calibs[:, imu_model.DT_REF_GYRO]
    dt_accel = calibs[:, imu_model.DT_REF_ACCEL]
    t_len = iv.t_len
    ag_all = (iv.gyro_t - dt_gyro[:, None]).contiguous()
    aa_all = (iv.accel_t - dt_accel[:, None]).contiguous()
    margin = torch.full((Bn, 1), _MARGIN, dtype=dtype, device=device)
    gi = torch.clamp(torch.searchsorted(ag_all, margin, right=True)[:, 0], min=1)
    ai = torch.clamp(torch.searchsorted(aa_all, margin, right=True)[:, 0], min=1)
    S_g, S_a = iv.gyro_t.shape[1], iv.accel_t.shape[1]
    false = torch.zeros(Bn, dtype=torch.bool, device=device)
    t_prev = torch.zeros(Bn, dtype=dtype, device=device)
    q = lie.quat_identity((Bn,), dtype, device)
    dV = torch.zeros((Bn, 3), dtype=dtype, device=device)
    dP = torch.zeros_like(dV)
    dt_tot = torch.zeros_like(t_prev)
    trans_g, trans_a, done = false, false, false
    pre_q, pre_dV, pre_dP, pre_dt, at_g, at_a, acts = [], [], [], [], [], [], []
    for step in range(num_steps):
        gic = torch.clamp(gi, 0, S_g - 1)
        aic = torch.clamp(ai, 0, S_a - 1)
        ag = _row(iv.gyro_t, gic) - dt_gyro
        aa = _row(iv.accel_t, aic) - dt_accel
        last = (ag > t_len - _MARGIN) & (aa > t_len - _MARGIN)
        t_end = torch.where(last, t_len, torch.minimum(ag, aa))
        active = ~done
        cg, ca = imu_model.compensate(calibs, _row(iv.gyro_v, gic), _row(iv.accel_v, aic))
        st = rvp_integrate(cg, ca, t_end - t_prev)
        # emit the PRE-step prefix with this step's boundary flags
        first = step == 0
        pre_q.append(q)
        pre_dV.append(dV)
        pre_dP.append(dP)
        pre_dt.append(dt_tot)
        at_g.append((trans_g | first) & active)
        at_a.append((trans_a | first) & active)
        acts.append(active)
        bump_g = ag <= aa
        bump_a = aa <= ag
        a1, a3 = active[:, None], active
        new_q = lie.quat_mul(q, st.q)
        new_dV = dV + lie.quat_rotate(q, st.dV)
        new_dP = dP + dV * st.dt[:, None] + lie.quat_rotate(q, st.dP)
        q = torch.where(a1, new_q, q)
        dV, dP = torch.where(a1, new_dV, dV), torch.where(a1, new_dP, dP)
        dt_tot = torch.where(a3, dt_tot + st.dt, dt_tot)
        gi = torch.where(a3, gi + bump_g.to(gi.dtype), gi)
        ai = torch.where(a3, ai + bump_a.to(ai.dtype), ai)
        t_prev = torch.where(a3, t_end, t_prev)
        trans_g = torch.where(a3, bump_g & ~last, trans_g)
        trans_a = torch.where(a3, bump_a & ~last, trans_a)
        done = done | (last & active)
    prefix = RotVelPos(torch.stack(pre_q, 1), torch.stack(pre_dV, 1), torch.stack(pre_dP, 1),
                       torch.stack(pre_dt, 1))
    return (RotVelPos(q, dV, dP, dt_tot), prefix, torch.stack(at_g, 1), torch.stack(at_a, 1),
            torch.stack(acts, 1))
