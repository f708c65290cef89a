"""RotVelPos motion-integral algebra (batched).

Port of `visual_inertial_bundle_adjustment_tpu/ops/motion.py` (reference
lib/motion/preintegration/MotionIntegral.{h,cpp}): the RotVelPos{R, dV, dP,
dt} group element with combine(a, b) = {a.R b.R, a.dV + a.R b.dV,
a.dP + a.dV b.dt + a.R b.dP, a.dt + b.dt} and its left inverse, the
closed-form integration of a constant (gyro, accel) signal with its
Jacobian (MotionIntegral.cpp:123-226), and `rvp_differentiate`, which turns
an RVP into the constant signal that reproduces it, for the rolling-shutter
interpolants (MotionIntegral.cpp:88-121). Rotations are quaternions (wxyz);
Jacobians use the 9-dim tangent [rot(3), dV(3), dP(3)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie


class RotVelPos(NamedTuple):
    q: torch.Tensor  # (..., 4) R_prev_next as quaternion
    dV: torch.Tensor  # (..., 3) accel integral in prev frame
    dP: torch.Tensor  # (..., 3) accel double integral in prev frame
    dt: torch.Tensor  # (...,) seconds


def rvp_identity(batch_shape=(), dtype=torch.float64, device=None) -> RotVelPos:
    shape = tuple(batch_shape)
    return RotVelPos(lie.quat_identity(shape, dtype, device),
                     torch.zeros(shape + (3,), dtype=dtype, device=device),
                     torch.zeros(shape + (3,), dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def rvp_boxminus(a: RotVelPos, b: RotVelPos):
    """The 9-dim tangent [rot, dV, dP] from b to a (rotation on the left)."""
    return torch.cat([lie.so3_log(lie.quat_mul(a.q, lie.quat_conj(b.q))), a.dV - b.dV,
                      a.dP - b.dP], dim=-1)


def rvp_boxplus(b: RotVelPos, delta) -> RotVelPos:
    return RotVelPos(lie.quat_mul(lie.so3_exp(delta[..., :3]), b.q), delta[..., 3:6] + b.dV,
                     delta[..., 6:9] + b.dP, b.dt)


def rvp_combine(a: RotVelPos, b: RotVelPos) -> RotVelPos:
    return RotVelPos(
        lie.quat_mul(a.q, b.q),
        a.dV + lie.quat_rotate(a.q, b.dV),
        a.dP + a.dV * b.dt[..., None] + lie.quat_rotate(a.q, b.dP),
        a.dt + b.dt,
    )


def rvp_uncombine_left(c: RotVelPos, a: RotVelPos) -> RotVelPos:
    """Return b such that c = combine(a, b)."""
    qa_inv = lie.quat_conj(a.q)
    b_dt = c.dt - a.dt
    return RotVelPos(
        lie.quat_mul(qa_inv, c.q),
        lie.quat_rotate(qa_inv, c.dV - a.dV),
        lie.quat_rotate(qa_inv, c.dP - a.dP - a.dV * b_dt[..., None]),
        b_dt,
    )


def rvp_uncombine_right(c: RotVelPos, b: RotVelPos) -> RotVelPos:
    """Return a such that c = combine(a, b)."""
    a_q = lie.quat_mul(c.q, lie.quat_conj(b.q))
    a_dV = c.dV - lie.quat_rotate(a_q, b.dV)
    a_dP = c.dP - a_dV * b.dt[..., None] - lie.quat_rotate(a_q, b.dP)
    return RotVelPos(a_q, a_dV, a_dP, c.dt - b.dt)


def rvp_combine_jacs(a: RotVelPos, b: RotVelPos, aJac, bJac):
    """combine(a, b) plus the chain rule on stacked Jacobians (..., 9, N):
    aJac / bJac map some parameter tangent to the RVP tangents of a and b;
    the returned cJac maps it to the tangent of c = combine(a, b)
    (MotionIntegral.cpp:52-75)."""
    aRbV = lie.quat_rotate(a.q, b.dV)
    aRbP = lie.quat_rotate(a.q, b.dP)
    c = RotVelPos(lie.quat_mul(a.q, b.q), a.dV + aRbV, a.dP + a.dV * b.dt[..., None] + aRbP,
                  a.dt + b.dt)
    aR = lie.quat_to_matrix(a.q)
    aJ_r, aJ_v, aJ_p = aJac[..., 0:3, :], aJac[..., 3:6, :], aJac[..., 6:9, :]
    bJ_r, bJ_v, bJ_p = bJac[..., 0:3, :], bJac[..., 3:6, :], bJac[..., 6:9, :]
    cJ_r = aJ_r + aR @ bJ_r
    cJ_v = aJ_v + lie.so3_hat(-aRbV) @ aJ_r + aR @ bJ_v
    cJ_p = aJ_p + aJ_v * b.dt[..., None, None] + lie.so3_hat(-aRbP) @ aJ_r + aR @ bJ_p
    return c, torch.cat([cJ_r, cJ_v, cJ_p], dim=-2)


def _mv(M, x):
    return torch.einsum("...ij,...j->...i", M, x)


def _integration_coeffs(theta2, with_derivs: bool):
    """Taylor-guarded closed-form coefficients c1..c3 (and d1..d3)."""
    theta = torch.sqrt(theta2 + 1e-30)
    th4 = theta2 * theta2
    small = theta < 1e-3
    one = torch.ones_like(theta2)
    theta2s = torch.where(small, one, theta2)
    th4s = theta2s * theta2s
    s_over = torch.sin(theta) / torch.where(small, one, theta)
    mC_over = (1.0 - torch.cos(theta)) / theta2s
    F2, F3, F4, F5, F6, F7, F8, F9, F10 = (
        2.0, 6.0, 24.0, 120.0, 729.0, 5040.0, 40320.0, 362880.0, 3628800.0,
    )  # F6 is the reference's constant, kept for agreement of the guard
    c1 = torch.where(small, 1.0 / F2 - theta2 / F4 + th4 / F6, mC_over)
    c2 = torch.where(small, 1.0 / F3 - theta2 / F5 + th4 / F7, (1.0 - s_over) / theta2s)
    c3 = torch.where(small, 1.0 / F4 - theta2 / F6 + th4 / F8, (0.5 - mC_over) / theta2s)
    if not with_derivs:
        return c1, c2, c3, None, None, None
    d1 = torch.where(small, -2.0 / F4 + theta2 * (4.0 / F6) + th4 * (6.0 / F8),
                     (s_over - 2.0 * mC_over) / theta2s)
    d2 = torch.where(small, -2.0 / F5 + theta2 * (4.0 / F7) + th4 * (6.0 / F9),
                     (mC_over - 3.0 * c2) / theta2s)
    d3 = torch.where(small, -2.0 / F6 + theta2 * (4.0 / F8) + th4 * (6.0 / F10),
                     (-1.0 - s_over + 4.0 * mC_over) / th4s)
    return c1, c2, c3, d1, d2, d3


def rvp_integrate(gyro, accel, dt, with_jac: bool = False):
    """Exact integral of a constant (gyro, accel) signal over dt; with_jac
    also returns the (..., 9, 6) Jacobian wrt (gyro, accel)."""
    dte = dt[..., None]
    omega = gyro * dte
    upsilon = accel * dte
    q = lie.so3_exp(omega)
    theta2 = (omega * omega).sum(-1)
    c1, c2, c3, d1, d2, d3 = _integration_coeffs(theta2, with_jac)
    Omega = lie.so3_hat(omega)
    Omega_sq = Omega @ Omega
    eye = torch.eye(3, dtype=gyro.dtype, device=gyro.device).expand(Omega.shape)
    c1e, c2e, c3e = c1[..., None, None], c2[..., None, None], c3[..., None, None]
    U2V = eye + c1e * Omega + c2e * Omega_sq
    U2P = 0.5 * eye + c2e * Omega + c3e * Omega_sq
    rvp = RotVelPos(q, _mv(U2V, upsilon), _mv(U2P, upsilon * dte), dt)
    if not with_jac:
        return rvp

    d1e, d2e, d3e = d1[..., None, None], d2[..., None, None], d3[..., None, None]
    dtee = dte[..., None]
    DwXu_Dw = lie.so3_hat(-upsilon) * dtee
    DwXwXu_Dw = lie.so3_hat(-lie.cross(omega, upsilon)) * dtee + Omega @ DwXu_Dw
    V_D1 = _mv(d1e * Omega + d2e * Omega_sq, upsilon)
    JV = V_D1[..., :, None] * omega[..., None, :] * dtee
    JV2 = c1e * DwXu_Dw + c2e * DwXwXu_Dw
    P_D1 = _mv(d2e * Omega + d3e * Omega_sq, upsilon * dte)
    JP = P_D1[..., :, None] * omega[..., None, :] * dtee
    JP2 = (c2e * DwXu_Dw + c3e * DwXwXu_Dw) * dtee
    Z = torch.zeros_like(U2V)
    jac = torch.cat([torch.cat([U2V * dtee, Z], -1),
                     torch.cat([JV + JV2, U2V * dtee], -1),
                     torch.cat([JP + JP2, U2P * dtee * dtee], -1)], -2)
    return rvp, jac


class RVPInterpolation(NamedTuple):
    gyro: torch.Tensor  # (..., 3) rad/s
    accel: torch.Tensor  # (..., 3) m/s^2
    delta_vel: torch.Tensor  # (..., 3) m/s per second, position fixup


def rvp_differentiate(rvp: RotVelPos) -> RVPInterpolation:
    """Constant signal that reproduces (R, dV) of rvp, with a dP fixup term
    (MotionIntegral.cpp:88-121)."""
    omega = lie.so3_log(rvp.q)
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + 1e-30)
    small = theta < 1e-3
    one = torch.ones_like(theta2)
    theta2s = torch.where(small, one, theta2)
    h = theta * 0.5
    q2 = torch.where(
        small,
        1.0 / 12.0 - theta2 / (4.0 * 180.0) + theta2 * theta2 / (16.0 * 1890.0),
        (1.0 - h * torch.cos(h) / torch.where(small, one, torch.sin(h))) / theta2s,
    )
    omega_vel = lie.cross(omega, rvp.dV)
    upsilon = rvp.dV - 0.5 * omega_vel + q2[..., None] * lie.cross(omega, omega_vel)
    dte = rvp.dt[..., None]
    gyro = omega / dte
    accel = upsilon / dte
    recon = rvp_integrate(gyro, accel, rvp.dt)
    return RVPInterpolation(gyro, accel, (rvp.dP - recon.dP) / dte)


def rvp_integrate_interp(interp: RVPInterpolation, dt) -> RotVelPos:
    rvp = rvp_integrate(interp.gyro, interp.accel, dt)
    return rvp._replace(dP=rvp.dP + interp.delta_vel * dt[..., None])
