"""RotVelPos motion-integral algebra (batched).

Port of the parts of `visual_inertial_bundle_adjustment_tpu/ops/motion.py`
that preintegration needs (reference lib/motion/preintegration/
MotionIntegral.{h,cpp}): the RotVelPos{R, dV, dP, dt} group element and the
closed-form integration of a constant (gyro, accel) signal with its
Jacobian (MotionIntegral.cpp:123-226). Rotations are quaternions (wxyz);
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
