"""Fisheye624 (FisheyeRadTanThinPrism) camera model in PyTorch.

Port of `visual_inertial_bundle_adjustment_tpu/ops/camera/fisheye624.py`:

    15 parameters: [f, cx, cy, k0..k5, p0, p1, s0..s3]

    r      = |(x, y)|,  theta = atan2(r, z)
    thetaD = theta * (1 + k0 th^2 + ... + k5 th^12)
    (a, b) = thetaD * (x, y) / r                      (radial fisheye)
    rho2   = a^2 + b^2
    tx     = p0 (rho2 + 2 a^2) + 2 p1 a b             (tangential)
    ty     = p1 (rho2 + 2 b^2) + 2 p0 a b
    tpx    = s0 rho2 + s1 rho2^2                      (thin prism)
    tpy    = s2 rho2 + s3 rho2^2
    uv     = f * (a + tx + tpx, b + ty + tpy) + (cx, cy)

Validity is z >= 1e-6 (reference CameraModelParam.h:52-56). Only projection
is on the bias-only path; unprojection waits for the triangulation slice.
"""

from __future__ import annotations

import torch

NUM_PARAMS = 15
F, CX, CY = 0, 1, 2
K = slice(3, 9)
P = slice(9, 11)
S = slice(11, 15)

MIN_Z = 1e-6


def _theta_d(theta2, ks):
    """theta * polynomial; returns the multiplier m with thetaD = theta * m."""
    m = torch.ones_like(theta2)
    acc = torch.ones_like(theta2)
    for i in range(6):
        acc = acc * theta2
        m = m + ks[..., i] * acc
    return m


def _distort_ab(params, ab):
    """Tangential + thin-prism distortion on the radially-distorted plane."""
    a, b = ab[..., 0], ab[..., 1]
    p0, p1 = params[..., 9], params[..., 10]
    s0, s1, s2, s3 = params[..., 11], params[..., 12], params[..., 13], params[..., 14]
    rho2 = a * a + b * b
    tx = p0 * (rho2 + 2.0 * a * a) + 2.0 * p1 * a * b
    ty = p1 * (rho2 + 2.0 * b * b) + 2.0 * p0 * a * b
    tpx = s0 * rho2 + s1 * rho2 * rho2
    tpy = s2 * rho2 + s3 * rho2 * rho2
    return torch.stack([a + tx + tpx, b + ty + tpy], dim=-1)


def project(params, point):
    """(..., 15), (..., 3) -> (uv (..., 2), valid (...,) bool)."""
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2 + 1e-30)  # derivative-safe on the optical axis
    theta = torch.atan2(r, z)
    m = _theta_d(theta * theta, params[..., K])
    # radial direction; near the axis fall back to the pinhole limit a=x/z
    near_axis = r < 1e-12
    r_safe = torch.where(near_axis, torch.ones_like(r), r)
    z_safe = torch.where(z.abs() < MIN_Z, torch.full_like(z, MIN_Z), z)
    scale = torch.where(near_axis, 1.0 / z_safe, theta * m / r_safe)
    ab = torch.stack([x * scale, y * scale], dim=-1)
    uv_plane = _distort_ab(params, ab)
    f = params[..., F]
    uv = uv_plane * f[..., None] + torch.stack([params[..., CX], params[..., CY]], dim=-1)
    return uv, z >= MIN_Z
