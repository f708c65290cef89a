"""IMU measurement model: calibration state, compensation, noise model.

Port of `visual_inertial_bundle_adjustment_tpu/models/imu.py` (reference
lib/motion/imu_types/* and lib/motion/preintegration/CompensateJac.{h,cpp}).
The calibration lives in a FIXED 23-slot layout; disabled components are
handled by a boolean mask.

Data layout (23 floats per calibration window variable):
    [0:3]   gyroBias (rad/s)
    [3:6]   accelBias (m/s^2)
    [6:9]   gyroScale (stored as scale; tangent steps apply to 1/scale)
    [9:12]  accelScale
    [12:18] gyroNonorth off-diagonals (0,1),(0,2),(1,0),(1,2),(2,0),(2,1)
    [18:21] accelNonorth off-diagonals (0,1),(0,2),(1,2)
    [21]    dtReferenceGyroSec
    [22]    dtReferenceAccelSec

Tangent layout (23, same slots 0..20; time slots differ):
    [21] referenceImuTimeOffset  (adds to BOTH dt's)
    [22] gyroAccelTimeOffset     (adds to dtAccel only)

Every function is written without in-place updates of its inputs so it runs
under `torch.func` transforms.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GYRO_BIAS = slice(0, 3)
ACCEL_BIAS = slice(3, 6)
GYRO_SCALE = slice(6, 9)
ACCEL_SCALE = slice(9, 12)
GYRO_NONORTH = slice(12, 18)
ACCEL_NONORTH = slice(18, 21)
DT_REF_GYRO = 21
DT_REF_ACCEL = 22
REF_TIME_OFFSET = 21  # tangent slot
GYRO_ACCEL_TIME_OFFSET = 22  # tangent slot
CALIB_DIM = 23

_GYRO_NO_IDX = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))
_ACCEL_NO_IDX = ((0, 1), (0, 2), (1, 2))

OPTION_NAMES = (
    "accelBias",
    "gyroBias",
    "accelScale",
    "gyroScale",
    "accelNonorth",
    "gyroNonorth",
    "refImuTimeOffset",
    "gyroAccelTimeOffset",
)


def options_mask(
    accelBias=True,
    gyroBias=True,
    accelScale=False,
    gyroScale=False,
    accelNonorth=False,
    gyroNonorth=False,
    refImuTimeOffset=False,
    gyroAccelTimeOffset=False,
) -> np.ndarray:
    """Boolean [23] tangent mask for an option combination."""
    m = np.zeros(CALIB_DIM, dtype=bool)
    m[GYRO_BIAS] = gyroBias
    m[ACCEL_BIAS] = accelBias
    m[GYRO_SCALE] = gyroScale
    m[ACCEL_SCALE] = accelScale
    m[GYRO_NONORTH] = gyroNonorth
    m[ACCEL_NONORTH] = accelNonorth
    m[REF_TIME_OFFSET] = refImuTimeOffset
    m[GYRO_ACCEL_TIME_OFFSET] = gyroAccelTimeOffset
    return m


def identity_calib(dtype=torch.float64, device=None):
    c = torch.zeros(CALIB_DIM, dtype=dtype, device=device)
    c[GYRO_SCALE] = 1.0
    c[ACCEL_SCALE] = 1.0
    return c


# ---------------------------------------------------------------------------
# Non-orthogonality matrices (diagonals derived from off-diagonals)
# ---------------------------------------------------------------------------


def gyro_nonorth_matrix(calib):
    """(..., 3, 3) gyro nonorth with unit-norm rows (CompensateJac.cpp:46-62)."""
    o = calib[..., GYRO_NONORTH]
    d0 = torch.sqrt(1.0 - o[..., 0] ** 2 - o[..., 1] ** 2)
    d1 = torch.sqrt(1.0 - o[..., 2] ** 2 - o[..., 3] ** 2)
    d2 = torch.sqrt(1.0 - o[..., 4] ** 2 - o[..., 5] ** 2)
    row0 = torch.stack([d0, o[..., 0], o[..., 1]], dim=-1)
    row1 = torch.stack([o[..., 2], d1, o[..., 3]], dim=-1)
    row2 = torch.stack([o[..., 4], o[..., 5], d2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def accel_nonorth_matrix(calib):
    """(..., 3, 3) upper-triangular accel nonorth (CompensateJac.cpp:64-75)."""
    o = calib[..., ACCEL_NONORTH]
    d0 = torch.sqrt(1.0 - o[..., 0] ** 2 - o[..., 1] ** 2)
    d1 = torch.sqrt(1.0 - o[..., 2] ** 2)
    zeros = torch.zeros_like(d0)
    ones = torch.ones_like(d0)
    row0 = torch.stack([d0, o[..., 0], o[..., 1]], dim=-1)
    row1 = torch.stack([zeros, d1, o[..., 2]], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


# ---------------------------------------------------------------------------
# Box ops on the calibration manifold
# ---------------------------------------------------------------------------


def calib_boxplus(calib, step):
    """Apply a (masked) 23-dim tangent step (CompensateJac.cpp:12-85)."""
    return torch.cat(
        [
            calib[..., 0:6] + step[..., 0:6],
            1.0 / (1.0 / calib[..., 6:12] + step[..., 6:12]),
            calib[..., 12:21] + step[..., 12:21],
            (calib[..., DT_REF_GYRO] + step[..., REF_TIME_OFFSET])[..., None],
            (calib[..., DT_REF_ACCEL] + step[..., REF_TIME_OFFSET]
             + step[..., GYRO_ACCEL_TIME_OFFSET])[..., None],
        ],
        dim=-1,
    )


def calib_boxminus(calib, base):
    """23-dim tangent difference (CompensateJac.cpp:88-156)."""
    d = calib - base
    return torch.cat(
        [
            d[..., 0:6],
            1.0 / calib[..., 6:12] - 1.0 / base[..., 6:12],
            d[..., 12:21],
            d[..., DT_REF_GYRO][..., None],
            ((calib[..., DT_REF_ACCEL] - calib[..., DT_REF_GYRO])
             - (base[..., DT_REF_ACCEL] - base[..., DT_REF_GYRO]))[..., None],
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Compensation (raw -> true) and its Jacobians
# ---------------------------------------------------------------------------


def _mv(M, x):
    return (M * x[..., None, :]).sum(-1)


def compensate(calib, gyro_raw, accel_raw):
    """True (gyro, accel) from raw measurements (ImuMeasurementModelParameters.h:87-100)."""
    gyro_inv = torch.linalg.inv(gyro_nonorth_matrix(calib))
    accel_inv = torch.linalg.inv(accel_nonorth_matrix(calib))
    gyro = _mv(gyro_inv, gyro_raw / calib[..., GYRO_SCALE]) - calib[..., GYRO_BIAS]
    accel = _mv(accel_inv, accel_raw / calib[..., ACCEL_SCALE]) - calib[..., ACCEL_BIAS]
    return gyro, accel


def _nonorth_jac_cols(N, Ninv, scaled, idx_rc):
    """Columns d(compensated)/d(offdiag p_i): -Ninv[:,r]*(s[r]*dNrr + s[c])
    (CompensateJac.cpp:196-214)."""
    cols = []
    for r, c in idx_rc:
        dNrr = -N[..., r, c] / N[..., r, r]
        coef = scaled[..., r] * dNrr + scaled[..., c]
        cols.append(-Ninv[..., :, r] * coef[..., None])
    return torch.stack(cols, dim=-1)  # (..., 3, len(idx))


def compensate_with_jac(calib, gyro_raw, accel_raw):
    """Compensated (gyro, accel), calibJac (..., 6, 23), measJac (..., 6, 6).

    Mirrors CompensateJac.cpp:158-249; time-offset columns are zero (they
    enter through integration-boundary sliding in preintegration)."""
    dtype, device = calib.dtype, calib.device
    batch = torch.broadcast_shapes(calib.shape[:-1], gyro_raw.shape[:-1])

    gyroN = gyro_nonorth_matrix(calib)
    accelN = accel_nonorth_matrix(calib)
    gyroNinv = torch.linalg.inv(gyroN)
    accelNinv = torch.linalg.inv(accelN)
    scaled_gyro = _mv(gyroNinv, gyro_raw / calib[..., GYRO_SCALE])
    scaled_accel = _mv(accelNinv, accel_raw / calib[..., ACCEL_SCALE])
    gyro = scaled_gyro - calib[..., GYRO_BIAS]
    accel = scaled_accel - calib[..., ACCEL_BIAS]

    def z(*shape):
        return torch.zeros(batch + shape, dtype=dtype, device=device)

    eye3 = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3))
    g_scale = gyroNinv * gyro_raw[..., None, :]  # tangent on 1/scale
    g_no = _nonorth_jac_cols(gyroN, gyroNinv, scaled_gyro, _GYRO_NO_IDX)
    a_scale = accelNinv * accel_raw[..., None, :]
    a_no = _nonorth_jac_cols(accelN, accelNinv, scaled_accel, _ACCEL_NO_IDX)

    top = torch.cat([-eye3, z(3, 3), g_scale.expand(batch + (3, 3)), z(3, 3),
                     g_no.expand(batch + (3, 6)), z(3, 3), z(3, 1), z(3, 1)], dim=-1)
    bot = torch.cat([z(3, 3), -eye3, z(3, 3), a_scale.expand(batch + (3, 3)), z(3, 6),
                     a_no.expand(batch + (3, 3)), z(3, 1), z(3, 1)], dim=-1)
    calib_jac = torch.cat([top, bot], dim=-2)

    g_meas = (gyroNinv / calib[..., None, GYRO_SCALE]).expand(batch + (3, 3))
    a_meas = (accelNinv / calib[..., None, ACCEL_SCALE]).expand(batch + (3, 3))
    meas_jac = torch.cat([torch.cat([g_meas, z(3, 3)], dim=-1),
                          torch.cat([z(3, 3), a_meas], dim=-1)], dim=-2)
    return gyro, accel, calib_jac, meas_jac


# ---------------------------------------------------------------------------
# Noise model (defaults fit Aria glasses — ImuNoiseModelParameters.h:14-112)
# ---------------------------------------------------------------------------

class ImuNoiseModel(NamedTuple):
    """Per-sample variances of the raw IMU streams (the slice's inertial
    factors need only these two fields of the reference model)."""

    accel_sample_var: torch.Tensor  # (3,) m^2/s^4 per sample
    gyro_sample_var: torch.Tensor  # (3,) rad^2/s^2 per sample


def default_noise_model(dtype=torch.float64, device=None) -> ImuNoiseModel:
    return ImuNoiseModel(
        accel_sample_var=torch.full((3,), 6.6297049e-3, dtype=dtype, device=device),
        gyro_sample_var=torch.full((3,), 2.7415568e-05, dtype=dtype, device=device),
    )
