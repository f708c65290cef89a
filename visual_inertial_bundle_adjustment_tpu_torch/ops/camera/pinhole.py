"""Linear (pinhole) camera model: params [fx, fy, cx, cy].

Port of `visual_inertial_bundle_adjustment_tpu/ops/camera/pinhole.py`; same
(uv, valid) interface as fisheye624."""

from __future__ import annotations

import torch

NUM_PARAMS = 4
MIN_Z = 1e-6


def project(params, point):
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    z_safe = torch.where(z.abs() < MIN_Z, torch.full_like(z, MIN_Z), z)
    u = params[..., 0] * x / z_safe + params[..., 2]
    v = params[..., 1] * y / z_safe + params[..., 3]
    return torch.stack([u, v], dim=-1), z >= MIN_Z
