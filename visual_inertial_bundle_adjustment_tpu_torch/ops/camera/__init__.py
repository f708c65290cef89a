"""Camera models with a unified padded-parameter interface.

Port of `visual_inertial_bundle_adjustment_tpu/ops/camera/__init__.py`: each
camera's intrinsics live in a fixed MAX_PARAMS=17 vector (model params padded
to 15, readout time at slot 15, time offset at slot 16), with a static `kind`
selecting the projection function per factor batch.
"""

from __future__ import annotations

import torch

from . import fisheye624, pinhole

KIND_LINEAR = 0
KIND_FISHEYE624 = 1

MAX_MODEL_PARAMS = 15
READOUT = 15  # readout time (s), rolling shutter
TIME_OFFSET = 16  # time offset device->camera (s)
MAX_PARAMS = 17

NUM_MODEL_PARAMS = {KIND_LINEAR: pinhole.NUM_PARAMS, KIND_FISHEYE624: fisheye624.NUM_PARAMS}


def project(kind: int, params, point):
    """Dispatch on static kind. params (..., >=15), point (..., 3)."""
    if kind == KIND_LINEAR:
        return pinhole.project(params[..., : pinhole.NUM_PARAMS], point)
    if kind == KIND_FISHEYE624:
        return fisheye624.project(params[..., : fisheye624.NUM_PARAMS], point)
    raise ValueError(f"unknown camera kind {kind}")


def pad_params(model_params, readout=0.0, time_offset=0.0):
    """Pack model params + readout + time offset into a MAX_PARAMS vector."""
    model_params = torch.as_tensor(model_params)
    out = torch.zeros(model_params.shape[:-1] + (MAX_PARAMS,), dtype=model_params.dtype,
                      device=model_params.device)
    out[..., : model_params.shape[-1]] = model_params
    out[..., READOUT] = readout
    out[..., TIME_OFFSET] = time_offset
    return out
