"""Calibration evaluation vs factory values.

Port of `visual_inertial_bundle_adjustment_tpu/pipeline/eval_calibration.py`
(reference viba/single_session/EvalCalibration.cpp:15-154): per-window
extrinsics rotation/translation errors, per-component intrinsics deltas, and
a dense grid of projection offsets at several distances, reported as
percentile summaries. The calibration tables are copied to the host once and
evaluated there in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import imu as imu_model
from ..ops import camera as cam_ops
from ..utils.histogram import StatsValueContainer
from . import session_data as sio

EVAL_DISTANCES = [0.3, 0.5, 1.0, 2.0, 5.0, 10.0]  # meters (reference uses 6)
GRID = 12  # projection-offset grid resolution per axis


def compare_calibration_vs_factory(adapter, log=print):
    """Print percentile stats of optimized-vs-factory calibration deltas."""
    sd = adapter.sd
    v = adapter.problem.variables
    host = {k: getattr(v, k).double().cpu().numpy()
            for k in ("cam_extr_q", "cam_extr_t", "cam_intr", "imu_calib")}
    nC, nI, W = adapter.num_cams, adapter.num_imus, adapter.num_windows
    stats = {}

    def get(name, unit=""):
        if name not in stats:
            stats[name] = StatsValueContainer(name, unit)
        return stats[name]

    def t64(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    # camera extrinsics errors
    for ci in range(nC):
        fq, ft = adapter._T_cam_bodyImu(sd.factory, adapter.cam_to_factory[ci])
        for w in range(W):
            row = w * nC + ci
            dq = sio._q_mul(host["cam_extr_q"][row], sio._q_conj(fq))
            ang = 2 * np.arccos(np.clip(abs(dq[0]), -1, 1))
            get(f"cam{ci}/extr_rot", " deg").add([np.rad2deg(ang)])
            get(f"cam{ci}/extr_pos", " mm").add(
                [np.linalg.norm(host["cam_extr_t"][row] - ft) * 1e3])

    # camera intrinsics deltas + projection-offset grid
    for ci in range(nC):
        ref = adapter._cam_param_vec(sd.factory, adapter.cam_to_factory[ci])
        kind = adapter.camera_kind(ci)
        n = cam_ops.NUM_MODEL_PARAMS[kind]
        Wd, Hd = sd.online[0].cameras[ci].image_size
        # projection offsets over a pixel grid unprojected at distances
        uu, vv = np.meshgrid(np.linspace(10, Wd - 10, GRID), np.linspace(10, Hd - 10, GRID))
        uv = t64(np.stack([uu.reshape(-1), vv.reshape(-1)], -1))
        rays = cam_ops.unproject(kind, t64(ref[:n]), uv)
        for w in range(W):
            est = host["cam_intr"][w * nC + ci]
            get(f"cam{ci}/intr_delta", "").add(np.abs(est[:n] - ref[:n]))
            for dist in EVAL_DISTANCES:
                uv_est, ok = cam_ops.project(kind, t64(est[:n]), rays * dist)
                off = np.linalg.norm((uv_est - uv).numpy(), axis=-1)
                get(f"cam{ci}/proj_offset@{dist}m", " px").add(off[ok.numpy()])

    # imu calibration deltas
    for ii in range(nI):
        ref = t64(sd.factory.imus[adapter.imu_to_factory[ii]].calib23)
        for w in range(W):
            d = imu_model.calib_boxminus(t64(host["imu_calib"][w * nI + ii]), ref).numpy()
            get(f"imu{ii}/gyro_bias", " rad/s").add(np.abs(d[imu_model.GYRO_BIAS]))
            get(f"imu{ii}/accel_bias", " m/s2").add(np.abs(d[imu_model.ACCEL_BIAS]))
            get(f"imu{ii}/scale", "").add(
                np.abs(np.concatenate([d[imu_model.GYRO_SCALE], d[imu_model.ACCEL_SCALE]])))
            get(f"imu{ii}/time_offsets", " s").add(np.abs(d[21:23]))

    for s in stats.values():
        log(s.summary())
    return stats
